"""The port's streamed engine (``engine.run_stream``, ``sweep.run_stream_*``)
on the contracts of ``tests/test_streaming.py``,
``tests/test_engine_invariants.py``'s streaming invariants and
``tests/test_leap_parity.py``'s streamed lane, on the CPU.

Bitwise within the port: stream == resident at W = N on the 2x2 grid,
chunk sizes 1, 4 and 64, leap on == off, lane of a batch == its single
run, and padded lanes inert.  Against the JAX engine: the window and
admission rules (dead-VM arrivals, a slot taken twice in one instant)
exactly.  Against the f64 oracle: a lane of 2,000 arrivals through a
64-slot window.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import state as JS
from repro.oracle.reference import simulate_stream
from repro_torch.core import engine as E
from repro_torch.core import state as S
from repro_torch.core import sweep, workloads
from repro_torch.core.state import map_tensors, tensor_leaves
from repro_torch.core.telemetry import stream_timeline, summarize_stream_trace

CPU = "cpu"


def _same(a, b, ctx):
    if isinstance(a, tuple) and not dataclasses.is_dataclass(a):
        for x, y in zip(a, b):
            _same(x, y, ctx)
        return
    la, lb = tensor_leaves(a), tensor_leaves(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert torch.equal(x, y), ctx


def _infra(n_slots, *, n_hosts=3, n_vms=6, vp=S.SPACE_SHARED,
           tp=S.SPACE_SHARED, cloudlets=None):
    hosts = S.make_uniform_hosts(n_hosts, pes=4, mips=1000.0, ram=8192.0,
                                 bw=1000.0, storage=1e6, idle_w=100.0,
                                 peak_w=250.0, device=CPU)
    vms = S.make_vms([1] * n_vms, [500.0] * n_vms, [512.0] * n_vms,
                     [100.0] * n_vms, [1000.0] * n_vms, device=CPU)
    return S.make_datacenter(
        hosts, vms, cloudlets if cloudlets is not None
        else S.make_window(n_slots, device=CPU),
        vm_policy=vp, task_policy=tp, device=CPU)


def _trace(seed, n=60, n_vms=6, horizon=20.0):
    rng = np.random.default_rng(seed)
    vm = rng.integers(0, n_vms, n).astype(np.int32)
    lens = rng.uniform(100.0, 2000.0, n).astype(np.float32)
    sub = np.sort(rng.uniform(0.0, horizon, n)).astype(np.float32)
    return vm, lens, sub


def _random_stream(seed, n=60, n_vms=6, chunk=16, horizon=20.0):
    vm, lens, sub = _trace(seed, n, n_vms, horizon)
    return S.make_stream(vm, lens, sub, chunk=chunk, device=CPU)


# ---------------------------------------------------------------------------
# The window contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_slots", [4, 10, 32])
def test_window_bounds_occupancy_and_recycles(n_slots):
    stream = _random_stream(0, n=60)
    out, st, recs = E.run_stream(_infra(n_slots), stream)
    n = int((stream.vm >= 0).sum())
    assert int(st.stats.n_retired) + int(st.stats.n_failed) == n
    assert int(st.peak_occupancy) <= n_slots
    tl = stream_timeline(recs)
    assert np.all(tl["occupancy"] <= n_slots)
    assert np.all(np.diff(tl["n_retired"]) >= 0)
    assert not bool((out.cloudlets.state == S.CL_CREATED).any())
    expect = float(stream.length.double()[stream.vm >= 0].sum())
    np.testing.assert_allclose(float(st.stats.sum_len), expect, rtol=1e-5)


def test_tight_window_queues_instead_of_dropping():
    stream = _random_stream(3, n=25)
    _, st, _ = E.run_stream(_infra(1), stream)
    assert int(st.stats.n_retired) == 25
    assert int(st.peak_occupancy) == 1
    assert int(st.max_backlog) > 0
    vm = stream.vm.reshape(-1)
    np.testing.assert_array_equal(
        st.stats.per_vm_done.numpy(),
        np.bincount(vm[vm >= 0].numpy(), minlength=6))


def test_admission_is_deterministic_and_reservoir_is_trace_pure():
    stream = _random_stream(7, n=90)
    a = E.run_stream(_infra(8), stream, reservoir=16)
    b = E.run_stream(_infra(8), stream, reservoir=16)
    _same(a, b, "identical streamed runs")
    stats = a[1].stats
    stride = int(stats.stride)
    sid = stats.res_sid.numpy()
    filled = sid >= 0
    np.testing.assert_array_equal(sid[filled] % stride, 0)
    np.testing.assert_array_equal(sid[filled] // stride,
                                  np.nonzero(filled)[0])


def _dead_vm_case(vm, sub, n_slots=6, destroy_t=1.0, chunk=4):
    """A window under a VM 0 destroyed at ``destroy_t``; the port and
    JAX on the same scenario (reservoir stride 1: every arrival
    sampled)."""
    ev = JS.make_events([destroy_t], [JS.EV_VM_DESTROY], [0])
    hosts = JS.make_uniform_hosts(3, pes=4, mips=1000.0, ram=8192.0,
                                  bw=1000.0, storage=1e6, idle_w=100.0,
                                  peak_w=250.0)
    vms = JS.make_vms([1] * 4, [500.0] * 4, [512.0] * 4, [100.0] * 4,
                      [1000.0] * 4)
    jdc = JS.make_datacenter(hosts, vms, JS.make_window(n_slots), events=ev)
    n = len(vm)
    jstream = JS.make_stream(np.asarray(vm, np.int32),
                             np.full(n, 200.0, np.float32),
                             np.asarray(sub, np.float32), chunk=chunk)
    from repro_torch.core.convert import from_arrays
    port = E.run_stream(from_arrays(jdc, device=CPU),
                        from_arrays(jstream, device=CPU,
                                    cls=S.ArrivalStream), reservoir=n)
    want = JE.run_stream(jdc, jstream, reservoir=n)
    for name in ("state", "vm", "rank_in_vm", "submit_time"):
        np.testing.assert_array_equal(
            getattr(port[0].cloudlets, name).numpy(),
            np.asarray(getattr(want[0].cloudlets, name)), err_msg=name)
    for name in ("n_retired", "n_failed", "per_vm_done", "res_sid"):
        np.testing.assert_array_equal(
            getattr(port[1].stats, name).numpy(),
            np.asarray(getattr(want[1].stats, name)), err_msg=name)
    np.testing.assert_array_equal(port[1].slot_sid.numpy(),
                                  np.asarray(want[1].slot_sid))
    np.testing.assert_array_equal(port[1].vm_rank.numpy(),
                                  np.asarray(want[1].vm_rank))
    for f in port[2]._fields[1:]:
        np.testing.assert_array_equal(getattr(port[2], f).numpy(),
                                      np.asarray(getattr(want[2], f)),
                                      err_msg=f)
    np.testing.assert_allclose(port[1].stats.res_finish.numpy(),
                               np.asarray(want[1].stats.res_finish),
                               rtol=0, atol=1e-3)
    return port


def test_dead_vm_arrivals_fail_immediately():
    """200 MI at 500 granted MIPS is 0.4 s: the t=0.5 arrival on VM 0
    finishes before the t=1.0 destroy; the t=3.0 and t=5.0 arrivals
    name the destroyed VM and fail on entry."""
    _, st, _ = _dead_vm_case([0, 1, 0, 2, 0, 3],
                             [0.5, 2.0, 3.0, 4.0, 5.0, 6.0])
    assert int(st.stats.n_failed) == 2
    assert int(st.stats.n_retired) == 4


def test_dead_arrivals_in_a_row_share_a_slot():
    """Two dead arrivals and a live one in the same instant: each dead
    one takes the lowest free slot and the next arrival retires it, so
    the live one ends in that slot and the dead ones are counted (and
    sampled with the INF finish)."""
    out, st, _ = _dead_vm_case(
        [1, 1, 0, 0, 2, 0, 0, 3], [0.1, 0.1, 2.0, 2.0, 2.0, 2.5, 2.5, 2.5],
        n_slots=3, chunk=2)
    assert int(st.stats.n_failed) == 4
    fin = st.stats.res_finish.numpy()
    assert (fin[st.stats.res_sid.numpy() == 2] >= 1e29).all()


# ---------------------------------------------------------------------------
# Stream == resident, chunk sizes, leap, work conservation
# ---------------------------------------------------------------------------
def _band_workload(seed, n_vms=6, per_vm=3):
    """Per-VM submit bands: sorted by submit time == grouped by VM, and
    no completion before the last arrival, so slot k holds resident
    cloudlet k."""
    rng = np.random.default_rng(seed)
    vm = np.repeat(np.arange(n_vms, dtype=np.int32), per_vm)
    sub = (vm * 0.1 + np.tile(np.sort(rng.uniform(0.0, 0.09, per_vm)),
                              n_vms)).astype(np.float32)
    lens = rng.uniform(500.0, 3000.0, n_vms * per_vm).astype(np.float32)
    return vm, lens, sub


@pytest.mark.parametrize("vp,tp", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_stream_matches_resident_bitwise_one_window(vp, tp):
    vm, lens, sub = _band_workload(11)
    resident = _infra(0, vp=vp, tp=tp,
                      cloudlets=S.make_cloudlets(vm, lens, sub, device=CPU))
    ref = E.run(resident, max_steps=4096)
    out, st, _ = E.run_stream(_infra(vm.shape[0], vp=vp, tp=tp),
                              S.make_stream(vm, lens, sub, chunk=8,
                                            device=CPU))
    for name in ("finish_time", "start_time", "state", "remaining",
                 "rank_in_vm", "vm"):
        assert torch.equal(getattr(out.cloudlets, name),
                           getattr(ref.cloudlets, name)), (name, vp, tp)
    assert torch.equal(out.time, ref.time)
    assert torch.equal(out.hosts.energy_j, ref.hosts.energy_j)
    assert int(st.stats.n_retired) == int(
        (ref.cloudlets.state == S.CL_DONE).sum())


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("tp", [S.SPACE_SHARED, S.TIME_SHARED])
def test_aggregates_invariant_to_chunk_size(seed, tp):
    vm, lens, sub = _trace(seed, n=70, horizon=25.0)
    outs = [E.run_stream(_infra(8, tp=tp), S.make_stream(
        vm, lens, sub, chunk=chunk, device=CPU)) for chunk in (1, 4, 64)]
    for (out, st, _), chunk in zip(outs[1:], (4, 64)):
        _same(outs[0][1].stats, st.stats, f"chunk {chunk} seed {seed}")
        _same(outs[0][0], out, f"chunk {chunk} state")
        for name in ("peak_occupancy", "vm_rank", "slot_sid", "next_sid"):
            assert torch.equal(getattr(outs[0][1], name),
                               getattr(st, name)), name


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_work_conservation_across_windows(seed):
    vm, lens, sub = _trace(seed, n=70, horizon=25.0)
    _, st, recs = E.run_stream(_infra(8), S.make_stream(vm, lens, sub,
                                                        chunk=8, device=CPU))
    assert int(st.stats.n_retired) == vm.shape[0]
    assert int(st.stats.n_failed) == 0
    np.testing.assert_allclose(float(st.stats.sum_len),
                               float(lens.astype(np.float64).sum()),
                               rtol=1e-5)
    np.testing.assert_array_equal(st.stats.per_vm_done.numpy(),
                                  np.bincount(vm, minlength=6))
    assert float(st.stats.sum_response) >= float(st.stats.sum_exec) - 1e-3
    for name in ("n_retired", "n_failed", "time"):
        assert np.all(np.diff(getattr(recs, name).numpy()) >= 0), name
    assert int(st.stats.n_retired) >= int(recs.n_retired[-1])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("tp", [S.SPACE_SHARED, S.TIME_SHARED])
def test_leap_parity_bitwise(seed, tp):
    stream = _random_stream(seed, n=70, chunk=16)
    off = E.run_stream(_infra(6, tp=tp), stream, leap=False)
    on = E.run_stream(_infra(6, tp=tp), stream, leap=True)
    _same(off, on, f"seed {seed} tp {tp}")


def test_mmpp_lane_leap_parity_bitwise():
    """A bursty MMPP trace against a 6-slot window: completions wake
    admissions, so the leap must not cross a backlog; state, stats,
    reservoir and chunk records bit for bit."""
    stream = workloads.mmpp_stream(5, 6, rate_low=0.5, rate_high=15.0,
                                   mean_dwell_low=5.0, mean_dwell_high=2.0,
                                   horizon=25.0, chunk=16, device=CPU)
    dc = _infra(6, tp=S.TIME_SHARED)
    off = E.run_stream_stats(dc, stream, leap=False)
    on = E.run_stream_stats(dc, stream, leap=True)
    _same(off[:3], on[:3], "streamed leap parity")
    assert int(on[1].stats.n_retired) > 0
    assert on[3].n_leap > 0 and on[3].n_full < off[3].n_full


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------
def test_stream_batch_matches_single_runs_bitwise():
    """Ragged chunk counts, padded by ``stack_streams``; the padded
    chunks' records repeat the last real chunk's."""
    dcs = [_infra(8), _infra(8, tp=S.TIME_SHARED), _infra(8)]
    streams = [_random_stream(s, n=30 + 10 * s, chunk=16) for s in range(3)]
    fdc, fst, frec = sweep.run_stream_batch(sweep.stack_scenarios(dcs),
                                            streams)
    for b in range(3):
        out, st, rec = E.run_stream(dcs[b], streams[b])
        lane = lambda t: map_tensors(lambda x: x[b], t)
        _same(out, lane(fdc), f"lane {b} state")
        _same(st.stats, lane(fst.stats), f"lane {b} stats")
        k = rec.time.shape[0]
        for name, x, y in zip(rec._fields, rec, frec):
            assert torch.equal(x, y[b, :k]), (b, name)
            assert torch.equal(y[b, k:], y[b, k - 1:k].expand(
                y.shape[1] - k) * (name != "n_events")), (b, name)


def test_padded_lane_is_inert():
    """A batch grown with an inert scenario and an empty queue gives the
    same lanes as before, and the inert lane commits nothing."""
    dcs = [_infra(8), _infra(8, tp=S.TIME_SHARED)]
    streams = [_random_stream(s, n=30, chunk=16) for s in range(2)]
    batch = sweep.stack_scenarios(dcs)
    table = sweep.stack_streams(streams)
    a = sweep.run_stream_batch(batch, table)
    grown = sweep.pad_batch(batch, 3)
    pad = sweep.inert_stream_lane(table)
    table3 = dataclasses.replace(table, **{
        f.name: torch.cat([getattr(table, f.name),
                           getattr(pad, f.name)[None]])
        for f in dataclasses.fields(table)})
    b = sweep.run_stream_batch(grown, table3)
    two = lambda t: map_tensors(lambda x: x[:2], t)
    _same(a[0], two(b[0]), "state")
    _same(a[1].stats, two(b[1].stats), "stats")
    inert = map_tensors(lambda x: x[2], b[0])
    assert float(inert.time) == 0.0
    assert int(b[1].stats.n_retired[2]) == int(b[1].stats.n_failed[2]) == 0
    assert int(b[2].n_events[2].sum()) == 0


def test_stream_grid_shapes_and_row_equivalence():
    dcs = [_infra(8), _infra(8)]
    streams = [_random_stream(s, n=40, chunk=16) for s in (5, 6)]
    batch = sweep.stack_scenarios(dcs)
    vp, tp = sweep.policy_grid(device=CPU)
    gdc, gst, grec = sweep.run_stream_grid(batch, streams, vp, tp)
    summ = sweep.summarize_stream(gdc, gst)
    assert summ.makespan.shape == (4, 2)
    assert grec.time.shape == (4, 2, 3)
    fdc, fst, frec = sweep.run_stream_batch(batch, streams)
    row = lambda t: map_tensors(lambda x: x[0], t)
    _same(row(gst), fst, "policy row 0")
    _same(row(gdc), fdc, "policy row 0 state")
    _same(tuple(r[0] for r in grec), frec, "policy row 0 records")
    # the time-shared rows differ from the space-shared ones
    assert not torch.equal(gst.stats.sum_exec[0], gst.stats.sum_exec[1])


def test_arrival_generators_feed_streams():
    for stream in (
            workloads.diurnal_stream(0, 6, base_rate=0.5, peak_rate=8.0,
                                     period=30.0, horizon=30.0, chunk=32,
                                     device=CPU),
            workloads.mmpp_stream(1, 6, rate_low=0.5, rate_high=12.0,
                                  mean_dwell_low=6.0, mean_dwell_high=2.0,
                                  horizon=30.0, chunk=32, device=CPU)):
        sub = stream.submit.reshape(-1)
        real = stream.vm.reshape(-1) >= 0
        assert bool((torch.diff(sub[real]) >= 0.0).all())
        _, st, recs = E.run_stream(_infra(10), stream)
        n = int(real.sum())
        assert int(st.stats.n_retired) == n > 0
        assert summarize_stream_trace(recs)["retired"] <= n


def test_streamed_elastic_and_probed_lanes_run():
    """The lanes the static slices refused (the inert autoscaler, then
    the inert plane, switched on) run through ``run_stream`` and match
    JAX's ``run_stream`` on the same scenario."""
    import jax.numpy as jnp
    dc = _infra(4)
    stream = _random_stream(0, n=5)
    hosts = JS.make_uniform_hosts(3, pes=4, mips=1000.0, ram=8192.0,
                                  bw=1000.0, storage=1e6, idle_w=100.0,
                                  peak_w=250.0)
    vms = JS.make_vms([1] * 6, [500.0] * 6, [512.0] * 6, [100.0] * 6,
                      [1000.0] * 6)
    jdc = JS.make_datacenter(hosts, vms, JS.make_window(4))
    vm, lens, sub = _trace(0, n=5)
    jstream = JS.make_stream(vm, lens, sub, chunk=16)
    for blk in ("scaler", "metrics"):
        on = dataclasses.replace(dc, **{blk: dataclasses.replace(
            getattr(dc, blk), enabled=torch.ones((), dtype=torch.int32))})
        jon = dataclasses.replace(jdc, **{blk: dataclasses.replace(
            getattr(jdc, blk), enabled=jnp.int32(1))})
        out, st, recs = E.run_stream(on, stream)
        jout, jst, jrecs = JE.run_stream(jon, jstream)
        for name in ("n_retired", "n_failed", "per_vm_done"):
            np.testing.assert_array_equal(
                getattr(st.stats, name).numpy(),
                np.asarray(getattr(jst.stats, name)), err_msg=name)
        np.testing.assert_allclose(float(st.stats.makespan),
                                   float(jst.stats.makespan), atol=1e-3)
        for name in ("enabled", "up_count", "down_count", "spot_cost"):
            assert float(getattr(out.scaler, name)) == float(
                getattr(jout.scaler, name)), name
        for name in ("hist_response", "hist_exec", "hist_wait",
                     "sla_breaches", "peak_backlog"):
            np.testing.assert_array_equal(
                getattr(out.metrics, name).numpy(),
                np.asarray(getattr(jout.metrics, name)), err_msg=name)
        np.testing.assert_allclose(out.metrics.bucket_dt.numpy(),
                                   np.asarray(jout.metrics.bucket_dt),
                                   atol=1e-3)
        assert int(st.stats.n_retired) == 5
    assert int(out.metrics.hist_response.sum()) == 5


# ---------------------------------------------------------------------------
# A long lane against the oracle
# ---------------------------------------------------------------------------
def test_2000_arrival_lane_matches_oracle():
    """``bench_streaming``'s recipe (8 hosts of 4 PEs, 32 VMs, n/40 s of
    uniform arrivals) at n = 2,000 through W = 64: exact retirement
    accounting and reservoir ids, aggregates and sampled times within
    1e-3 of the f64 oracle.  (The JAX package's 100,000-arrival lane is
    too long for the port's eager CPU step in tier 1.)"""
    n, n_vms = 2000, 32
    rng = np.random.default_rng(0)
    vm = rng.integers(0, n_vms, n).astype(np.int32)
    sub = np.sort(rng.uniform(0, n / 40.0, n)).astype(np.float32)
    length = rng.uniform(100.0, 2000.0, n).astype(np.float32)
    stream = S.make_stream(vm, length, sub, chunk=512, device=CPU)
    dc = _infra(64, n_hosts=8, n_vms=n_vms)
    out, st, _ = E.run_stream(dc, stream, reservoir=64,
                              max_steps_per_chunk=16384)
    res = simulate_stream(dc, stream, reservoir=64)
    assert int(st.stats.n_retired) == res.n_retired == n
    assert int(st.stats.n_failed) == res.n_failed == 0
    np.testing.assert_array_equal(st.stats.per_vm_done.numpy(),
                                  res.per_vm_done)
    for name in ("makespan", "sum_exec", "sum_response"):
        np.testing.assert_allclose(float(getattr(st.stats, name)),
                                   getattr(res, name), rtol=1e-3, atol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(st.stats.res_sid.numpy(), res.res_sid)
    assert int((st.stats.res_sid >= 0).sum()) == -(-n // 32)   # stride 32
    for name in ("res_start", "res_finish"):
        np.testing.assert_allclose(
            getattr(st.stats, name).numpy().astype(np.float64),
            getattr(res, name), rtol=1e-3, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(out.hosts.energy_j.numpy().astype(np.float64),
                               res.energy_j, rtol=1e-3, atol=1e-3)
