"""The streamed slice's building blocks in the port, against the JAX
package: the stream builders and generators (leaf by leaf, exact), the
padded row index (the same rates and ``dt_min`` as the unpadded one),
and level 2 on a window of recycled slots read through its regrouped
view (exactly the rates of JAX's ``vm_level_rates(streaming=True)``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduling as JSch
from repro.core import state as JS
from repro.core import telemetry as JT
from repro.core import workloads as JW
from repro_torch.core import scheduling as PSch
from repro_torch.core import state as S
from repro_torch.core import telemetry as PT
from repro_torch.core import workloads as PW
from repro_torch.core.convert import from_arrays, to_numpy
from repro_torch.kernels.simstep import ops

CPU = "cpu"


def _leaves_equal(port, jax_tree, ctx):
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        want = getattr(jax_tree, f.name)
        if dataclasses.is_dataclass(got):
            _leaves_equal(got, want, f"{ctx}.{f.name}")
            continue
        a = got.numpy()
        b = np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}.{f.name}")


@pytest.mark.parametrize("n,chunk", [(0, 4), (1, 4), (37, 8), (64, 16),
                                     (50, 64)])
def test_builders_equal_jax_leaf_by_leaf(n, chunk):
    rng = np.random.default_rng(n)
    vm = rng.integers(0, 5, n).astype(np.int32)
    lens = rng.uniform(100.0, 900.0, n).astype(np.float32)
    # ties in submit time keep their index order (a stable sort)
    sub = np.round(rng.uniform(0.0, 5.0, n), 1).astype(np.float32)
    fs = rng.uniform(0.0, 9.0, n).astype(np.float32)
    stream = S.make_stream(vm, lens, sub, file_size=fs, output_size=2.5,
                           chunk=chunk, device=CPU)
    jstream = JS.make_stream(vm, lens, sub, file_size=fs, output_size=2.5,
                             chunk=chunk)
    _leaves_equal(stream, jstream, "stream")
    _leaves_equal(S.make_window(7, device=CPU), JS.make_window(7), "window")
    for reservoir in (1, 16):
        _leaves_equal(S.make_stream_state(stream, 5, 7, reservoir=reservoir),
                      JS.make_stream_state(jstream, 5, 7,
                                           reservoir=reservoir), "state")
    # and the converter carries JAX's into the port
    _leaves_equal(from_arrays(jstream, device=CPU, cls=S.ArrivalStream),
                  jstream, "converted stream")
    st = from_arrays(JS.make_stream_state(jstream, 5, 7), device=CPU,
                     cls=S.StreamState)
    _leaves_equal(st, JS.make_stream_state(jstream, 5, 7), "converted state")


def test_generators_equal_jax_exactly():
    for seed in (0, 1, 7):
        kw = dict(base_rate=0.5, peak_rate=8.0, period=30.0, horizon=60.0,
                  chunk=32)
        _leaves_equal(PW.diurnal_stream(seed, 6, device=CPU, **kw),
                      JW.diurnal_stream(seed, 6, **kw), f"diurnal {seed}")
        kw = dict(rate_low=0.5, rate_high=12.0, mean_dwell_low=6.0,
                  mean_dwell_high=2.0, horizon=40.0, chunk=16,
                  file_size=3.0)
        _leaves_equal(PW.mmpp_stream(seed, 6, device=CPU, **kw),
                      JW.mmpp_stream(seed, 6, **kw), f"mmpp {seed}")
    t = np.linspace(0.0, 90.0, 31)
    np.testing.assert_array_equal(
        PW.diurnal_rate(t, base=1.0, peak=5.0, period=30.0, phase=2.0),
        JW.diurnal_rate(t, base=1.0, peak=5.0, period=30.0, phase=2.0))


# ---------------------------------------------------------------------------
# The padded row index and the regrouped level 2
# ---------------------------------------------------------------------------
def _grouped(seed, n_rows, c):
    """A grouped, ascending slot axis with slots of no row last, and the
    level-2 inputs for it."""
    rng = np.random.default_rng(seed)
    lengths = rng.choice([0, 1, 3, 31, 32, 33, 40, 1100], n_rows,
                         p=[.2, .2, .2, .1, .1, .1, .07, .03])
    rows = np.repeat(np.arange(n_rows), lengths)
    rows = np.concatenate([rows, np.full(c, -1)]).astype(np.int32)
    n = rows.shape[0]
    rem = rng.uniform(0.0, 5000.0, n).astype(np.float32)
    rem[rng.uniform(size=n) < 0.15] = 0.0
    run = rng.uniform(size=n) < 0.7
    cap = rng.uniform(100.0, 2000.0, n_rows).astype(np.float32)
    pes = rng.integers(1, 4, n_rows).astype(np.float32)
    pol = rng.integers(0, 2, n_rows).astype(np.int32)
    t = lambda a: torch.from_numpy(a)
    return t(rows), t(rem), t(run), t(cap), t(pes), t(pol)


@pytest.mark.parametrize("seed,n_rows,tail", [(0, 9, 0), (1, 40, 5),
                                              (2, 1, 70), (3, 25, 1),
                                              (4, 3, 0)])
def test_padded_index_matches_unpadded(seed, n_rows, tail):
    """Same rows, same real spans, chunks and empty rows as
    ``row_index``, padded to sizes fixed by C; the plain kernel gives
    the same rates and ``dt_min`` on both."""
    rows, rem, run, cap, pes, pol = _grouped(seed, n_rows, tail)
    c = rows.shape[0]
    exact = ops.row_index(rows, n_rows)
    padded = ops.padded_row_index(rows, n_rows)
    for name in ("slot_row", "start", "length"):
        assert torch.equal(getattr(exact, name), getattr(padded, name))
    n_win = exact.window.shape[0]
    assert padded.window.shape[0] == ops.max_spans(c) + 1 >= n_win
    assert torch.equal(padded.window[:n_win], exact.window)
    assert bool((padded.window[n_win:] == c).all())
    assert torch.equal(padded.empty[padded.empty >= 0], exact.empty)
    n_ch = exact.chunk_row.shape[0]
    assert padded.chunk_row.shape[0] == c // (ops.WINDOW + 1) >= n_ch
    assert torch.equal(padded.chunk_row[:n_ch], exact.chunk_row)
    assert torch.equal(padded.chunk_first[:n_ch], exact.chunk_first)
    assert bool((padded.chunk_row[n_ch:] == -1).all())
    for policy in (0, 1, pol):
        a = ops.simstep_ragged(rem, run, exact, cap, pes, policy)
        b = ops.simstep_ragged(rem, run, padded, cap, pes, policy)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_max_spans_bounds_the_greedy_windows():
    for c in (0, 1, 2, 32, 33, 34, 65, 66, 67, 1000):
        for seed in range(5):
            rng = np.random.default_rng(seed)
            rows = np.sort(rng.integers(-1, max(c // 3, 1), c))
            rows = np.concatenate([rows[rows >= 0], rows[rows < 0]])
            marks = ops._window_marks(torch.from_numpy(rows.astype(np.int32)))
            assert int(marks.sum()) - 1 <= ops.max_spans(c), (c, seed)


def _recycled(seed, n_vms, w, tp):
    """A JAX window whose slots were recycled across VMs: VMs scattered
    through it, each VM's ranks increasing but not in slot order."""
    rng = np.random.default_rng(seed)
    hosts = JS.make_uniform_hosts(3, pes=4)
    vms = JS.make_vms(rng.integers(1, 4, n_vms), 500.0, 512.0, 10.0, 100.0)
    vm = rng.integers(-1, n_vms, w).astype(np.int32)
    rank = np.zeros(w, np.int32)
    for v in range(n_vms):
        idx = np.nonzero(vm == v)[0]
        rank[idx] = np.sort(rng.choice(4 * len(idx) + 1, len(idx),
                                       replace=False))[rng.permutation(
                                           len(idx))]
    rem = rng.uniform(0.0, 100.0, w).astype(np.float32)
    rem[rng.uniform(size=w) < 0.2] = 0.0
    win = dataclasses.replace(
        JS.make_window(w), vm=jnp.asarray(vm), rank_in_vm=jnp.asarray(rank),
        remaining=jnp.asarray(rem),
        state=jnp.asarray(np.where(vm >= 0, JS.CL_CREATED,
                                   JS.CL_EMPTY).astype(np.int32)))
    dc = JS.make_datacenter(hosts, vms, win, task_policy=tp)
    cap = rng.uniform(100.0, 2000.0, n_vms).astype(np.float32)
    runnable = (rng.uniform(size=w) < 0.7) & (vm >= 0) & (rem > 0)
    return dc, cap, runnable


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tp", [JS.SPACE_SHARED, JS.TIME_SHARED])
def test_regrouped_level2_equals_jax_pairwise_rank(seed, tp):
    """On a recycled window the kernel's running count along the
    regrouped rows is JAX's pairwise rank by ``rank_in_vm``: the rates
    are equal bit for bit."""
    rng = np.random.default_rng(100 + seed)
    dc, cap, runnable = _recycled(seed, int(rng.integers(1, 9)),
                                  int(rng.integers(1, 150)), tp)
    want = np.asarray(JSch.vm_level_rates(
        dc, jnp.asarray(cap), jnp.asarray(runnable), streaming=True))
    got = PSch.vm_level_rates(from_arrays(dc, device=CPU),
                              torch.from_numpy(cap),
                              torch.from_numpy(runnable), streaming=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # the regrouped view is a permutation that groups each VM's slots in
    # rank order, slots of no VM last
    batch = PSch.lane_axis(from_arrays(dc, device=CPU))
    lanes = PSch.lanes_of(batch, streaming=True)
    vm = batch.cloudlets.vm[0][lanes.perm].numpy().astype(np.int64)
    rank = batch.cloudlets.rank_in_vm[0][lanes.perm].numpy()
    key = np.where(vm >= 0, vm, 1 << 20) * (1 << 30) \
        + np.where(vm >= 0, rank, 0)
    assert np.all(np.diff(key) >= 0)
    assert sorted(lanes.perm.tolist()) == list(range(vm.shape[0]))


@pytest.mark.parametrize("seed", range(3))
def test_regrouped_cloudlet_rates_equal_jax(seed):
    """The whole two-level pass on a recycled window
    (``cloudlet_rates(..., streaming=True)``) against JAX's."""
    dc, _, _ = _recycled(seed, 5, 60, seed % 2)
    dc = dataclasses.replace(dc, vms=dataclasses.replace(
        dc.vms, state=jnp.full_like(dc.vms.state, JS.VM_ACTIVE),
        host=jnp.asarray(np.arange(5) % 3, jnp.int32),
        create_time=jnp.zeros_like(dc.vms.create_time)))
    want = np.asarray(JSch.cloudlet_rates(dc, streaming=True))
    got = PSch.cloudlet_rates(from_arrays(dc, device=CPU), streaming=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stream_telemetry_equals_jax():
    rng = np.random.default_rng(0)
    k = 5
    rec = dict(time=np.cumsum(rng.uniform(0, 3, k)).astype(np.float32),
               **{f: rng.integers(0, 50, k).astype(np.int32) for f in (
                   "occupancy", "peak_occupancy", "max_backlog",
                   "n_retired", "n_failed", "n_events")})
    from repro_torch.core.streaming import StreamChunkRecord
    port = StreamChunkRecord(**{f: torch.from_numpy(v)
                                for f, v in rec.items()})
    jrec = StreamChunkRecord(**{f: jnp.asarray(v) for f, v in rec.items()})
    got, want = PT.stream_timeline(port), JT.stream_timeline(jrec)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    assert PT.summarize_stream_trace(port) == JT.summarize_stream_trace(jrec)
    empty = StreamChunkRecord(*(torch.from_numpy(v[:0])
                                for v in rec.values()))
    assert PT.summarize_stream_trace(empty)["chunks"] == 0
    assert to_numpy(S.make_window(2, device=CPU)).vm.tolist() == [-1, -1]
