"""The port's in-run metrics plane on the contracts of
``tests/test_metrics.py`` (its non-sharded cases), on the CPU; the
conformance cases are in ``test_torch_metrics_conformance.py``.

  * the plane's functions (``bucket_overlap``, ``hist_index``,
    ``accrue_interval``, ``fill_retirement``) are JAX's bit for bit on
    the same inputs, and the builders build JAX's plane;
  * probes off is free (an enabled plane run without the probes is left
    untouched and every other leaf equals the plain run) and probes on
    never perturb (only the plane differs);
  * leap on == leap off with probes on, plane included;
  * batched, padded and streamed lanes carry the single-lane plane bit
    for bit;
  * the host-side report round-trips through JSON and the validator.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import (POLICY_GRID, make_dynamic_scenario,
                              make_scenario, make_streamed_scenario)
from test_metrics import BINS, BUCKETS
from test_metrics import with_metrics as j_with_metrics
from test_torch_state import assert_same_state

from repro.core import engine as JE
from repro.core import metrics as JM
from repro_torch.core import engine as E
from repro_torch.core import metrics as M
from repro_torch.core import state as S
from repro_torch.core import sweep, telemetry
from repro_torch.core.convert import from_arrays
from repro_torch.core.scheduling import lane_axis
from repro_torch.core.state import map_tensors

CPU = "cpu"


def with_metrics(dc, *, horizon=256.0, sla_factor=2.0):
    return dataclasses.replace(dc, metrics=M.make_metrics(
        dc.hosts.num_pes.shape[0], horizon=horizon, buckets=BUCKETS,
        bins=BINS, sla_factor=sla_factor, device=CPU))


def _port(jdc):
    return from_arrays(jdc, device=CPU)


def _lane(batch, *idx):
    return map_tensors(lambda t: t[idx], batch)


def _unprobed(dc, **kw):
    """``run`` with the probe passes off, whatever the plane."""
    passes = E._passes_of(dc)._replace(probed=False)
    out, _ = E._drive(lane_axis(dc), horizon=float("inf"),
                      provision_policy=0, block=E.BLOCK, passes=passes,
                      **kw)
    return _lane(out, 0)


# ---------------------------------------------------------------------------
# Builders and the plane's functions against JAX
# ---------------------------------------------------------------------------
def test_make_metrics_validation():
    with pytest.raises(ValueError):
        M.metrics_edges(1, 1e-2, 1e4)
    with pytest.raises(ValueError):
        M.make_metrics(2, horizon=100.0, buckets=0, device=CPU)
    with pytest.raises(ValueError):
        M.make_metrics(2, horizon=0.0, device=CPU)
    edges = M.metrics_edges(BINS, 1e-2, 1e4)
    np.testing.assert_array_equal(edges, JM.metrics_edges(BINS, 1e-2, 1e4))
    assert edges.dtype == np.float32 and np.all(np.diff(edges) > 0)


@pytest.mark.parametrize("build", ["make", "none"])
def test_builders_build_the_jax_plane(build):
    if build == "make":
        got = M.make_metrics(5, horizon=80.0, buckets=BUCKETS, bins=BINS,
                             sla_factor=1.5, device=CPU)
        want = JM.make_metrics(5, horizon=80.0, buckets=BUCKETS, bins=BINS,
                               sla_factor=1.5)
    else:
        got, want = M.no_metrics(5, device=CPU), JM.no_metrics(5)
    assert_same_state(got, want)


def test_no_metrics_is_inert_and_undetected():
    dc = _port(make_scenario(0, S.SPACE_SHARED, S.SPACE_SHARED))
    assert not E.wants_probes(dc)
    assert E.wants_probes(with_metrics(dc))
    out = E.run(dc, max_steps=512)
    assert_same_state(out.metrics, dc.metrics)


def test_bucket_overlap_partitions_interval():
    m = M.make_metrics(1, horizon=80.0, buckets=BUCKETS, bins=BINS,
                       device=CPU)
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    ov = M.bucket_overlap(m, f(3.0), f(47.0), torch.tensor(True)).numpy()
    np.testing.assert_allclose(ov.sum(), 44.0, rtol=1e-6)
    np.testing.assert_allclose(ov[0], 7.0, rtol=1e-6)
    tail = M.bucket_overlap(m, f(75.0), f(200.0), torch.tensor(True)).numpy()
    np.testing.assert_allclose(tail[-1], 125.0, rtol=1e-6)
    assert np.all(tail[:-1] == 0.0)
    off = M.bucket_overlap(m, f(3.0), f(47.0), torch.tensor(False)).numpy()
    assert np.all(off == 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_plane_functions_are_jax_bitwise(seed):
    """``accrue_interval`` and ``fill_retirement`` on one plane, and on a
    batch of planes (leading lane axis), against JAX's on each lane."""
    rng = np.random.default_rng(seed)
    n_lanes, n_hosts, n_cl = 3, 5, 17
    f32 = lambda *s: rng.uniform(0, 90, s).astype(np.float32)
    jplanes, inputs = [], []
    for b in range(n_lanes):
        jm = JM.make_metrics(n_hosts, horizon=float(rng.uniform(20, 120)),
                             buckets=BUCKETS, bins=BINS,
                             sla_factor=float(rng.choice([0.0, 1.5])))
        jm = dataclasses.replace(jm, enabled=jnp.int32(b != 1))
        t0 = np.float32(rng.uniform(0, 100))
        x = dict(t0=t0, t1=np.float32(t0 + rng.uniform(0, 30)),
                 util=np.float32(rng.uniform()), watts=np.float32(
                     rng.uniform(0, 500)), fleet=np.float32(rng.integers(9)),
                 backlog=np.int32(rng.integers(6)),
                 flows=np.int32(rng.integers(3)),
                 busy_hosts=(rng.uniform(size=n_hosts) < 0.5).astype(
                     np.float32), dt=np.float32(rng.uniform(0, 30)))
        sub = f32(n_cl)
        start = sub + f32(n_cl) * 0.1
        y = dict(newly=rng.uniform(size=n_cl) < 0.6, finish=start + f32(n_cl),
                 submit=sub, start=start, bound=f32(n_cl) * 0.5)
        jplanes.append(jm)
        inputs.append((x, y))
    planes = [from_arrays(jm, device=CPU, cls=M.MetricsState)
              for jm in jplanes]
    stack = lambda xs: S.with_leaves(xs[0], [torch.stack(ts) for ts in zip(
        *(S.tensor_leaves(p) for p in xs))])
    tens = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in
                      d.items()}
    batch = stack(planes)
    bx = {k: torch.stack([tens(x)[k] for x, _ in inputs]) for k in
          inputs[0][0]}
    by = {k: torch.stack([tens(y)[k] for _, y in inputs]) for k in
          inputs[0][1]}
    got_b = M.fill_retirement(M.accrue_interval(batch, **bx), **by)
    for b, (jm, pm, (x, y)) in enumerate(zip(jplanes, planes, inputs)):
        jx = {k: jnp.asarray(v) for k, v in x.items()}
        jy = {k: jnp.asarray(v) for k, v in y.items()}
        want = JM.fill_retirement(JM.accrue_interval(jm, **jx), **jy)
        got = M.fill_retirement(M.accrue_interval(pm, **tens(x)), **tens(y))
        assert_same_state(got, want, f"lane {b}")
        assert_same_state(_lane(got_b, b), want, f"batched lane {b}")
        v = torch.from_numpy(np.concatenate([
            np.asarray(jm.edges), f32(9), [-1.0, 1e31]]).astype(np.float32))
        np.testing.assert_array_equal(
            M.hist_index(pm.edges, v).numpy(),
            np.asarray(JM.hist_index(jm.edges, jnp.asarray(v.numpy()))))


# ---------------------------------------------------------------------------
# Bitwise gates: probes off is free, probes never perturb, leap parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_probes_off_and_on_bitwise_gates(seed):
    dc = _port(make_scenario(seed, *POLICY_GRID[seed % 4]))
    probed = with_metrics(dc)
    base = E.run(dc, max_steps=512)
    off = _unprobed(probed, max_steps=512, leap=True)
    on = E.run(probed, max_steps=512)
    assert_same_state(off.metrics, probed.metrics)
    assert_same_state(dataclasses.replace(off, metrics=dc.metrics), base)
    assert_same_state(dataclasses.replace(on, metrics=off.metrics), off)
    assert int(on.metrics.hist_response.sum()) == int(
        (on.cloudlets.state == S.CL_DONE).sum())


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_leap_parity_with_probes(vp, tp):
    for seed in range(3):
        dc = with_metrics(_port(make_scenario(seed, vp, tp)))
        assert_same_state(E.run(dc, max_steps=1024, leap=False),
                          E.run(dc, max_steps=1024, leap=True),
                          f"static seed {seed}")
    for seed in (0, 1):
        dyn = with_metrics(_port(make_dynamic_scenario(seed, vp, tp)))
        off, s_off = E.run_stats(dyn, max_steps=1024, leap=False)
        on, s_on = E.run_stats(dyn, max_steps=1024, leap=True)
        assert_same_state(off, on, f"dynamic seed {seed}")
        assert s_on.n_events == s_off.n_events


# ---------------------------------------------------------------------------
# Sweep spellings carry the plane bit for bit
# ---------------------------------------------------------------------------
def _metric_batch(n=3):
    dcs = [with_metrics(_port(make_scenario(s, *POLICY_GRID[s % 4])),
                        horizon=128.0 + 64.0 * s, sla_factor=1.5 + 0.5 * s)
           for s in range(n)]
    return dcs, sweep.stack_scenarios(dcs)


def test_run_batch_lanes_match_single_runs():
    dcs, batch = _metric_batch()
    out = sweep.run_batch(batch, max_steps=512)
    for i in range(len(dcs)):
        single = E.run(_lane(batch, i), max_steps=512)
        assert_same_state(_lane(out.metrics, i), single.metrics, f"lane {i}")


def test_pad_batch_keeps_real_lane_metrics():
    dcs, batch = _metric_batch()
    padded = sweep.pad_batch(batch, 5)
    out = sweep.run_batch(padded, max_steps=512)
    ref = sweep.run_batch(batch, max_steps=512)
    assert_same_state(map_tensors(lambda x: x[:3], out.metrics),
                      ref.metrics)
    pad = map_tensors(lambda x: x[3:], out.metrics)
    assert bool((pad.enabled == 0).all() and (pad.bucket_dt == 0.0).all()
                and (pad.hist_response == 0).all())
    assert pad.bucket_dt.shape == (2, BUCKETS)
    assert pad.hist_response.shape == (2, BINS)


def test_run_stream_batch_lanes_match_single_runs():
    pairs = [make_streamed_scenario(s, *POLICY_GRID[s % 4])
             for s in range(3)]
    dcs = [with_metrics(_port(dc), horizon=64.0) for dc, _ in pairs]
    streams = [from_arrays(st, device=CPU, cls=S.ArrivalStream)
               for _, st in pairs]
    batch = sweep.stack_scenarios(dcs)
    fdc, _, _ = sweep.run_stream_batch(batch, streams)
    for b, stream in enumerate(streams):
        out, _, _ = E.run_stream(_lane(batch, b), stream)
        assert_same_state(_lane(fdc.metrics, b), out.metrics,
                          f"streamed lane {b}")


# ---------------------------------------------------------------------------
# Host side: timelines, percentiles, reports
# ---------------------------------------------------------------------------
def test_from_metrics_and_report_roundtrip():
    jdc = j_with_metrics(make_scenario(1, S.SPACE_SHARED, S.TIME_SHARED))
    out = E.run(_port(jdc), max_steps=1024)
    tl = telemetry.from_metrics(out)
    assert tl["bucket_start"].shape == (BUCKETS,)
    assert np.all(np.diff(tl["bucket_start"]) > 0)
    assert np.all((tl["utilization"] >= 0.0) & (tl["utilization"] <= 1.0))
    assert np.all(tl["utilization"][tl["bucket_dt"] == 0.0] == 0.0)
    report = telemetry.metrics_report(out)
    telemetry.validate_metrics_report(report)
    back = json.loads(json.dumps(report))
    telemetry.validate_metrics_report(back)
    assert back["schema"] == telemetry.METRICS_REPORT_SCHEMA
    assert back["counters"]["retired"] == int(
        (out.cloudlets.state == S.CL_DONE).sum())
    from repro.core import telemetry as JT
    want = JT.metrics_report(JE.run(jdc, max_steps=1024))
    for key in ("histograms", "counters", "percentiles"):
        assert back[key] == json.loads(json.dumps(want[key])), key
    _, batch = _metric_batch()
    with pytest.raises(ValueError):
        telemetry.from_metrics(sweep.run_batch(batch, max_steps=256))


def test_validate_metrics_report_rejects_mangled():
    dc = with_metrics(_port(make_scenario(2, S.TIME_SHARED, S.TIME_SHARED)))
    report = telemetry.metrics_report(E.run(dc, max_steps=1024))
    for mangle in (
            lambda r: r.pop("histograms"),
            lambda r: r.update(schema="repro.metrics/v0"),
            lambda r: r["buckets"]["utilization"].pop(),
            lambda r: r["counters"].update(retired=10_000),
            lambda r: r["counters"].update(sla_breaches=-1),
            lambda r: r["histograms"]["edges"].pop(),
    ):
        bad = json.loads(json.dumps(report))
        mangle(bad)
        with pytest.raises(ValueError):
            telemetry.validate_metrics_report(bad)


def test_hist_percentile_walk():
    edges = np.asarray([0.0, 1.0, 10.0, 100.0, 1e30], np.float32)
    hp = telemetry.hist_percentile
    assert hp([0, 0, 0, 0], edges, 50) == 0.0
    np.testing.assert_allclose(hp([0, 5, 0, 0], edges, 50), np.sqrt(10.0),
                               rtol=1e-6)
    np.testing.assert_allclose(hp([4, 0, 0, 0], edges, 50), 0.5, rtol=1e-6)
    np.testing.assert_allclose(hp([0, 0, 0, 3], edges, 99), 100.0,
                               rtol=1e-6)
    h = [0, 3, 1, 0]
    np.testing.assert_allclose(hp(h, edges, 25), np.sqrt(10.0), rtol=1e-6)
    np.testing.assert_allclose(hp(h, edges, 90), np.sqrt(1000.0), rtol=1e-6)
    np.testing.assert_allclose(hp(torch.tensor(h), torch.from_numpy(edges),
                                  90), np.sqrt(1000.0), rtol=1e-6)
