"""The port's run loop: the §5 quickstart, the quiescence fixed point,
block-size invariance, ``max_steps``/``horizon`` against the JAX engine,
an elastic and a probed scenario through ``run`` and ``step`` against
JAX's, and the broker/market reducers against JAX."""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from test_conformance import (POLICY_GRID, make_elastic_scenario,
                              make_scenario)
from test_torch_state import assert_same_state, quickstart_states

from repro.core import broker as JB
from repro.core import engine as JE
from repro.core import market as JM
from repro.core import metrics as JMET
from repro.core import state as JS
from repro.core.engine import run as j_run
from repro_torch.core import broker as B
from repro_torch.core import market
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_stats, run_trace, step


@pytest.mark.parametrize("policy", [S.SPACE_SHARED, S.TIME_SHARED])
def test_quickstart_500_done(policy):
    """examples/quickstart.py through the port: 500/500 done; space-shared
    exec exactly 1200 s, time-shared stretched; makespan 12000 s."""
    hosts = S.make_uniform_hosts(1000, device="cpu")
    vms = B.build_fleet([B.VmSpec(count=50, pes=1, mips=1000.0, ram=512.0,
                                  size=1000.0)], device="cpu")
    cloudlets = B.build_waves(50, B.WaveSpec(waves=10, length_mi=1_200_000.0,
                                             period=600.0), device="cpu")
    dc = S.make_datacenter(hosts, vms, cloudlets, vm_policy=S.SPACE_SHARED,
                           task_policy=policy, reserve_pes=True,
                           rates=S.make_market(0.01, 0.001, 1e-4, 0.002,
                                               device="cpu"), device="cpu")
    final = run(dc, max_steps=8192)
    report = B.collect(final)
    exec_t = (final.cloudlets.finish_time - final.cloudlets.start_time)
    assert int(report.n_completed) == 500
    assert float(report.makespan) == 12000.0
    if policy == S.SPACE_SHARED:
        assert float(exec_t.min()) == 1200.0 and float(exec_t.max()) == 1200.0
    else:
        assert float(exec_t.min()) == 2200.0


@pytest.mark.parametrize("seed", [0, 3, 6])
def test_quiescence_is_a_bitwise_fixed_point(seed):
    for vp, tp in POLICY_GRID:
        dc = from_arrays(make_scenario(seed, vp, tp), device="cpu")
        out = run(dc, max_steps=192)
        again, rec = step(out)
        assert not bool(rec.active)
        assert_same_state(again, out)
        assert_same_state(run(out, max_steps=192), out)


@pytest.mark.parametrize("seed", [1, 2, 5, 8])
def test_result_is_bitwise_invariant_to_block_size(seed):
    for vp, tp in POLICY_GRID:
        dc = from_arrays(make_scenario(seed, vp, tp), device="cpu")
        ref, ref_stats = run_stats(dc, max_steps=192, block=1)
        for block in (7, 64):
            out, stats = run_stats(dc, max_steps=192, block=block)
            assert_same_state(out, ref, f"seed {seed} block {block}")
            assert stats.n_events == ref_stats.n_events


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_max_steps_matches_jax(k):
    for seed in (0, 4):
        for vp, tp in POLICY_GRID:
            jdc = make_scenario(seed, vp, tp)
            want = j_run(jdc, max_steps=k, leap=False)
            got, stats = run_stats(from_arrays(jdc, device="cpu"),
                                   max_steps=k, block=4)
            assert stats.n_events <= k
            _assert_matches_jax(got, want, (seed, vp, tp, k))


@pytest.mark.parametrize("horizon", [0.0, 3.0, 12.5])
def test_horizon_matches_jax(horizon):
    for vp, tp in POLICY_GRID:
        jdc = make_scenario(7, vp, tp)
        want = j_run(jdc, horizon=horizon, leap=False)
        got = run(from_arrays(jdc, device="cpu"), horizon=horizon, block=5)
        _assert_matches_jax(got, want, (vp, tp, horizon))


def _assert_matches_jax(got, want, ctx):
    for blk, name in (("cloudlets", "state"), ("vms", "state"),
                      ("vms", "host")):
        np.testing.assert_array_equal(
            getattr(getattr(got, blk), name).numpy(),
            np.asarray(getattr(getattr(want, blk), name)),
            err_msg=f"{ctx} {blk}.{name}")
    for name in ("remaining", "start_time", "finish_time"):
        np.testing.assert_allclose(getattr(got.cloudlets, name).numpy(),
                                   np.asarray(getattr(want.cloudlets, name)),
                                   rtol=0, atol=1e-3, err_msg=f"{ctx} {name}")
    np.testing.assert_allclose(float(got.time), float(want.time), rtol=0,
                               atol=1e-3, err_msg=str(ctx))
    np.testing.assert_allclose(got.hosts.energy_j.numpy(),
                               np.asarray(want.hosts.energy_j), rtol=0,
                               atol=1e-3, err_msg=str(ctx))


def _probed():
    jdc = make_scenario(0, 0, 0)
    return dataclasses.replace(jdc, metrics=JMET.make_metrics(
        3, horizon=100.0))


ELASTIC_AND_PROBED = {
    "elastic": lambda: make_elastic_scenario(0, 0, 0),
    "probed": _probed,
}


@pytest.mark.parametrize("kind", sorted(ELASTIC_AND_PROBED))
def test_run_and_step_take_elastic_and_probed_scenarios(kind):
    """The scenarios the static slices refused, through ``run`` and
    ``step`` (``run_trace``'s steps), against the JAX engine's: states,
    placements, scale counts and histograms exact; times, joules, spot
    spend and the plane's float rows within 1e-3."""
    jdc = ELASTIC_AND_PROBED[kind]()
    dc = from_arrays(jdc, device="cpu")
    want = j_run(jdc, max_steps=4096)
    got = run(dc, max_steps=4096)
    _, trace = run_trace(dc, num_steps=64)
    _, jtrace = JE.run_trace(jdc, num_steps=64)
    for name in ("active", "n_done", "n_running", "fleet"):
        np.testing.assert_array_equal(getattr(trace, name).numpy(),
                                      np.asarray(getattr(jtrace, name)),
                                      err_msg=name)
    for name in ("time", "spot_cost", "watts", "utilization"):
        np.testing.assert_allclose(getattr(trace, name).numpy(),
                                   np.asarray(getattr(jtrace, name)),
                                   rtol=1e-4, atol=1e-3, err_msg=name)
    _, rec = step(dc)
    assert bool(rec.active) and float(rec.time) == float(jtrace.time[0])
    _assert_matches_jax(got, want, kind)
    for blk, names in (("scaler", ("up_count", "down_count")),
                       ("metrics", ("hist_response", "hist_exec",
                                    "hist_wait", "sla_breaches"))):
        for name in names:
            np.testing.assert_array_equal(
                getattr(getattr(got, blk), name).numpy(),
                np.asarray(getattr(getattr(want, blk), name)),
                err_msg=f"{blk}.{name}")
    for blk, names in (("scaler", ("spot_cost",)),
                       ("metrics", ("bucket_dt", "bucket_util",
                                    "bucket_watts", "host_busy_s"))):
        for name in names:
            np.testing.assert_allclose(
                getattr(getattr(got, blk), name).numpy(),
                np.asarray(getattr(getattr(want, blk), name)), rtol=1e-4,
                atol=1e-3, err_msg=f"{blk}.{name}")
    assert (int(got.scaler.up_count) > 0 if kind == "elastic"
            else int(got.metrics.hist_response.sum()) > 0)


@pytest.mark.parametrize("policy", [S.SPACE_SHARED, S.TIME_SHARED])
def test_collect_and_bill_match_jax(policy):
    """Reducers on the same final state (the JAX engine's, converted)."""
    _, jdc = quickstart_states(policy=policy)
    jdc = dataclasses.replace(jdc, rates=JS.make_market(0.01, 0.001, 1e-4,
                                                        0.002))
    # half-way, so some cloudlets are unfinished and NaN-masked
    for k in (7, 10_000):
        jfinal = j_run(jdc, max_steps=k, leap=False)
        tfinal = from_arrays(jfinal, device="cpu")
        want = JB.collect(jfinal)
        got = B.collect(tfinal)
        for name in want._fields:
            np.testing.assert_allclose(float(getattr(got, name)),
                                       float(getattr(want, name)),
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(market.bill_by_vm(tfinal).numpy(),
                                   np.asarray(JM.bill_by_vm(jfinal)),
                                   rtol=1e-6)


def test_quotes_match_jax():
    rates_t = market.flat_rates(device="cpu")
    rates_j = JM.flat_rates()
    np.testing.assert_allclose(
        float(market.quote_vm(rates_t, ram=512.0, size=1000.0)),
        float(JM.quote_vm(rates_j, ram=512.0, size=1000.0)), rtol=1e-7)
    kw = dict(length_mi=1_200_000.0, host_mips_pe=1000.0, file_size=0.3,
              output_size=0.3)
    np.testing.assert_allclose(float(market.quote_cloudlet(rates_t, **kw)),
                               float(JM.quote_cloudlet(rates_j, **kw)),
                               rtol=1e-7)


def test_step_record_matches_jax():
    j_step = jax.jit(functools.partial(JE.step, dynamic=False))
    for vp, tp in POLICY_GRID:
        jdc = make_scenario(3, vp, tp)
        tdc = from_arrays(jdc, device="cpu")
        for _ in range(4):
            jdc, jrec = j_step(jdc)
            tdc, trec = step(tdc)
            for name in jrec._fields:
                np.testing.assert_allclose(
                    np.asarray(getattr(trec, name), np.float64),
                    np.asarray(getattr(jrec, name), np.float64),
                    rtol=1e-5, atol=1e-5, err_msg=name)
