"""The port's event-horizon leap: leap on == leap off, bit for bit.

``repro_torch.core.engine`` leaps by default, as the JAX engine does:
after a full step that ends in a completion, further completions commit
on the step's frozen rates while no decision can intervene.  Held here:

  * leap on == leap off, every leaf, over the RNG-free golden corpus's
    static scenarios and the conformance subset, at several block sizes;
  * the leap fires on a drain-safe staggered workload (``n_events > 1``
    on some step; fewer full steps in a run);
  * ``max_steps`` and ``horizon`` with the leap on against the JAX
    engine's default ``run`` (discrete fields exact, floats at the
    conformance tolerances), and ``step(leap=True)``'s event counts
    against JAX's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, SEEDS, make_scenario
from test_golden_corpus import CORPUS, rebuild
from test_torch_state import assert_same_state

from repro.core import engine as JE
from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_stats, step


def _assert_matches_jax(got, want, ctx):
    """Discrete fields exact; times and joules within 1e-3 (s, J), the
    conformance tolerance; remaining MI also within 1e-6 relative (the
    staggered workload's 6e5 MI are 0.03 MI apart in f32)."""
    for blk, name in (("cloudlets", "state"), ("vms", "state"),
                      ("vms", "host")):
        np.testing.assert_array_equal(
            getattr(getattr(got, blk), name).numpy(),
            np.asarray(getattr(getattr(want, blk), name)),
            err_msg=f"{ctx} {blk}.{name}")
    close = lambda a, b, name, rtol=0.0: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=rtol, atol=1e-3,
        err_msg=f"{ctx} {name}")
    close(got.cloudlets.remaining, want.cloudlets.remaining, "remaining",
          rtol=1e-6)
    for name in ("start_time", "finish_time"):
        close(getattr(got.cloudlets, name), getattr(want.cloudlets, name),
              name)
    close(got.time, want.time, "time")
    close(got.hosts.energy_j, want.hosts.energy_j, "energy_j")


def _on_off(dc, **kw):
    off, s_off = run_stats(dc, leap=False, **kw)
    on, s_on = run_stats(dc, leap=True, **kw)
    return off, s_off, on, s_on


def _static_corpus():
    with open(CORPUS) as f:
        return json.load(f)["scenarios"]["static"]


@pytest.mark.parametrize("seed", sorted(_static_corpus(), key=int))
def test_golden_corpus_static_leap_bitwise(seed):
    stored = _static_corpus()[seed]
    for vp, tp in POLICY_GRID:
        dc = from_arrays(rebuild(stored, vp, tp), device="cpu")
        off, s_off, on, s_on = _on_off(dc, max_steps=1024)
        assert_same_state(on, off, f"corpus {seed} ({vp},{tp})")
        assert s_on.n_events == s_off.n_events == s_off.n_full


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_conformance_subset_leap_bitwise(vp, tp):
    for seed in SEEDS[:6]:
        dc = from_arrays(make_scenario(seed, vp, tp), device="cpu")
        off, _, on, _ = _on_off(dc, max_steps=2048)
        assert_same_state(on, off, f"seed {seed} ({vp},{tp})")
        for block in (1, 3):
            out = run(dc, max_steps=2048, leap=True, block=block)
            assert_same_state(out, off, f"seed {seed} block {block}")


def staggered(seed=0, n_hosts=64, n_vms=32, waves=3, device="cpu"):
    """``tests/test_leap_parity.py``'s drain-safe workload: reserved PEs,
    2 PEs a host, per-cloudlet jittered lengths."""
    rng = np.random.default_rng(seed)
    hosts = S.make_uniform_hosts(n_hosts, pes=2, ram=2048.0, device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=waves, length_mi=600_000.0,
                                         period=300.0), device=device)
    jit = (1.0 + 0.4 * rng.random(tuple(cl.length.shape))).astype(np.float32)
    jit = torch.from_numpy(jit).to(device)
    cl = dataclasses.replace(cl, length=cl.length * jit,
                             remaining=cl.remaining * jit)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=S.TIME_SHARED, reserve_pes=True,
                             device=device)


def _j_staggered(seed=0):
    from test_leap_parity import _staggered_scenario
    return _staggered_scenario(seed)


def test_staggered_builders_agree_with_jax():
    assert_same_state(staggered(), _j_staggered())


def test_leap_fires_on_staggered_and_stays_bitwise():
    dc = staggered()
    d_on, max_leap, outer_on = dc, 0, 0
    while True:
        nxt, rec = step(d_on, leap=True)
        if not bool(rec.active):
            break
        d_on, outer_on = nxt, outer_on + 1
        max_leap = max(max_leap, int(rec.n_events))
    d_off, outer_off = dc, 0
    while True:
        d_off, rec = step(d_off)
        if not bool(rec.active):
            break
        outer_off += 1
    assert max_leap > 1, "the leap never committed more than one event"
    assert outer_on < outer_off, (outer_on, outer_off)
    assert_same_state(d_on, d_off, "staggered, step by step")

    off, s_off, on, s_on = _on_off(dc)
    assert_same_state(on, off, "staggered, run")
    assert_same_state(on, d_off, "staggered, run vs steps")
    assert s_on.n_events == s_off.n_events == outer_off
    assert s_on.n_full == outer_on < s_off.n_full
    assert s_on.n_leap > 0 and s_off.n_leap == 0


def test_step_leap_counts_match_jax():
    """step(leap=True) commits the same events per step as JAX's."""
    jstep = jax.jit(lambda d: JE.step(
        d, dynamic=False, networked=False, leap=True,
        leap_budget=jnp.int32(2 ** 30), leap_horizon=jnp.float32(S.INF)))
    jdc, tdc = _j_staggered(1), staggered(1)
    for _ in range(24):
        jdc, jrec = jstep(jdc)
        tdc, trec = step(tdc, leap=True)
        assert int(trec.n_events) == int(jrec.n_events)
        assert bool(trec.active) == bool(jrec.active)
        np.testing.assert_allclose(float(trec.time), float(jrec.time),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("k", [1, 2, 5, 9, 40])
def test_max_steps_with_leap_matches_jax(k):
    """``max_steps`` counts events: the leap gets the budget that is
    left, as JAX's default run gives it."""
    cases = [(make_scenario(seed, vp, tp), (seed, vp, tp))
             for seed in (0, 4) for vp, tp in POLICY_GRID]
    cases.append((_j_staggered(), "staggered"))
    for jdc, ctx in cases:
        want = JE.run(jdc, max_steps=k)
        dc = from_arrays(jdc, device="cpu")
        got, stats = run_stats(dc, max_steps=k)
        assert stats.n_events <= k
        _assert_matches_jax(got, want, (ctx, k))
        assert_same_state(got, run(dc, max_steps=k, leap=False),
                          f"{ctx} {k}")


@pytest.mark.parametrize("horizon", [0.0, 3.0, 12.5, 700.0])
def test_horizon_with_leap_matches_jax(horizon):
    cases = [(make_scenario(7, vp, tp), (vp, tp)) for vp, tp in POLICY_GRID]
    cases.append((_j_staggered(), "staggered"))
    for jdc, ctx in cases:
        want = JE.run(jdc, horizon=horizon)
        dc = from_arrays(jdc, device="cpu")
        got = run(dc, horizon=horizon, block=5)
        _assert_matches_jax(got, want, (ctx, horizon))
        assert_same_state(got, run(dc, horizon=horizon, leap=False),
                          f"{ctx} {horizon}")
