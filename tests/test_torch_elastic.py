"""The port's elastic building blocks against the JAX package, on the CPU:
``state.make_autoscaler``, the spot market (``market.spot_price_at``,
``next_spot_boundary``, ``mean_spot_price``, ``cheapest_spot_provider``,
``make_spot_market``) and the autoscaler pass (``engine.apply_autoscaler``
and the step's device predicate ``engine._scale_due``).

The spot lookups compare exact f32 table values, so they are held
bitwise; the autoscaler on random mid-run states of the elastic
conformance scenarios, with random knobs, is held exactly: VM states,
hosts, counts, the cooldown clock and the (integer-valued) free pools.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, make_elastic_scenario

from repro.core import engine as JE
from repro.core import market as JM
from repro.core import state as JS
from repro_torch.core import engine as E
from repro_torch.core import market
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays
from repro_torch.core.scheduling import lane_axis

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {},
    dict(util_high=0.55, util_low=0.18, cooldown=2.5, min_fleet=1,
         max_fleet=8, scale_step=2, price_sensitivity=0.04,
         spot_t=[0.0, 3.5, 9.25], spot_price=[0.02, 0.07, 0.01]),
])
def test_make_autoscaler_matches_jax(kw):
    got = S.make_autoscaler(device=CPU, **kw)
    want = JS.make_autoscaler(**kw)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, f.name
        np.testing.assert_array_equal(_np(a), b, err_msg=f.name)
    assert float(got.last_action) == float(np.float32(-1e30))
    assert int(got.enabled) == 1


@pytest.mark.parametrize("t,p", [
    ([0.0, 1.0], [0.1]),            # unequal lengths
    ([1.0, 2.0], [0.1, 0.2]),       # does not start at 0
    ([0.0, 2.0, 2.0], [0.1] * 3),   # not strictly increasing
    ([], []),                       # empty
])
def test_spot_tables_are_validated(t, p):
    with pytest.raises(ValueError):
        S.make_autoscaler(spot_t=t, spot_price=p, device=CPU)
    with pytest.raises(ValueError):
        market.make_spot_market([(t, p)], device=CPU)
    with pytest.raises(ValueError):
        JS.make_autoscaler(spot_t=t, spot_price=p)


def test_make_spot_market_pads_like_jax():
    tracks = [([0.0, 5.0, 7.5], [0.03, 0.09, 0.02]), ([0.0], [0.05]),
              ([0.0, 2.25], [0.08, 0.01])]
    got = market.make_spot_market(tracks, device=CPU)
    want = JM.make_spot_market(tracks)
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    np.testing.assert_array_equal(got.prices.numpy(),
                                  np.asarray(want.prices))
    with pytest.raises(ValueError):
        market.make_spot_market([], device=CPU)


# ---------------------------------------------------------------------------
# Spot lookups, bitwise
# ---------------------------------------------------------------------------
def _random_scalers(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 5))
        t = np.concatenate([[0.0], np.cumsum(np.round(
            rng.uniform(0.5, 9.0, k - 1), 2))]).astype(np.float32)
        p = np.round(rng.uniform(0.0, 0.2, k), 3).astype(np.float32)
        kw = dict(spot_t=t, spot_price=p) if i % 3 else {}
        out.append(JS.make_autoscaler(**kw))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_spot_price_and_boundary_bitwise(seed):
    """Each lane alone and all lanes stacked, at table values, between
    them, before and after: the price and the next boundary are JAX's
    bit for bit (0 and INF while a track is disabled)."""
    scalers = _random_scalers(seed)
    width = max(int(np.asarray(s.spot_t).shape[0]) for s in scalers)
    pad = lambda x: np.concatenate([x, np.full(width - x.shape[0], x[-1],
                                               np.float32)])
    rng = np.random.default_rng(100 + seed)
    port = []
    for s in scalers:
        t = np.asarray(s.spot_t)
        times = np.concatenate([t, t + np.float32(0.001), t - 0.5,
                                rng.uniform(0, 40, 5).astype(np.float32),
                                [1e30]]).astype(np.float32)
        one = from_arrays(s, device=CPU, cls=S.AutoscalerState)
        for x in times:
            jt = jnp.float32(x)
            assert float(market.spot_price_at(one, x)) == float(
                JM.spot_price_at(s, jt))
            assert float(market.next_spot_boundary(one, x)) == float(
                JM.next_spot_boundary(s, jt))
        port.append(dataclasses.replace(
            one, spot_t=torch.from_numpy(pad(t)),
            spot_price=torch.from_numpy(pad(np.asarray(s.spot_price)))))
    lanes = S.with_leaves(port[0], [torch.stack(ts) for ts in zip(
        *(S.tensor_leaves(p) for p in port))])
    now = torch.from_numpy(rng.uniform(0, 30, len(port)).astype(np.float32))
    price = market.spot_price_at(lanes, now)
    nxt = market.next_spot_boundary(lanes, now)
    for i, s in enumerate(scalers):
        assert float(price[i]) == float(JM.spot_price_at(s, now[i].item()))
        assert float(nxt[i]) == float(JM.next_spot_boundary(
            s, jnp.float32(now[i].item())))


def test_mean_price_and_cheapest_provider():
    tracks = [([0.0, 30.0, 60.0], [0.05, 0.4, 0.08]), ([0.0], [0.12]),
              ([0.0, 10.0, 20.0, 90.0], [0.3, 0.01, 0.09, 0.5])]
    got = market.make_spot_market(tracks, device=CPU)
    want = JM.make_spot_market(tracks)
    for horizon in (15.0, 60.0, 120.0, 1000.0):
        np.testing.assert_allclose(
            market.mean_spot_price(got, horizon=horizon).numpy(),
            np.asarray(JM.mean_spot_price(want, horizon=horizon)),
            rtol=1e-6, atol=0)
        assert int(market.cheapest_spot_provider(got, horizon=horizon)) == \
            int(JM.cheapest_spot_provider(want, horizon=horizon))
        lat = [0.2, 0.0, 0.9]
        assert int(market.cheapest_spot_provider(
            got, horizon=horizon, latency_row=lat, latency_weight=0.3)) == \
            int(JM.cheapest_spot_provider(want, horizon=horizon,
                                          latency_row=lat,
                                          latency_weight=0.3))


# ---------------------------------------------------------------------------
# The autoscaler pass, on random mid-run states
# ---------------------------------------------------------------------------
_jstep = jax.jit(functools.partial(JE.step, dynamic=True, elastic=True))
_japply = jax.jit(JE.apply_autoscaler)


def _states(seed, vp, tp, steps=(0, 3, 6, 10, 16, 24, 34)):
    """Mid-run states of an elastic conformance scenario (JAX's steps),
    each with random knobs and the cooldown clock, and with eager knobs
    (scale up over 0.3, down under 0.29, no cooldown)."""
    rng = np.random.default_rng(7_000 + seed)
    dc = make_elastic_scenario(seed, vp, tp)
    out = []
    for k in range(max(steps) + 1):
        if k in steps:
            sc = dc.scaler
            for _ in range(3):
                lo = float(rng.choice([0.18, 0.28, 0.45]))
                knobs = dataclasses.replace(
                    sc,
                    util_high=jnp.float32(rng.choice([0.3, 0.55])),
                    util_low=jnp.float32(lo),
                    cooldown=jnp.float32(rng.choice([0.0, 1.5, 50.0])),
                    scale_step=jnp.int32(rng.integers(0, 4)),
                    min_fleet=jnp.int32(rng.integers(0, 3)),
                    max_fleet=jnp.int32(rng.integers(3, 9)),
                    price_sensitivity=jnp.float32(
                        rng.choice([0.0, 0.0, 0.06])),
                    last_action=jnp.float32(
                        rng.choice([-1e30, float(dc.time) - 1.0])))
                out.append(dataclasses.replace(dc, scaler=knobs))
            eager = dataclasses.replace(
                sc, util_high=jnp.float32(0.3), util_low=jnp.float32(0.29),
                cooldown=jnp.float32(0.0), scale_step=jnp.int32(2),
                min_fleet=jnp.int32(0), max_fleet=jnp.int32(8),
                price_sensitivity=jnp.float32(0.0))
            out.append(dataclasses.replace(dc, scaler=eager))
        dc, _ = _jstep(dc)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_apply_autoscaler_matches_jax(seed):
    """Scenarios ``seed`` and ``seed + 8`` (some seeds fail to place their
    whole fleet, and then nothing can act)."""
    vp, tp = POLICY_GRID[seed % 4]
    acted = 0
    states = _states(seed, vp, tp) + _states(seed + 8, vp, tp)
    for i, jdc in enumerate(states):
        ctx = (seed, i)
        want = _japply(jdc)
        port = from_arrays(jdc, device=CPU)
        got = E.apply_autoscaler(port)
        due = bool(E._scale_due(lane_axis(port))[0])
        moved = not np.array_equal(np.asarray(want.vms.state),
                                   np.asarray(jdc.vms.state))
        assert due == moved, ctx
        acted += moved
        for blk, names in (("vms", ("state", "host", "mig_remaining")),
                           ("cloudlets", ("state",)),
                           ("hosts", ("free_ram", "free_bw", "free_storage",
                                      "free_pes")),
                           ("scaler", ("last_action", "up_count",
                                       "down_count"))):
            for name in names:
                np.testing.assert_array_equal(
                    _np(getattr(getattr(got, blk), name)),
                    np.asarray(getattr(getattr(want, blk), name)),
                    err_msg=f"{ctx} {blk}.{name}")
        if not moved:
            for a, b in zip(S.tensor_leaves(got), S.tensor_leaves(port)):
                assert torch.equal(a, b), ctx
    assert acted > 0, seed


def test_scale_due_is_off_for_a_disabled_scaler():
    """The step's predicate holds only on enabled lanes; the pass itself
    (like JAX's) reads the knobs whatever the flag."""
    for jdc in _states(2, 0, 0, steps=(3, 8)):
        port = from_arrays(jdc, device=CPU)
        off = dataclasses.replace(port, scaler=dataclasses.replace(
            port.scaler, enabled=torch.zeros((), dtype=torch.int32)))
        assert not bool(E._scale_due(lane_axis(off))[0])
