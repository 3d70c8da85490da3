"""The port's MoE (``repro_torch.models.moe``) and the three MoE
architectures against the JAX package on the CPU.

Inputs are made with NumPy from a seed; weights are JAX's (``init_moe``,
``init_params``) carried over by ``params_from_jax``.  Held here:
``moe_capacity`` exactly; ``moe_block`` in f32 with no drop and with
drops (``tests/test_models.py``'s two configs) within atol 1e-5 / rtol
1e-4, ``dropped_frac`` equal and ``load_balance_loss`` within 1e-6;
tied router probabilities route to JAX's experts; ``prefill``,
``forward``'s summed aux and ``decode_step`` of each MoE smoke config
(logits within 1e-4, greedy tokens exact); and the counterparts of
``test_moe_matches_oracle_no_drop`` and ``test_moe_capacity_drops_tokens``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.models import config as JC
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch import configs as TCFG
from repro_torch.models import config as TC
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.models.convert import cache_from_jax, params_from_jax

MOE_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
             "jamba-1.5-large-398b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    base = dict(name="m", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=2, head_dim=16, d_ff=48, vocab_size=11,
                dtype="float32")
    base.update(kw)
    return (JC.ModelConfig(pattern=JC.uniform_pattern(moe=True), **base),
            TC.ModelConfig(pattern=TC.uniform_pattern(moe=True), **base))


# tests/test_models.py:140 (no drop) and :153 (drops)
NO_DROP = dict(num_experts=8, num_experts_per_tok=2, capacity_factor=64.0)
DROPS = dict(num_experts=4, num_experts_per_tok=2, capacity_factor=0.25)


def _pair(kw, shape, seed=0):
    jcfg, tcfg = _cfgs(**kw)
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in _np(jp).items()}
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, x


def _oracle(params, cfg, x):
    """Loop over experts with unlimited capacity (``test_models.py``'s
    ``moe_oracle``), in torch."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ params["router"], -1)
    w, idx = TMOE.top_k(probs, cfg.num_experts_per_tok)
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        g = xf @ params["gate"][e]
        u = xf @ params["up"][e]
        o = (torch.nn.functional.silu(g) * u) @ params["down"][e]
        we = torch.where(idx == e, w, 0.0).sum(-1)
        y = y + o * we[:, None]
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# moe_capacity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0, 16.0, 64.0])
def test_moe_capacity_equals_jax(factor):
    for t in (1, 2, 7, 8, 16, 64, 100, 1000, 8192, 32768):
        for k in (1, 2, 6, 8):
            for e in (2, 4, 8, 16, 64, 128):
                jcfg, tcfg = _cfgs(num_experts=e, num_experts_per_tok=k,
                                   capacity_factor=factor)
                got = TMOE.moe_capacity(tcfg, t)
                assert got == JMOE.moe_capacity(jcfg, t), (t, k, e)
                assert got % 8 == 0 and got >= 8


# ---------------------------------------------------------------------------
# moe_block against JAX and against the loop-over-experts oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,shape", [("no-drop", (2, 8, 32)),
                                        ("drops", (4, 16, 32)),
                                        ("no-drop", (3, 5, 32)),
                                        ("drops", (1, 1, 32))])
def test_moe_block_matches_jax(case, shape):
    kw = NO_DROP if case == "no-drop" else DROPS
    jcfg, tcfg, jp, tp, x = _pair(kw, shape)
    jy, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x))
    ty, taux = TMOE.moe_block(tp, tcfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-4)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=0,
                               atol=1e-6)
    assert ty.dtype == torch.float32 and taux["dropped_frac"].dtype == \
        torch.float32
    if case == "drops" and shape[0] > 1:
        assert float(taux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("capacity", [8, 16, 24])
def test_moe_block_explicit_capacity_matches_jax(capacity):
    jcfg, tcfg, jp, tp, x = _pair(DROPS, (4, 16, 32), seed=3)
    jy, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x), capacity=capacity)
    ty, taux = TMOE.moe_block(tp, tcfg, _t(x), capacity=capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-4)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])


def test_moe_block_bf16_matches_jax():
    """bf16 experts (the router stays f32): within bf16's tolerance."""
    jcfg, tcfg = _cfgs(**NO_DROP)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    jp = JMOE.init_moe(jax.random.PRNGKey(4), jcfg, jnp.bfloat16)
    tp = convert._tree(_np(jp), torch.device("cpu"))   # bf16 bit patterns
    assert tp["router"].dtype == torch.float32
    assert tp["gate"].dtype == torch.bfloat16
    x = np.random.default_rng(5).standard_normal((2, 8, 32)).astype(
        np.float32)
    jy, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    ty, taux = TMOE.moe_block(tp, tcfg, _t(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=2e-2,
                               rtol=2e-2)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])


def test_moe_matches_oracle_no_drop():
    jcfg, tcfg, jp, tp, x = _pair(NO_DROP, (2, 8, 32))
    got, aux = TMOE.moe_block(tp, tcfg, _t(x))
    want = _oracle(tp, tcfg, _t(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)
    assert float(aux["dropped_frac"]) == 0.0


def test_moe_capacity_drops_tokens():
    _, tcfg, _, tp, x = _pair(DROPS, (4, 16, 32))
    _, aux = TMOE.moe_block(tp, tcfg, _t(x))
    assert float(aux["dropped_frac"]) > 0.0
    assert float(aux["load_balance_loss"]) >= 1.0 - 1e-3  # >= 1 at optimum


# ---------------------------------------------------------------------------
# ties in top-k
# ---------------------------------------------------------------------------
def test_top_k_ties_take_the_lower_index_as_jax():
    rng = np.random.default_rng(7)
    # probabilities on a coarse grid: many exact ties in every row
    probs = (rng.integers(0, 4, (64, 16)) / 4.0).astype(np.float32)
    for k in (1, 2, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TMOE.top_k(_t(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tied_router_routes_to_jax_experts():
    """Experts 0/2 and 1/3 have equal router columns, so every token's
    probabilities tie pairwise and its top 2 is one tied pair, the lower
    expert first, as JAX's; the block's outputs agree."""
    jcfg, tcfg, jp, tp, x = _pair(dict(num_experts=4, num_experts_per_tok=2,
                                       capacity_factor=64.0), (2, 8, 32))
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 0]
    router[:, 3] = router[:, 1]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": _t(router)}
    xf = x.reshape(-1, 32)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], -1)
    tprobs = torch.softmax(_t(xf) @ tp["router"], -1)
    assert bool((tprobs[:, 0] == tprobs[:, 2]).all())
    _, ji = jax.lax.top_k(jprobs, 2)
    _, ti = TMOE.top_k(tprobs, 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ti = ti.numpy()
    assert ((ti[:, 1] - ti[:, 0]) == 2).all()
    jy, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x))
    ty, taux = TMOE.moe_block(tp, tcfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), atol=1e-6)


# ---------------------------------------------------------------------------
# the MoE smoke configs: prefill, forward's aux, decode_step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _smoke(arch):
    jcfg = JCFG.get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = TCFG.get_smoke_config(arch)
    return jcfg, jp, tcfg, params_from_jax(_np(jp), tcfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_jax(arch):
    jcfg, jp, tcfg, tp = _smoke(arch)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    jl, jkv = JM.prefill(jp, jcfg, jnp.asarray(toks))
    metrics = []
    tl, tkv = TM.prefill(tp, tcfg, _t(toks).long(), metrics=metrics)
    assert tl.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl.argmax(-1)))
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4,
                                   rtol=1e-4)
    n_moe = sum(s.moe for s in tcfg.pattern) * tcfg.num_blocks
    assert len(metrics) == n_moe > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_aux_matches_jax(arch):
    """``forward``'s third value: the load-balance loss summed over the
    MoE sub-layers, within 1e-6 of JAX's (relative to its size)."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    jh, _, jaux = JM.forward(jp, jcfg, jnp.asarray(toks), remat="none")
    th, kvs, taux = TM.forward(tp, tcfg, _t(toks).long())
    assert kvs == () and taux.dtype == torch.float32 and taux.ndim == 0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_matches_jax(arch):
    jcfg, jp, tcfg, tp = _smoke(arch)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jstep = jax.jit(JM.decode_step, static_argnums=1)
    jc = JM.init_cache(jcfg, 2, 16)
    tc = cache_from_jax(_np(jc), device="cpu")
    for t in range(12):
        pos = np.full((2,), t, np.int32)
        jl, jc = jstep(jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jc,
                       jnp.asarray(pos))
        tl, tc = TM.decode_step(tp, tcfg, _t(toks[:, t:t + 1]).long(), tc,
                                _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl.argmax(-1)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_greedy_tokens_match_jax(arch):
    """Greedy generation from a prompt: prefill, then 8 decode steps
    fed back their own argmax; every token equal to JAX's."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    prompt = np.random.default_rng(9).integers(0, jcfg.vocab_size,
                                               (2, 6)).astype(np.int32)
    jstep = jax.jit(JM.decode_step, static_argnums=1)
    jc = JM.init_cache(jcfg, 2, 16)
    tc = cache_from_jax(_np(jc), device="cpu")
    jtok, ttok = jnp.asarray(prompt[:, :1]), _t(prompt[:, :1]).long()
    jout, tout = [], []
    for t in range(14):
        pos = np.full((2,), t, np.int32)
        jl, jc = jstep(jp, jcfg, jtok, jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tp, tcfg, ttok, tc, _t(pos))
        if t + 1 < prompt.shape[1]:
            jtok = jnp.asarray(prompt[:, t + 1:t + 2])
            ttok = _t(prompt[:, t + 1:t + 2]).long()
        else:
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            ttok = tl.argmax(-1)
            jout.append(np.asarray(jtok))
            tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))


# ---------------------------------------------------------------------------
# init: the stacked leaves are filled in place, in the draw order
# ---------------------------------------------------------------------------
def test_init_blocks_fills_in_draw_order():
    """``init_blocks`` allocates each stacked leaf once and fills it block
    by block: the same numbers as drawing every block's sub-layer in turn
    and stacking them."""
    tcfg = TCFG.get_smoke_config("jamba-1.5-large-398b")
    got = TT.init_blocks(torch.Generator().manual_seed(3), tcfg)
    gen = torch.Generator().manual_seed(3)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    for i, spec in enumerate(tcfg.pattern):
        want = stack([TT._init_sublayer(gen, tcfg, spec)
                      for _ in range(tcfg.num_blocks)])
        flat_g = jax.tree.leaves(jax.tree.map(lambda a: a.numpy(),
                                              got[f"sub{i}"]))
        flat_w = jax.tree.leaves(jax.tree.map(lambda a: a.numpy(), want))
        assert len(flat_g) == len(flat_w)
        for a, b in zip(flat_g, flat_w):
            np.testing.assert_array_equal(a, b)
    assert got["sub1"]["mlp"]["router"].dtype == torch.float32
    assert got["sub1"]["mlp"]["gate"].shape == (
        tcfg.num_blocks, tcfg.num_experts, tcfg.d_model, tcfg.d_ff)


def test_moe_param_bytes_of_moonshot():
    """The full moonshot config's parameters: 56,128,573,440 bytes in
    bf16 by its own shapes (router f32), the figure ``chip_smoke.py``
    checks on the card."""
    cfg = TCFG.get_config("moonshot-v1-16b-a3b")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    attn = d * cfg.num_heads * cfg.head_dim * 2 + \
        d * cfg.num_kv_heads * cfg.head_dim * 2
    per_layer = 2 * (attn + 3 * e * d * f + 2 * d) + 4 * d * e
    total = cfg.num_layers * per_layer + 2 * (2 * cfg.vocab_size * d + d)
    shapes = jax.eval_shape(lambda: JM.init_params(
        JCFG.get_config("moonshot-v1-16b-a3b"), jax.random.PRNGKey(0)))
    jax_bytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                    for a in jax.tree.leaves(shapes))
    assert jax_bytes == total
    assert abs(total - 56_128_573_440) <= 0.001 * 56_128_573_440
