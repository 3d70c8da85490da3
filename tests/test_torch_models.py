"""The port's LM modules against the JAX package on the CPU: configs,
layers, the attention and Mamba sub-layers (prefill and decode), the whole
model's ``prefill`` and ``decode_step`` on three smoke configs, the
decode-equals-forward invariant, and the parameter converter.

Inputs are made with NumPy from a seed; weights are JAX's ``init_params``
carried over by ``params_from_jax``.  Tolerances: 1e-5 for the attention
sub-layers and Mamba decode (same algorithm, f32), 1e-4 for ``mamba_block``
(the port scans sequentially, JAX by chunked associative scan:
``test_kernels.py``'s oracle-vs-assoc-scan tolerance) and for whole
models, and ``test_models.py``'s 5e-4/1e-3 for decode == forward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import config as JC
from repro_torch import configs as TCFG
from repro_torch.models import attention as TA
from repro_torch.models import config as TC
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.convert import (cache_from_jax, params_from_jax,
                                        to_numpy)

# test_models.py's FAMILIES other than hybrid-moe, built from the port's
# own config module (the field values are the same)
FAMILIES = {
    "dense+bias+qknorm": dict(
        name="d", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=97, qkv_bias=True, qk_norm=True,
        dtype="float32"),
    "swa": dict(
        name="s", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=97, sliding_window=5,
        dtype="float32"),
    "mamba": dict(
        name="mm", num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=97, ssm_state=8, dtype="float32"),
}
ATTN_FAMILIES = ["dense+bias+qknorm", "swa"]
SLICE_ARCHS = ["qwen3-0.6b", "h2o-danube-1.8b", "falcon-mamba-7b"]


def _cfgs(family):
    kw = dict(FAMILIES[family])
    if family == "mamba":
        return (JC.ModelConfig(pattern=JC.mamba_pattern(), **kw),
                TC.ModelConfig(pattern=TC.mamba_pattern(), **kw))
    return JC.ModelConfig(**kw), TC.ModelConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_configs_equal_jax(arch):
    for jget, tget in ((JCFG.get_config, TCFG.get_config),
                       (JCFG.get_smoke_config, TCFG.get_smoke_config)):
        j, t = jget(arch), tget(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()


@pytest.mark.parametrize("arch", TCFG.MOE_ARCH_IDS)
def test_moe_configs_wait_for_their_slice(arch):
    assert arch in JCFG.ARCH_IDS
    with pytest.raises(NotImplementedError, match="MoE"):
        TCFG.get_config(arch)


def test_moe_pattern_raises_in_the_model():
    cfg = TC.ModelConfig(name="h", num_layers=8, d_model=32, num_heads=2,
                         num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=11,
                         pattern=TC.jamba_pattern(), num_experts=2,
                         num_experts_per_tok=1, ssm_state=4,
                         dtype="float32")
    with pytest.raises(NotImplementedError, match="MoE"):
        TM.init_params(cfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 1e-6)
    pos = np.array([[0, 1, 7, 300, 2047]], np.int32)
    for theta in (1e4, 1e6):
        ts, tc = TL.rope(_t(pos), 16, theta)
        js, jc = JL.rope(jnp.asarray(pos), 16, theta)
        _close(ts, js, 1e-5)
        _close(tc, jc, 1e-5)
        _close(TL.apply_rope(_t(x[:1]), ts, tc),
               JL.apply_rope(jnp.asarray(x[:1]), js, jc), 1e-5)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                      ("down", (24, 16)))}
    _close(TL.mlp({k: _t(v) for k, v in w.items()}, _t(x)),
           JL.mlp({k: jnp.asarray(v) for k, v in w.items()},
                  jnp.asarray(x)), 1e-5)


# ---------------------------------------------------------------------------
# sub-layers
# ---------------------------------------------------------------------------
def _sub_params(family, jcfg, seed=0):
    key = jax.random.PRNGKey(seed)
    if family == "mamba":
        p = JS.init_mamba(key, jcfg, jnp.float32)
    else:
        p = JA.init_attention(key, jcfg, jnp.float32)
        if jcfg.qkv_bias:       # init is zero: make the bias path count
            for k in ("bq", "bk", "bv"):
                p[k] = jax.random.normal(jax.random.fold_in(key, len(k)),
                                         p[k].shape) * 0.1
    return p, {k: _t(v) for k, v in _np(p).items()}


@pytest.mark.parametrize("family", ATTN_FAMILIES)
def test_attention_block_matches_jax(family):
    jcfg, tcfg = _cfgs(family)
    jp, tp = _sub_params(family, jcfg)
    x = np.random.default_rng(1).standard_normal((2, 12, 64)).astype(
        np.float32)
    pos = np.arange(12)[None, :]
    jy, (jk, jv) = JA.attention_block(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos))
    ty, (tk, tv) = TA.attention_block(tp, tcfg, _t(x), _t(pos))
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("family", ATTN_FAMILIES)
def test_attention_decode_block_matches_jax(family):
    jcfg, tcfg = _cfgs(family)
    jp, tp = _sub_params(family, jcfg)
    rng = np.random.default_rng(2)
    smax = min(16, jcfg.sliding_window or 16)
    shape = (3, smax, jcfg.num_kv_heads, jcfg.head_dim)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    position = np.array([0, 4, 13], np.int32)       # 13 wraps an SWA ring
    jy, jc = JA.attention_decode_block(
        jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                    cache.items()}, jnp.asarray(position))
    ty, tc = TA.attention_decode_block(
        tp, tcfg, _t(x), {k: _t(v.copy()) for k, v in cache.items()},
        _t(position))
    _close(ty, jy, 1e-5)
    for k in ("k", "v"):
        _close(tc[k], jc[k], 1e-5)


def test_mamba_block_matches_jax():
    jcfg, tcfg = _cfgs("mamba")
    jp, tp = _sub_params("mamba", jcfg)
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    _close(TS.mamba_block(tp, tcfg, _t(x)),
           JS.mamba_block(jp, jcfg, jnp.asarray(x), chunk=8), 1e-4)


def test_mamba_decode_block_matches_jax():
    jcfg, tcfg = _cfgs("mamba")
    jp, tp = _sub_params("mamba", jcfg)
    rng = np.random.default_rng(4)
    cache = {"conv": rng.standard_normal(
        (3, jcfg.ssm_conv - 1, jcfg.d_inner)).astype(np.float32),
        "h": rng.standard_normal((3, jcfg.d_inner, jcfg.ssm_state)).astype(
            np.float32)}
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    jy, jc = JS.mamba_decode_block(jp, jcfg, jnp.asarray(x),
                                   {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    ty, tc = TS.mamba_decode_block(tp, tcfg, _t(x),
                                   {k: _t(v.copy()) for k, v in
                                    cache.items()})
    _close(ty, jy, 1e-5)
    for k in ("conv", "h"):
        _close(tc[k], jc[k], 1e-5)


# ---------------------------------------------------------------------------
# the slice: prefill and decode_step on the smoke configs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _smoke(arch):
    jcfg = JCFG.get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = TCFG.get_smoke_config(arch)
    return jcfg, jp, tcfg, params_from_jax(_np(jp), tcfg, device="cpu")


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_prefill_matches_jax(arch):
    jcfg, jp, tcfg, tp = _smoke(arch)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    jl, jkv = JM.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tkv = TM.prefill(tp, tcfg, _t(toks).long())
    assert tl.shape == (2, 1, tcfg.vocab_size)
    _close(tl, jl, 1e-4)
    assert len(tkv) == len(jkv) == int(tcfg.has_attention)
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        assert tk.shape == (tcfg.num_blocks, 2, 20, tcfg.num_kv_heads,
                            tcfg.head_dim)
        _close(tk, jk, 1e-4)
        _close(tv, jv, 1e-4)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_decode_step_matches_jax(arch):
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
        _close(tl, jl, 1e-4)
    for got, want in zip(jax.tree.leaves(to_numpy(tc)),
                         jax.tree.leaves(jc)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def _roundtrip(tcfg, toks, params):
    hidden, _ = TM.forward(params, tcfg, toks)
    full = TM.compute_logits(params, tcfg, hidden)
    b, s = toks.shape[:2]
    cache = TM.init_cache(tcfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = TM.decode_step(params, tcfg, toks[:, t:t + 1], cache,
                                   torch.full((b,), t, dtype=torch.int32))
        outs.append(lg)
    return full, torch.cat(outs, dim=1)


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["musicgen"])
def test_decode_matches_forward(family):
    """test_models.py's invariant, on the port's own random init."""
    if family == "musicgen":
        tcfg = TC.ModelConfig(name="mg", num_layers=2, d_model=64,
                              num_heads=4, num_kv_heads=4, head_dim=16,
                              d_ff=128, vocab_size=33, num_codebooks=4,
                              dtype="float32")
        shape = (2, 10, 4)
    else:
        tcfg = _cfgs(family)[1]
        shape = (2, 12)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, shape))
    full, dec = _roundtrip(tcfg, toks, params)
    assert full.shape == dec.shape
    np.testing.assert_allclose(full.numpy(), dec.numpy(), atol=5e-4,
                               rtol=1e-3)


def test_vlm_stub_prepends_vision():
    tcfg = TCFG.get_smoke_config("llava-next-34b")
    params = TM.init_params(tcfg, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 10))
    vis = torch.randn(2, tcfg.vision_tokens, tcfg.d_model)
    hidden, _ = TM.forward(params, tcfg, toks, vision_embeds=vis)
    assert hidden.shape == (2, 10 + tcfg.vision_tokens, tcfg.d_model)
    logits, kv = TM.prefill(params, tcfg, toks, vision_embeds=vis)
    assert torch.isfinite(logits).all()
    assert kv[0][0].shape[2] == 10 + tcfg.vision_tokens


# ---------------------------------------------------------------------------
# parameters: the converter and the port's own init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "musicgen-large"])
def test_converter_round_trip_is_exact(arch):
    """bf16 leaves cross as bit patterns; A_log and D stay f32."""
    jcfg = dataclasses.replace(JCFG.get_smoke_config(arch),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG.get_smoke_config(arch),
                               dtype="bfloat16")
    np_params = _np(JM.init_params(jcfg, jax.random.PRNGKey(1)))
    back = to_numpy(params_from_jax(np_params, tcfg, device="cpu"))
    jl, jt = jax.tree.flatten(np_params)
    bl, bt = jax.tree.flatten(back)
    assert jt == bt
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    if tcfg.has_mamba:
        mixer = params_from_jax(np_params, tcfg, device="cpu")[
            "blocks"]["sub0"]["mixer"]
        assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
        assert mixer["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_init_params_has_jax_layout(arch):
    jcfg, tcfg = JCFG.get_smoke_config(arch), TCFG.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    params = TM.init_params(tcfg, device="cpu")
    js, jt = jax.tree.flatten(shapes)
    ts, tt = jax.tree.flatten(to_numpy(params))
    assert jt == tt
    for a, b in zip(js, ts):
        assert tuple(a.shape) == b.shape and str(a.dtype) == str(b.dtype)


def test_entry_points_default_to_the_card():
    cfg = TCFG.get_smoke_config("qwen3-0.6b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_cache(cfg, 1, 8)
