"""The port's training substrate on the CPU: the counterparts of
``test_train.py`` (the schedule, a falling loss, microbatches against the
full batch, the int8 round trip, error feedback, ``pod_compression``,
``global_norm``), one AdamW update and the int8 payloads against JAX's,
a train step against JAX's, and the synthetic LM batches.

Tolerances: ``warmup_cosine`` rtol 1e-6 at JAX's five steps; an AdamW
update 1e-6 relative (f32; ``pow``/``cos`` may part by an ulp); the
microbatch check JAX's atol 3e-5 / rtol 3e-3; int8 payloads and scales
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.data.synthetic import config_for as j_config_for
from repro.data.synthetic import make_batch as j_make_batch
from repro.models import model as JM
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train.compression import quantize_int8 as j_quantize
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import warmup_cosine as j_warmup_cosine
from repro_torch import configs as TCFG
from repro_torch.data.synthetic import (SyntheticConfig, batch_iterator,
                                        config_for, make_batch)
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                               adamw_update, init_train_state,
                               make_train_step, warmup_cosine)
from repro_torch.train.compression import (dequantize_int8,
                                           ef_compress_tree, quantize_int8)
from repro_torch.train.optimizer import global_norm
from repro_torch.tree import tree_leaves


def _state(arch, tcfg):
    cfg = TCFG.get_smoke_config(arch)
    jparams = JM.init_params(JCFG.get_smoke_config(arch),
                             jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, init_train_state(cfg, tcfg, params=params)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_warmup_cosine_shape_and_jax_values():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    jcfg = JAdamW(peak_lr=1.0, warmup_steps=10, total_steps=100,
                  min_lr_frac=0.1)
    steps = (0, 5, 10, 55, 100)
    lrs = [float(warmup_cosine(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    assert lrs[0] == 0.0
    np.testing.assert_allclose(lrs[1], 0.5, rtol=1e-6)
    np.testing.assert_allclose(lrs[2], 1.0, rtol=1e-6)
    assert 0.1 < lrs[3] < 1.0
    np.testing.assert_allclose(lrs[4], 0.1, rtol=1e-5)
    want = [float(j_warmup_cosine(jcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


def test_loss_decreases_on_synthetic():
    cfg = TCFG.get_smoke_config("qwen3-0.6b")
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-2, warmup_steps=5,
                                       total_steps=60))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, tcfg)
    scfg = config_for(cfg, batch=8, seq_len=32)
    losses = []
    for i in range(25):
        state, m = step(state, make_batch(scfg, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.7 * losses[0]
    assert np.isfinite(losses).all()


def test_microbatch_accumulation_matches_full_batch():
    cfg = TCFG.get_smoke_config("qwen1.5-0.5b")
    batch = make_batch(config_for(cfg, batch=8, seq_len=16), 0, device="cpu")
    base = TrainConfig(opt=AdamWConfig(peak_lr=1e-3))
    acc = TrainConfig(opt=AdamWConfig(peak_lr=1e-3), microbatches=4)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    s1 = init_train_state(cfg, base, gen(), device="cpu")
    s2 = init_train_state(cfg, acc, gen(), device="cpu")
    s1, m1 = make_train_step(cfg, base)(s1, batch)
    s2, m2 = make_train_step(cfg, acc)(s2, batch)
    assert set(m1) == {"loss", "lr", "grad_norm", "xent", "moe_aux",
                       "perplexity"}
    assert set(m2) == {"loss", "lr", "grad_norm"}
    for x, y in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=3e-5, rtol=3e-3)


def test_microbatch_step_matches_jax():
    """Two microbatches accumulated in f32, then AdamW: the port's step
    against JAX's on the same parameters and batch."""
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3), microbatches=2)
    cfg, state = _state("qwen3-0.6b", tcfg)
    jcfg = JCFG.get_smoke_config("qwen3-0.6b")
    jtcfg = JTrainConfig(opt=JAdamW(peak_lr=1e-3), microbatches=2)
    jstate = j_init_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    batch = j_make_batch(j_config_for(jcfg, 4, 16), 0)
    jstate, jm = j_make_step(jcfg, jtcfg)(jstate, batch)
    state, m = make_train_step(cfg, tcfg)(state, _torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for x, y in zip(tree_leaves(state.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                   rtol=1e-4)


def test_adamw_update_matches_jax():
    """One update from the same params, grads and (non-zero) state."""
    rng = np.random.default_rng(3)
    shapes = {"a": (37,), "b": {"c": (5, 7), "d": (3, 2, 4)}}

    def tree(fn):
        return {"a": fn(shapes["a"]),
                "b": {k: fn(v) for k, v in shapes["b"].items()}}

    r = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p, g, m = tree(r), tree(r), tree(r)
    v = tree(lambda s: np.abs(r(s)))
    jcfg = JAdamW(peak_lr=3e-3, warmup_steps=4, total_steps=20)
    cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=4, total_steps=20)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    to_t = lambda t: {"a": torch.from_numpy(t["a"]),  # noqa: E731
                      "b": {k: torch.from_numpy(x)
                            for k, x in t["b"].items()}}
    jstate = j_adamw_init(to_j(p))._replace(step=jnp.int32(6), m=to_j(m),
                                            v=to_j(v))
    state = adamw_init(to_t(p))._replace(
        step=torch.tensor(6, dtype=torch.int32), m=to_t(m), v=to_t(v))
    jp, js, jmet = j_adamw_update(jcfg, to_j(p), to_j(g), jstate)
    tp, ts, tmet = adamw_update(cfg, to_t(p), to_t(g), state)
    assert int(ts.step) == int(js.step) == 7
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=1e-9)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-6)


def test_adamw_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = adamw_init(p)
    assert state.m["w"].dtype == torch.float32
    newp, news, _ = adamw_update(AdamWConfig(), p,
                                 {"w": torch.full((4, 4), 0.5)}, state)
    assert newp["w"].dtype == torch.bfloat16
    assert news.v["w"].dtype == torch.float32
    assert torch.equal(p["w"], torch.ones((4, 4), dtype=torch.bfloat16))


def test_train_step_matches_jax():
    """Three steps of the port's train step against JAX's from the same
    parameters on JAX's batches: losses, grad norms and parameters."""
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=5e-3, warmup_steps=2,
                                       total_steps=10))
    cfg, state = _state("falcon-mamba-7b", tcfg)
    jcfg = JCFG.get_smoke_config("falcon-mamba-7b")
    jtcfg = JTrainConfig(opt=JAdamW(peak_lr=5e-3, warmup_steps=2,
                                    total_steps=10))
    jstate = j_init_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_step(jcfg, jtcfg))
    step = make_train_step(cfg, tcfg)
    scfg = j_config_for(jcfg, 2, 32)
    for s in range(3):
        batch = j_make_batch(scfg, s)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
        for k in ("loss", "xent", "perplexity"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    for x, y in zip(tree_leaves(state.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=1e-3)


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32)) * 10
    q, s, n = quantize_int8(x)
    back = dequantize_int8(q, s, n, x.shape)
    # block-wise max/127 quantization: error <= scale/2 per element
    per_block_err = (back - x).abs().numpy()
    bound = np.repeat(s.numpy(), 256)[:1000] * 0.5 + 1e-7
    assert (per_block_err <= bound).all()


@pytest.mark.parametrize("shape,scale", [((1000,), 10.0), ((7, 300), 1.0),
                                         ((256,), 1e-3), ((3, 5, 40), 1e4)])
def test_quantize_payloads_equal_jax(shape, scale):
    """Round half to even, clip to +-127, 256-element blocks: the int8
    payloads and the f32 scales are JAX's exactly."""
    x = (np.random.default_rng(2).normal(size=shape) * scale).astype(
        np.float32)
    x.reshape(-1)[:4] = [0.5, -0.5, 2.5, 0.0]       # ties and a zero
    q, s, n = quantize_int8(torch.from_numpy(x))
    jq, js, jn = j_quantize(jnp.asarray(x))
    assert n == jn
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


def test_error_feedback_is_unbiased_over_rounds():
    """Sum of EF wire messages converges to the sum of true gradients."""
    rng = np.random.default_rng(1)
    err = {"w": torch.zeros((300,))}
    total_wire = np.zeros(300, np.float32)
    total_true = np.zeros(300, np.float32)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(300,)).astype(
            np.float32))}
        wire, err = ef_compress_tree(g, err)
        total_wire += wire["w"].numpy()
        total_true += g["w"].numpy()
    # residual is bounded by one round's quantization error, so the
    # accumulated relative error vanishes
    resid = np.abs(total_wire + err["w"].numpy() - total_true)
    assert resid.max() < 1e-3


def test_pod_compression_trains():
    cfg = TCFG.get_smoke_config("qwen1.5-0.5b")
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=5e-3, warmup_steps=2,
                                       total_steps=30),
                       pod_compression=True)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert state.ef_error is not None
    step = make_train_step(cfg, tcfg)
    scfg = config_for(cfg, batch=4, seq_len=16)
    losses = []
    for i in range(15):
        state, m = step(state, make_batch(scfg, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state.ef_error))


def test_grad_norm_metric():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    np.testing.assert_allclose(float(global_norm(t)), 5.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-large",
                                  "llava-next-34b"])
def test_synthetic_batches_keep_jax_structure(arch):
    """A pure function of (seed, step); next-token targets; the period-7
    pattern on ~75% of positions; JAX's shapes and dtypes, with
    ``vision_embeds`` for the vision prefix."""
    cfg = TCFG.get_smoke_config(arch)
    scfg = config_for(cfg, batch=8, seq_len=64)
    jb = j_make_batch(j_config_for(JCFG.get_smoke_config(arch), 8, 64), 3)
    b = make_batch(scfg, 3, device="cpu")
    assert set(b) == set(jb)
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape, k
        assert str(b[k].dtype).split(".")[1] == str(jb[k].dtype), k
    again = make_batch(scfg, 3, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    other = make_batch(scfg, 4, device="cpu")
    assert not torch.equal(b["tokens"], other["tokens"])
    assert not torch.equal(make_batch(scfg, 3, seed=1, device="cpu")[
        "tokens"], b["tokens"])
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    toks = torch.cat([b["tokens"], b["targets"][:, -1:]], dim=1)
    # position t carries the sequence's (offset + t) % 7 where structured
    pos = torch.arange(toks.shape[1]).reshape(1, -1, *([1] * (toks.ndim - 2)))
    hits = (toks - pos) % 7
    frac = max(float((hits == o).float().mean()) for o in range(7))
    assert 0.0 < frac                         # some sequence's offset
    per_seq = [max(float((hits[i] == o).float().mean()) for o in range(7))
               for i in range(toks.shape[0])]
    assert 0.65 < np.mean(per_seq) < 0.85
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


def test_batch_iterator_counts_steps():
    scfg = SyntheticConfig(batch=2, seq_len=8, vocab_size=50)
    it = batch_iterator(scfg, start_step=5, device="cpu")
    for want in (5, 6, 7):
        step, batch = next(it)
        assert step == want
        assert torch.equal(batch["tokens"],
                           make_batch(scfg, want, device="cpu")["tokens"])


def test_two_gradient_runs_give_equal_bits():
    """Every gradient leaf, the embedding's included, is summed in a fixed
    order: two runs on the same batch give the same bits (an indexed
    lookup's ``index_put_`` backward did not on the CPU)."""
    from repro_torch.models import model as TM
    from repro_torch.train.step import loss_and_grads
    cfg = TCFG.get_smoke_config("qwen3-0.6b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = make_batch(config_for(cfg, 8, 128), 0, device="cpu")
    runs = [loss_and_grads(params, cfg, batch, remat="none")
            for _ in range(3)]
    for other in runs[1:]:
        for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(other[2])):
            assert torch.equal(a, b)
