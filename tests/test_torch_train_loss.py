"""The port's training loss and its gradients against JAX's on the CPU: the
counterpart of ``test_arch_smoke.py::test_smoke_forward_and_grad`` for all
ten smoke configs (MoE, musicgen's codebooks and llava's vision prefix
among them), ``loss_mask``, and the four remat policies.

The same parameters (JAX's ``init_params`` carried over by
``params_from_jax``) and the same NumPy batch go through ``jax.grad`` of
JAX's ``loss_fn`` and autograd of the port's.  Tolerances: loss and
metrics rtol 1e-5, every gradient leaf atol 1e-4 / rtol 1e-3 (f32, the
attention and scan summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.models import model as JM
from repro_torch import configs as TCFG
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_flatten, tree_leaves


def _batch(cfg, seed=1, b=2, s=16, mask=False):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.uniform(size=shape) < 0.6).astype(
            np.float32)
    return batch


def _setup(arch, **kw):
    jcfg, tcfg = JCFG.get_smoke_config(arch), TCFG.get_smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    batch = _batch(jcfg, **kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(arch)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch), has_aux=True)(jparams)
    loss, met, grads = loss_and_grads(tparams, tcfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(met) == set(jmet) == {"xent", "moe_aux", "perplexity"}
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    paths, leaves, _ = tree_flatten(grads)
    jleaves = jax.tree.leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for path, g, w in zip(paths, leaves, jleaves):
        assert g.dtype == tree_leaves(tparams)[paths.index(path)].dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-3, err_msg=f"{arch}: {path}")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-large"])
def test_loss_mask_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(arch, mask=True)
    jloss, _ = JM.loss_fn(jparams, jcfg, jbatch)
    loss, _, _ = loss_and_grads(tparams, tcfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_mixer_weights_get_jax_gradients(arch):
    """The gradient reaches the mixers' input projections (``wq``,
    ``in_proj``) through the kernels' plain versions, non-zero and equal
    to JAX's: what the card must also give (``test_torch_cuda.py``)."""
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(arch)
    jgrads = jax.grad(lambda p: JM.loss_fn(p, jcfg, jbatch)[0])(jparams)
    _, _, grads = loss_and_grads(tparams, tcfg, tbatch)
    key = "wq" if arch == "qwen3-0.6b" else "in_proj"
    g = grads["blocks"]["sub0"]["mixer"][key]
    w = np.asarray(jgrads["blocks"]["sub0"]["mixer"][key])
    assert float(g.abs().max()) > 0
    np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_remat_policies_give_equal_gradients(arch):
    _, tcfg, _, tparams, _, tbatch = _setup(arch)
    base = loss_and_grads(tparams, tcfg, tbatch, remat="none")
    for remat in ("nothing", "dots", "dots_no_batch"):
        loss, met, grads = loss_and_grads(tparams, tcfg, tbatch, remat=remat)
        assert torch.equal(loss, base[0]), remat
        for g, w in zip(tree_leaves(grads), tree_leaves(base[2])):
            assert torch.equal(g, w), remat


def test_remat_name_is_checked():
    _, tcfg, _, tparams, _, tbatch = _setup("qwen3-0.6b")
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(tparams, tcfg, tbatch, remat="everything")
