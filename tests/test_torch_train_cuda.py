"""Training on a CUDA device: the two backward kernels against autograd of
their plain versions, their determinism, the forward kernel's output with
and without its log-sum-exp, gradients through ``models.model.forward``
reaching ``wq`` and ``in_proj``, and the kernels' launch counts on each
path.

Every test here needs the card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: f32 gradients atol 1e-4 (rtol 1e-4); bf16 flash gradients a
max abs error of 0.02 x max|ref| per output; the scan's 1e-3 x max|ref|.
"""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs as CFG
from repro_torch.kernels.flash_attention import (HEAD_DIMS, attention,
                                                 attention_ref, bwd_design,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.selective_scan import (STATE_SIZES, selective_scan,
                                                selective_scan_bwd,
                                                selective_scan_ref)
from repro_torch.models import model as M
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_flatten, tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flash(cuda, b, sq, skv, h, kh, hd, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)  # noqa
    return r(b, sq, h, hd), r(b, skv, kh, hd), r(b, skv, kh, hd), \
        r(b, sq, h, hd)


def _plain_grads(fn, inputs, dout):
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*ts).backward(dout)
    return [t.grad for t in ts]


def _close(got, want, dtype):
    for g, w in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            err = float((g.float() - w.float()).abs().max())
            assert err <= 0.02 * float(w.float().abs().max())


# (B, Sq, Skv, H, KH, hd, window), causal: every head dim (16, 32 and 80
# pad to the tensor-core kernel's 64 or 128 columns), G = 1, 2, 4 and 8, S
# not a multiple of the 64- or 128-row tiles, Sq < Skv
CASES = [(1, 130, 130, 4, 2, hd, None) for hd in HEAD_DIMS] + [
    (2, 200, 200, 4, 1, 64, 48), (1, 96, 160, 2, 2, 64, None),
    (2, 256, 256, 8, 2, 128, None), (1, 300, 300, 2, 1, 32, 7),
    (1, 190, 190, 16, 2, 80, None), (1, 100, 230, 4, 2, 128, None),
    (2, 70, 70, 2, 2, 16, None), (1, 129, 200, 8, 1, 32, 40)]
NON_CAUSAL = [(2, 130, 130, 4, 4, 16, None), (1, 70, 200, 8, 1, 128, None),
              (1, 257, 257, 4, 2, 64, 100), (1, 64, 64, 2, 1, 80, None)]


def _check_flash_backward(cuda, dtype, b, sq, skv, h, kh, hd, window,
                          causal):
    """The kernel twice (equal bits, two launches) against autograd of the
    plain version; the forward's output equal with and without its lse."""
    q, k, v, do = _flash(cuda, b, sq, skv, h, kh, hd, dtype)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = _plain_grads(lambda *t: attention_ref(*t, **kw), (q, k, v), do)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kh,hd,window", CASES)
def test_flash_backward_matches_plain_version(cuda, dtype, b, sq, skv, h, kh,
                                              hd, window):
    _check_flash_backward(cuda, dtype, b, sq, skv, h, kh, hd, window, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kh,hd,window", NON_CAUSAL)
def test_flash_backward_non_causal_matches_plain_version(
        cuda, dtype, b, sq, skv, h, kh, hd, window):
    _check_flash_backward(cuda, dtype, b, sq, skv, h, kh, hd, window, False)


def test_flash_backward_bf16_runs_on_tensor_cores(cuda):
    """bf16 names the wgmma design at every head dim and raises on a
    tensor the 16-byte copies cannot take (no fallback to the f32 tiles)."""
    assert {bwd_design(torch.bfloat16, hd) for hd in HEAD_DIMS} == {
        "wgmma-bf16"}
    q, k, v, do = _flash(cuda, 1, 64, 64, 2, 1, 64, torch.bfloat16)
    out, lse = flash_attention(q, k, v, return_lse=True)
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    odd = odd.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd(odd, k, v, out, do, lse)


def test_flash_lse_is_the_rows_logsumexp(cuda):
    b, s, h, kh, hd = 2, 150, 4, 2, 64
    q, k, v, _ = _flash(cuda, b, s, s, h, kh, hd, torch.float32)
    _, lse = flash_attention(q, k, v, window=20, return_lse=True)
    g = h // kh
    sc = torch.einsum("bqkgd,bckd->bqkgc", q.reshape(b, s, kh, g, hd),
                      k) / math.sqrt(hd)
    pos = torch.arange(s, device=cuda)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 20)
    sc = torch.where(mask[None, :, None, None, :], sc, -1e30)
    want = torch.logsumexp(sc, -1).reshape(b, s, h).permute(0, 2, 1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


# S not a multiple of the 32-step chunk or the 8-step round, S = 1, di not
# a multiple of the 32-channel block
@pytest.mark.parametrize("n", STATE_SIZES)
@pytest.mark.parametrize("bsz,s,di", [(2, 100, 96), (1, 257, 200),
                                      (2, 16, 33), (2, 1, 40), (1, 67, 64),
                                      (2, 75, 70)])
def test_scan_backward_matches_plain_version(cuda, n, bsz, s, di):
    gen = torch.Generator(device=cuda).manual_seed(n + s)
    r = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa
    args = [F.softplus(r(bsz, s, di)), r(bsz, s, di), r(bsz, s, n),
            r(bsz, s, n), -torch.exp(r(di, n)), r(di)]
    dy = r(bsz, s, di)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(*args, dy)
    again = selective_scan_bwd(*args, dy)
    torch.cuda.synchronize()
    assert selective_scan_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = _plain_grads(selective_scan_ref, args, dy)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "D"), got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()), name


def test_autograd_route_launches_the_backward_kernels(cuda):
    q, k, v, do = _flash(cuda, 1, 64, 64, 2, 1, 32, torch.float32)
    q.requires_grad_(True)
    counts = (flash_attention.launches, flash_attention_bwd.launches)
    attention(q, k, v).backward(do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    with torch.no_grad():
        attention(q, k, v)
    assert flash_attention_bwd.launches == counts[1] + 1
    # no fallback: a shape the kernels do not take raises
    bad = torch.zeros((1, 8, 2, 24), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        attention(bad, bad.detach(), bad.detach())
    x = torch.zeros((1, 8, 4), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="state size"):
        selective_scan(x, x.detach(), torch.zeros((1, 8, 5), device=cuda),
                       torch.zeros((1, 8, 5), device=cuda),
                       torch.zeros((4, 5), device=cuda),
                       torch.zeros(4, device=cuda))


@pytest.mark.parametrize("arch,key", [("qwen3-0.6b", "wq"),
                                      ("falcon-mamba-7b", "in_proj")])
def test_forward_gradients_reach_the_mixers(cuda, arch, key):
    """The repaired fault: a backward through ``forward`` on the card gives
    ``wq`` / ``in_proj`` a non-zero gradient equal to the CPU's."""
    cfg = CFG.get_smoke_config(arch)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    grads = []
    for device in ("cpu", cuda):
        params = tree_map(lambda t: t.to(device, copy=True), cpu)
        w = params["blocks"]["sub0"]["mixer"][key].requires_grad_(True)
        hidden, _, _ = M.forward(params, cfg, toks.to(device))
        hidden.float().square().mean().backward()
        grads.append(w.grad.cpu())
    assert float(grads[1].abs().max()) > 0
    torch.testing.assert_close(grads[1], grads[0], atol=1e-4, rtol=1e-3)


def test_no_grad_paths_keep_their_launches(cuda):
    cfg = CFG.get_smoke_config("jamba-1.5-large-398b")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda)
    n_attn = sum(sp.mixer == "attn" for sp in cfg.pattern) * cfg.num_blocks
    n_ssm = sum(sp.mixer != "attn" for sp in cfg.pattern) * cfg.num_blocks
    before = [f.launches for f in (flash_attention, flash_attention_bwd,
                                   selective_scan, selective_scan_bwd)]
    M.prefill(params, cfg, toks)
    after = [f.launches for f in (flash_attention, flash_attention_bwd,
                                  selective_scan, selective_scan_bwd)]
    assert [a - b for a, b in zip(after, before)] == [n_attn, 0, n_ssm, 0]


@pytest.mark.parametrize("remat,factor", [("none", 1), ("nothing", 2),
                                          ("dots", 2)])
def test_training_launch_counts(cuda, remat, factor):
    cfg = CFG.get_smoke_config("jamba-1.5-large-398b")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    n_attn = sum(sp.mixer == "attn" for sp in cfg.pattern) * cfg.num_blocks
    n_ssm = sum(sp.mixer != "attn" for sp in cfg.pattern) * cfg.num_blocks
    fns = (flash_attention, flash_attention_bwd, selective_scan,
           selective_scan_bwd)
    before = [f.launches for f in fns]
    _, _, grads = loss_and_grads(params, cfg, batch, remat=remat)
    after = [f.launches for f in fns]
    assert [a - b for a, b in zip(after, before)] == [
        factor * n_attn, n_attn, factor * n_ssm, n_ssm]
    for path, g in zip(*tree_flatten(grads)[:2]):
        assert bool(torch.isfinite(g).all()), path


def test_train_steps_card_equal_cpu(cuda):
    cfg = CFG.get_smoke_config("qwen3-0.6b")
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                       total_steps=5))
    cpu = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gpu = init_train_state(cfg, tcfg,
                           params=tree_map(lambda t: t.to(cuda), cpu.params))
    step = make_train_step(cfg, tcfg)
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):
        toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        cpu, mc = step(cpu, batch)
        gpu, mg = step(gpu, {k: v.to(cuda) for k, v in batch.items()})
        assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-4
    for a, b in zip(tree_flatten(cpu.params)[1], tree_flatten(gpu.params)[1]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=0)
