"""The port on a CUDA device: the hand-written kernels against their plain
versions, and the engine on the card against the engine on the CPU.

Every test here needs the card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core.engine import run_stats
from repro_torch.kernels.simstep import (row_index, simstep, simstep_ragged,
                                         simstep_ragged_ref, simstep_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tile(seed, v, k, device):
    """Drained slots, an all-idle row, a zero-capacity row and a row with
    more PEs than slots (the edge cases of test_simstep_parity)."""
    rng = np.random.default_rng(seed)
    rem = rng.uniform(0.0, 5000.0, (v, k)).astype(np.float32)
    rem[rng.uniform(size=(v, k)) < 0.15] = 0.0
    run = rng.uniform(size=(v, k)) < 0.7
    cap = rng.uniform(100.0, 2000.0, v).astype(np.float32)
    pes = rng.integers(1, 4, v).astype(np.float32)
    rows = rng.permutation(v)
    run[rows[0]] = False
    cap[rows[min(1, v - 1)]] = 0.0
    pes[rows[-1]] = k + rng.integers(1, 5)
    return [torch.from_numpy(a).to(device) for a in (rem, run, cap, pes)]


@pytest.mark.parametrize("v,k", [(8, 16), (13, 8), (3, 128), (32, 4),
                                 (50000, 10), (7, 33), (5, 0)])
def test_simstep_kernel_matches_plain_version(cuda, v, k):
    for seed in range(3):
        tile = _tile(seed, v, k, cuda)
        for policy in (0, 1):
            before = simstep.launches
            pol = torch.tensor(policy, dtype=torch.int32, device=cuda)
            r, d = simstep(*tile, pol)
            r_ref, d_ref = simstep_ref(*tile, pol)
            torch.cuda.synchronize()
            assert simstep.launches == before + (k > 0)
            assert torch.equal(r, r_ref) and torch.equal(d, d_ref)


def test_simstep_wrapper_rejects_bad_inputs(cuda):
    rem, run, cap, pes = _tile(0, 8, 16, cuda)
    with pytest.raises(TypeError):
        simstep(rem.double(), run, cap, pes, 0)
    with pytest.raises(ValueError):
        simstep(rem, run, cap[:4], pes, 0)
    with pytest.raises(ValueError):
        simstep(rem.t(), run.t(), cap, pes, 0)
    with pytest.raises(ValueError):
        simstep(rem, run.cpu(), cap, pes, 0)


def _ragged_tile(seed, lengths, device):
    """VM rows of the given lengths in a shuffled slot order, with runs of
    slots that belong to no row (vm -1 or V) between some of them, drained
    slots, an all-idle row, a zero-capacity row and a row with more PEs
    than slots.  Returns (index, [remaining, runnable, cap, pes])."""
    rng = np.random.default_rng(seed)
    v = len(lengths)
    vm = []
    for r in rng.permutation(v):
        if rng.uniform() < 0.3:
            vm += [int(rng.choice([-1, v]))] * int(rng.integers(1, 4))
        vm += [int(r)] * int(lengths[r])
    vm = np.asarray(vm + [-1], np.int32)
    c = vm.size
    rem = rng.uniform(0.0, 5000.0, c).astype(np.float32)
    rem[rng.uniform(size=c) < 0.15] = 0.0
    run = rng.uniform(size=c) < 0.7
    cap = rng.uniform(100.0, 2000.0, v).astype(np.float32)
    pes = rng.integers(1, 4, v).astype(np.float32)
    rows = rng.permutation(v)
    run[vm == rows[0]] = False
    cap[rows[min(1, v - 1)]] = 0.0
    pes[rows[-1]] = lengths[rows[-1]] + rng.integers(1, 5)
    index = row_index(torch.from_numpy(vm).to(device), v)
    return index, [torch.from_numpy(a).to(device)
                   for a in (rem, run, cap, pes)]


RAGGED = {  # row lengths
    "edges": [0, 1, 31, 32, 33, 64, 1024, 100_000],
    "short": list(np.random.default_rng(5).integers(0, 80, 300)),
    "uniform": [10] * 5000,
    "skewed": [20_000] + [6] * 4999,
}


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_simstep_ragged_kernel_matches_plain_version(cuda, case):
    """Bitwise, both policies, short and long rows; one launch a call."""
    for seed in range(3):
        index, (rem, run, cap, pes) = _ragged_tile(seed, RAGGED[case], cuda)
        for policy in (0, 1):
            before = simstep.launches
            pol = torch.tensor(policy, dtype=torch.int32, device=cuda)
            r, d = simstep_ragged(rem, run, index, cap, pes, pol)
            r_ref, d_ref = simstep_ragged_ref(rem, run, index, cap, pes, pol)
            torch.cuda.synchronize()
            assert simstep.launches == before + 1
            assert torch.equal(r, r_ref) and torch.equal(d, d_ref), (
                case, seed, policy)


def test_simstep_ragged_wrapper_rejects_bad_inputs(cuda):
    index, (rem, run, cap, pes) = _ragged_tile(0, RAGGED["edges"], cuda)
    strided = torch.empty(2 * rem.numel(), device=cuda)[::2]
    cpu_index = row_index(index.slot_row.cpu(), index.n_rows)
    for args, error in (
            ((rem.double(), run, index, cap, pes), TypeError),
            ((rem, run.to(torch.uint8), index, cap, pes), TypeError),
            ((rem[:-1], run, index, cap, pes), ValueError),
            ((rem, run, index, cap[:-1], pes), ValueError),
            ((rem, run.cpu(), index, cap, pes), ValueError),
            ((strided.copy_(rem), run, index, cap, pes), ValueError),
            ((rem, run, cpu_index, cap, pes), ValueError)):
        before = simstep.launches
        with pytest.raises(error):
            simstep_ragged(*args, 0)
        assert simstep.launches == before


@pytest.mark.parametrize("policy", [S.SPACE_SHARED, S.TIME_SHARED])
def test_engine_on_card_matches_cpu(cuda, policy):
    """The §5 quickstart (cut to 200 hosts) and a small heterogeneous
    scenario, run on the card and on the CPU."""
    def section5(dev):
        return S.make_datacenter(
            S.make_uniform_hosts(200, idle_w=100.0, peak_w=200.0,
                                 device=dev),
            B.build_fleet([B.VmSpec(count=50)], device=dev),
            B.build_waves(50, B.WaveSpec(waves=10), device=dev),
            task_policy=policy, reserve_pes=True, device=dev)

    def hetero(dev):
        rng = np.random.default_rng(3)
        owners = np.repeat(np.arange(6, dtype=np.int32),
                           rng.integers(0, 5, 6))
        return S.make_datacenter(
            S.make_hosts(rng.integers(1, 4, 4), [500.0, 1000.0] * 2,
                         4096.0, 1000.0, 1e6, idle_w=0.1, peak_w=0.5,
                         device=dev),
            S.make_vms(rng.integers(1, 3, 6), 500.0, 64.0, 1.0, 10.0,
                       device=dev),
            S.make_cloudlets(owners, np.round(rng.uniform(
                500, 8000, owners.size)).astype(np.float32), device=dev),
            vm_policy=policy, task_policy=policy, reserve_pes=False,
            device=dev)

    for build in (section5, hetero):
        gpu, gs = run_stats(build(cuda))
        cpu, cs = run_stats(build("cpu"))
        assert gs.n_events == cs.n_events
        for blk, name in (("cloudlets", "state"), ("vms", "host")):
            assert torch.equal(getattr(getattr(gpu, blk), name).cpu(),
                               getattr(getattr(cpu, blk), name))
        for a, b in ((gpu.cloudlets.finish_time, cpu.cloudlets.finish_time),
                     (gpu.hosts.energy_j, cpu.hosts.energy_j)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-3)


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_simstep_ragged_kernel_per_row_policy(cuda, case):
    """A task policy per row (lanes of a batch): bitwise, short and long
    rows, one launch a call; a policy of the wrong length raises."""
    for seed in range(3):
        index, (rem, run, cap, pes) = _ragged_tile(seed, RAGGED[case], cuda)
        pol = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 2, index.n_rows).astype(np.int32)).to(cuda)
        before = simstep.launches
        r, d = simstep_ragged(rem, run, index, cap, pes, pol)
        r_ref, d_ref = simstep_ragged_ref(rem, run, index, cap, pes, pol)
        torch.cuda.synchronize()
        assert simstep.launches == before + 1
        assert torch.equal(r, r_ref) and torch.equal(d, d_ref), (case, seed)
    with pytest.raises(ValueError):
        simstep_ragged(rem, run, index, cap, pes, pol[:-1])


def shared_hosts(seed, n_hosts, device):
    """benchmarks/bench_policies.py::bench_sweep's lanes with shared
    hosts: 4 VMs on every 1-PE host, PEs not reserved, 4 waves of a
    per-seed length.  Two VM classes of per-seed MIPS, each in one run
    of slots (so first fit places a run at a time): 2*H VMs of 768 MB,
    two to a 2 GB host, then 2*H of 256 MB in the 512 MB left.  A host's
    time-shared demand is a sum of unequal f32 terms, whose value
    depends on the order of the additions."""
    rng = np.random.default_rng(seed)
    half = 2 * n_hosts
    mips = np.repeat(np.round(rng.uniform(200.0, 1000.0, 2), 3), half)
    length = float(rng.integers(600, 1200) * 1000)
    return S.make_datacenter(
        S.make_uniform_hosts(n_hosts, ram=2048.0, idle_w=100.0,
                             peak_w=200.0, device=device),
        S.make_vms(np.ones(2 * half), mips, np.repeat([768.0, 256.0], half),
                   10.0, 1000.0, device=device),
        B.build_waves(2 * half, B.WaveSpec(waves=4, length_mi=length,
                                           period=600.0), device=device),
        reserve_pes=False, device=device)


def test_lanes_equal_single_runs_on_card(cuda):
    """4 seeds x the 2x2 grid of shared-host lanes in one run_grid: every
    lane equals its single run on the card, bit for bit, and the single
    runs equal the CPU's within the conformance tolerance."""
    from repro_torch.core import sweep
    from repro_torch.core.engine import run
    base = [shared_hosts(seed, 32, cuda) for seed in range(4)]
    vm_p, task_p = sweep.policy_grid(device=cuda)
    grid = sweep.run_grid(sweep.stack_scenarios(base), vm_p, task_p,
                          max_steps=4096)
    hosts = grid.vms.host[0, 0].cpu().numpy()
    assert (np.bincount(hosts, minlength=32) == 4).all()
    for p in range(4):
        for b, dc in enumerate(base):
            cell = dataclasses.replace(dc, vm_policy=vm_p[p],
                                       task_policy=task_p[p])
            single = run(cell, max_steps=4096)
            for name, a in _leaves(single):
                g = _leaf(grid, name)[p, b]
                assert torch.equal(g, a), (p, b, name)
            if b == 0:
                cpu = run(S.to_device(cell, "cpu"), max_steps=4096)
                np.testing.assert_allclose(
                    single.cloudlets.finish_time.cpu().numpy(),
                    cpu.cloudlets.finish_time.numpy(), rtol=0, atol=1e-3)


def _leaves(state, path=""):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", v


def _leaf(state, name):
    for part in name.split("."):
        state = getattr(state, part)
    return state


# ---------------------------------------------------------------------------
# the LM serving slice: flash attention and the selective scan
# ---------------------------------------------------------------------------
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py


def _flash_inputs(seed, b, sq, skv, h, kh, hd, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, sq, h, hd), (b, skv, kh, hd),
                          (b, skv, kh, hd))]


@pytest.mark.parametrize("sq,skv,h,kh,hd,window", [
    (96, 96, 2, 2, 64, None),          # ragged
    (256, 256, 8, 2, 64, None),        # GQA 4:1
    (128, 128, 4, 2, 128, 48),         # GQA 2:1, window 48
    (200, 200, 4, 2, 80, 48),          # hd 80 (h2o-danube)
    (96, 96, 8, 2, 32, None),          # hd 32
    (40, 40, 8, 2, 16, 8),             # hd 16 (smoke configs)
    (64, 128, 2, 2, 64, None),         # Sq < Skv
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, sq, skv, h, kh, hd,
                                            window, dtype):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    q, k, v = _flash_inputs(sq + hd, 2, sq, skv, h, kh, hd, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,skv,h,kh,hd,window", [
    (2, 200, 200, 4, 2, 128, None),    # Sq not a multiple of 128
    (1, 2047, 2047, 2, 1, 128, None),  # one row short of 16 tiles
    (2, 256, 256, 4, 2, 64, 70),       # window across a 64-key tile edge
    (1, 300, 300, 4, 4, 128, 130),     # window over two tiles, MHA
    (2, 192, 192, 8, 1, 128, None),    # GQA 8:1
    (2, 100, 300, 4, 2, 128, None),    # Sq < Skv, Sq not a multiple of 64
    (1, 77, 77, 4, 2, 16, None),       # each head dim ...
    (1, 130, 130, 4, 2, 32, 33),
    (2, 129, 129, 4, 2, 64, None),
    (1, 250, 250, 4, 2, 80, None),
    (2, 64, 64, 4, 2, 128, None),
    (1, 1, 1, 2, 1, 128, None),        # one query, one key
])
def test_flash_tensor_core_kernel_matches_plain_version(cuda, b, sq, skv, h,
                                                        kh, hd, window):
    """The bf16 design (wgmma on 128-row query tiles, 64-key K/V tiles)
    on its edges, against the plain version at the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import (attention_ref, design,
                                                     flash_attention)
    assert design(torch.bfloat16, hd) == "wgmma-bf16"
    q, k, v = _flash_inputs(sq + skv + hd, b, sq, skv, h, kh, hd,
                            torch.bfloat16, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(0, 1, 32, 32, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())             # hd 48
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :16].contiguous(), v[:, :16].contiguous())


def _scan_inputs(seed, b, s, di, n, device, zero_d=False, dt_scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=device)
    dt = torch.nn.functional.softplus(r(b, s, di)) * dt_scale
    d = torch.zeros(di, device=device) if zero_d else torch.ones(
        di, device=device)
    return [dt, r(b, s, di), r(b, s, n), r(b, s, n), -torch.exp(r(di, n)), d]


@pytest.mark.parametrize("b,s,di,n,zero_d,dt_scale", [
    (2, 100, 96, 4, False, 1.0),       # S, di off the chunk and block
    (1, 257, 256, 8, False, 1.0),
    (2, 64, 128, 16, False, 1.0),
    (2, 130, 200, 16, True, 1.0),      # zero D
    (1, 75, 64, 8, False, 1e-6),       # tiny dt
])
def test_scan_kernel_matches_plain_version(cuda, b, s, di, n, zero_d,
                                           dt_scale):
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_ref)
    args = _scan_inputs(s, b, s, di, n, cuda, zero_d, dt_scale)
    before = selective_scan.launches
    got = selective_scan(*args)
    want = selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b,s,di,n", [
    (2, 1, 64, 16),                    # S = 1
    (1, 33, 64, 16),                   # S one past the 32-step chunk
    (2, 100, 200, 16),                 # di not a multiple of 32 channels
    (1, 70, 48, 4),                    # N = 4, one lane a channel
    (2, 95, 72, 8),                    # N = 8, two lanes a channel
    (1, 40, 30, 16),                   # di not a multiple of 4: 4-byte copies
    (2, 300, 8192, 16),                # falcon-mamba-7b's width
])
def test_scan_lane_split_kernel_matches_plain_version(cuda, b, s, di, n):
    """The redesigned scan (N/4 lanes a channel, cp.async-staged chunks)
    on its edges, against the plain version at 2e-4."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_ref)
    args = _scan_inputs(s + di + n, b, s, di, n, cuda)
    before = selective_scan.launches
    got = selective_scan(*args)
    want = selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_scan_kernel_takes_unaligned_views(cuda):
    """Contiguous views that start off a 16-byte boundary go through the
    kernel's 4-byte copies."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_ref)
    def unaligned(t):
        view = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        return view.copy_(t)

    dt, x, bm, cm, a, d = _scan_inputs(5, 3, 50, 64, 16, cuda)
    dt, x, bm, cm = (unaligned(t) for t in (dt, x, bm, cm))
    assert x.is_contiguous() and x.data_ptr() % 16
    got = selective_scan(dt, x, bm, cm, a, d)
    want = selective_scan_ref(dt, x, bm, cm, a, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_scan_wrapper_rejects_bad_inputs(cuda):
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    args = _scan_inputs(0, 1, 16, 32, 4, cuda)
    with pytest.raises(TypeError):
        selective_scan_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError):                     # N = 5
        selective_scan_cuda(*args[:2], args[2].repeat(1, 1, 2)[..., :5],
                            args[3].repeat(1, 1, 2)[..., :5],
                            args[4].repeat(1, 2)[:, :5], args[5])
    with pytest.raises(ValueError):
        selective_scan_cuda(args[0].transpose(1, 2).contiguous()
                            .transpose(1, 2), *args[1:])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-1.8b",
                                  "falcon-mamba-7b"])
def test_smoke_model_on_card_matches_cpu(cuda, arch):
    from repro_torch import configs as CFG
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = CFG.get_smoke_config(arch)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    to = lambda t: ({k: to(v) for k, v in t.items()}
                    if isinstance(t, dict) else t.to(cuda))
    gpu = to(cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)))
    lc, kvc = M.prefill(cpu, cfg, toks)
    lg, kvg = M.prefill(gpu, cfg, toks.to(cuda))
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    for pg, pc in zip(kvg, kvc):
        for g, c in zip(pg, pc):
            torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)
    sc = serve(cfg, cpu, requests=4, slots=2, max_new=8).state
    sg = serve(cfg, gpu, requests=4, slots=2, max_new=8).state
    for field in ("generated", "n_generated", "active", "position"):
        assert torch.equal(getattr(sg, field).cpu(), getattr(sc, field))


def test_dynamic_and_networked_lanes_on_card(cuda):
    """Small dynamic and networked lanes (chip_smoke.py's copies of the
    conformance recipes) x the 2x2 grid in one batch on the card: every
    lane equals its single run there bit for bit, and the batch equals
    the CPU's in states, placements and migration counts, with times,
    joules and MB within 1e-3."""
    import importlib.util
    import pathlib
    from repro_torch.core import sweep
    from repro_torch.core.engine import batched_run_stats
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    vm_p, task_p = sweep.policy_grid(device="cpu")
    outs = []
    for dev in (cuda, "cpu"):
        batch = sweep.fuse_grid(sweep.stack_scenarios(
            cs.dyn_lane_scenarios(6, dev)), vm_p.to(dev), task_p.to(dev))
        outs.append((batch, *batched_run_stats(batch, max_steps=4096)))
    (batch, grid, stats), (_, cpu, cstats) = outs
    assert stats.n_events == cstats.n_events
    for name in ("cloudlets.state", "vms.state", "vms.host", "mig_count"):
        assert torch.equal(_leaf(grid, name).cpu(), _leaf(cpu, name)), name
    for name in ("cloudlets.finish_time", "hosts.energy_j", "mig_downtime",
                 "net_transferred_mb"):
        np.testing.assert_allclose(_leaf(grid, name).cpu().numpy(),
                                   _leaf(cpu, name).numpy(), rtol=0,
                                   atol=1e-3, err_msg=name)
    for i in range(batch.time.shape[0]):
        single, _ = run_stats(S.map_tensors(lambda t: t[i], batch),
                              max_steps=4096)
        for name, a in _leaves(single):
            assert torch.equal(_leaf(grid, name)[i], a), (i, name)


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_padded_index_kernel_matches_plain_version(cuda, case):
    """A padded index (a streamed window's: empty spans [C, C], -1 empty
    rows, -1 chunks) on grouped rows with slots of no row after them:
    the kernel equals its plain version and the kernel on the unpadded
    index, bitwise, one launch a call."""
    from repro_torch.kernels.simstep import padded_row_index
    lengths = RAGGED[case]
    v = len(lengths)
    for tail in (0, 37):
        vm = torch.cat([torch.arange(v, dtype=torch.int32).repeat_interleave(
            torch.as_tensor(lengths)), torch.full((tail,), -1,
                                                  dtype=torch.int32)])
        vm = vm.to(cuda)
        _, (rem, run, cap, pes) = _ragged_tile(0, lengths, cuda)
        rem = torch.cat([rem[:vm.numel() - tail],
                         torch.full((tail,), 5.0, device=cuda)])
        run = torch.cat([run[:vm.numel() - tail],
                         torch.ones((tail,), dtype=torch.bool, device=cuda)])
        exact, padded = row_index(vm, v), padded_row_index(vm, v)
        for policy in (0, 1):
            pol = torch.tensor(policy, dtype=torch.int32, device=cuda)
            before = simstep.launches
            r, d = simstep_ragged(rem, run, padded, cap, pes, pol)
            assert simstep.launches == before + 1
            r_ref, d_ref = simstep_ragged_ref(rem, run, padded, cap, pes,
                                              pol)
            r_ex, d_ex = simstep_ragged(rem, run, exact, cap, pes, pol)
            torch.cuda.synchronize()
            assert torch.equal(r, r_ref) and torch.equal(d, d_ref)
            assert torch.equal(r, r_ex) and torch.equal(d, d_ex)


def test_streamed_lanes_on_card(cuda):
    """Small streamed scenarios (chip_smoke.py's copy of the conformance
    recipe) x the 2x2 grid in one ``run_stream_grid`` on the card: the
    counts, reservoir ids and the window's states equal the CPU's, with
    sums and times within 1e-3, and lane 0 equals its single run."""
    import importlib.util
    import pathlib
    from repro_torch.core import sweep
    from repro_torch.core.engine import run_stream
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    outs = []
    for dev in (cuda, "cpu"):
        pairs = [cs.streamed_scenario(s, dev) for s in range(4)]
        batch = sweep.stack_scenarios([p[0] for p in pairs])
        grid = sweep.policy_grid(device=dev)
        outs.append((batch, [p[1] for p in pairs],
                     sweep.run_stream_grid(batch, [p[1] for p in pairs],
                                           *grid, reservoir=16)))
    (batch, streams, (g, gs, gr)), (_, _, (c, ccs, cr)) = outs
    for name in ("n_retired", "n_failed", "per_vm_done", "res_sid"):
        assert torch.equal(getattr(gs.stats, name).cpu(),
                           getattr(ccs.stats, name)), name
    assert torch.equal(g.cloudlets.state.cpu(), c.cloudlets.state)
    for x, y in zip(gr[1:], cr[1:]):
        assert torch.equal(x.cpu(), y)
    np.testing.assert_allclose(gs.stats.sum_exec.cpu().numpy(),
                               ccs.stats.sum_exec.numpy(), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(g.hosts.energy_j.cpu().numpy(),
                               c.hosts.energy_j.numpy(), rtol=1e-3,
                               atol=1e-3)
    out, st, _ = run_stream(S.map_tensors(lambda t: t[0], batch), streams[0],
                            reservoir=16)
    for name, a in _leaves(out):
        assert torch.equal(_leaf(g, name)[0, 0], a), name
    for x, y in zip(S.tensor_leaves(st.stats),
                    S.tensor_leaves(gs.stats)):
        assert torch.equal(y[0, 0], x)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_elastic_and_probed_lanes_on_card(cuda):
    """A small ``s5-100k-elastic`` (400 hosts, 200 slots) and a probed §5
    on the card against the CPU: states, placements, scale counts and
    histograms exact, times, joules, spot spend and bucket rows within
    1e-5 relative; simstep launches on both paths."""
    import dataclasses
    from repro_torch.core import metrics as M
    cs = _chip_smoke()
    for make in (lambda dev: cs.s5_elastic(400, 200, S.TIME_SHARED, dev),
                 lambda dev: dataclasses.replace(
                     cs.section5(400, 200, S.TIME_SHARED, dev),
                     metrics=M.make_metrics(400, horizon=12000.0,
                                            sla_factor=2.0, device=dev))):
        before = simstep.launches
        gpu, g_stats = run_stats(make(cuda), max_steps=8192)
        torch.cuda.synchronize()
        assert simstep.launches > before
        cpu, c_stats = run_stats(make("cpu"), max_steps=8192)
        assert g_stats.n_events == c_stats.n_events
        for name in ("cloudlets.state", "vms.state", "vms.host",
                     "scaler.up_count", "scaler.down_count",
                     "metrics.hist_response", "metrics.sla_breaches"):
            assert torch.equal(_leaf(gpu, name).cpu(), _leaf(cpu, name)), \
                name
        for name in ("cloudlets.finish_time", "hosts.energy_j",
                     "scaler.spot_cost", "metrics.bucket_util",
                     "metrics.bucket_watts", "metrics.host_busy_s"):
            np.testing.assert_allclose(_leaf(gpu, name).cpu().numpy(),
                                       _leaf(cpu, name).numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_policy_search_cells_on_card(cuda):
    """Two headroom lanes x 12 autoscaler points in one
    ``run_policy_search`` on the card: the cells equal the CPU's in
    states and scale counts, and cell (5, 1) equals its single run on
    the card bit for bit."""
    import dataclasses
    from repro_torch.core import sweep
    cs = _chip_smoke()
    finals = []
    for dev in (cuda, "cpu"):
        batch = sweep.stack_scenarios([cs.headroom_scenario(100 + s, dev)
                                       for s in range(2)])
        grid = sweep.policy_points((0.6, 0.75, 0.9), (0.2, 0.35),
                                   (1.0, 4.0), device=dev)
        finals.append((batch, grid, sweep.run_policy_search(
            batch, grid, max_steps=4096)))
    (batch, grid, g), (_, _, c) = finals
    for name in ("cloudlets.state", "vms.state", "scaler.up_count",
                 "scaler.down_count"):
        assert torch.equal(_leaf(g, name).cpu(), _leaf(c, name)), name
    one = S.map_tensors(lambda t: t[1], batch)
    cell = dataclasses.replace(one, scaler=dataclasses.replace(
        one.scaler, util_high=grid.util_high[5].clone(),
        util_low=grid.util_low[5].clone(), cooldown=grid.cooldown[5].clone(),
        scale_step=grid.scale_step[5].clone(),
        price_sensitivity=grid.price_sensitivity[5].clone()))
    out, _ = run_stats(cell, max_steps=4096)
    for name, a in _leaves(out):
        assert torch.equal(_leaf(g, name)[5, 1], a), name
