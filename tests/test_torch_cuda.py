"""The port on a CUDA device: the hand-written kernels against their plain
versions, and the engine on the card against the engine on the CPU.

Every test here needs the card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core.engine import run_stats
from repro_torch.kernels.simstep import simstep, simstep_ref

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
