"""The port's selective scan on the CPU: its plain version against the JAX
``selective_scan_ref`` and the Pallas kernel (interpret mode) on
``test_kernels.py``'s cases, and the CPU dispatch.  The CUDA kernel itself
is tested in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan_pallas as j_pallas
from repro.kernels.selective_scan import selective_scan_ref as j_ref
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_cuda,
                                                selective_scan_ref)

TOL = 2e-4                                 # test_kernels.py's


def _inputs(seed, b, s, di, n, zero_d=False, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = (np.log1p(np.exp(r(b, s, di))) * dt_scale).astype(np.float32)
    a = -np.exp(r(di, n)).astype(np.float32)
    d = (np.zeros if zero_d else np.ones)(di, np.float32)
    arrs = [dt, r(b, s, di), r(b, s, n), r(b, s, n), a, d]
    return [jnp.asarray(x) for x in arrs], [torch.from_numpy(x) for x in arrs]


@pytest.mark.parametrize("s,di,n,dtile,schunk", [
    (64, 32, 8, 32, 32),
    (128, 64, 16, 32, 64),
    (256, 128, 16, 128, 128),
])
def test_plain_version_matches_jax_ref_and_pallas(s, di, n, dtile, schunk):
    jargs, targs = _inputs(s + n, 2, s, di, n)
    got = selective_scan_ref(*targs).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ref(*jargs)), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        got, np.asarray(j_pallas(*jargs, dtile=dtile, schunk=schunk,
                                 interpret=True)), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("zero_d,dt_scale", [(True, 1.0), (False, 1e-6)])
def test_plain_version_zero_skip_and_tiny_dt(zero_d, dt_scale):
    """test_kernels.py's chunk-carry shape (N=4, D=0) and a tiny dt, where
    the state barely moves."""
    jargs, targs = _inputs(3, 1, 64, 16, 4, zero_d, dt_scale)
    np.testing.assert_allclose(selective_scan_ref(*targs).numpy(),
                               np.asarray(j_ref(*jargs)), atol=TOL,
                               rtol=TOL)


def test_dispatch_takes_plain_version_on_cpu():
    _, targs = _inputs(0, 2, 20, 8, 4)
    before = selective_scan.launches
    assert torch.equal(selective_scan(*targs), selective_scan_ref(*targs))
    assert selective_scan.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    _, targs = _inputs(0, 2, 20, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(*targs)
