"""The port's resident arrival generators (``workloads.poisson_arrivals``,
``bursty_arrivals``) on the CPU.

Each is a draw from an explicit ``torch.Generator`` over a plain
function of the draws.  Fed JAX's own draws (``jax.random``), the plain
functions give JAX's ``CloudletState``: integer fields exact, submit
times within rtol 1e-6 (the f32 running sum may add in another order).
On the generator path, the assertions of
``tests/test_system.py::test_poisson_and_bursty_generators`` and
``::test_vmap_scenario_sweep_one_compile`` (there a vmap over five keys,
here a batched run of five seeded lanes) hold, and one seed gives the
same cloudlets.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_state import leaves

from repro.core import workloads as JW
from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core import sweep, workloads
from repro_torch.core.engine import run

CPU = "cpu"


def _agree(got, want):
    for name, a, b in leaves(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "submit_time":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed,n_vms,rate,horizon,per_vm", [
    (0, 4, 0.1, 100.0, 8), (1, 3, 0.05, 200.0, 4), (2, 16, 1.0, 30.0, 64),
    (3, 1, 2.0, 5.0, 1)])
def test_poisson_from_jax_draws_matches_jax(seed, n_vms, rate, horizon,
                                            per_vm):
    key = jax.random.PRNGKey(seed)
    kw = dict(rate_per_vm=rate, horizon=horizon, length_mi=1000.0)
    want = JW.poisson_arrivals(key, n_vms, max_per_vm=per_vm,
                               file_size=3.0, output_size=1.5, **kw)
    draws = np.asarray(jax.random.exponential(key, (n_vms, per_vm)))
    got = workloads.poisson_from_draws(draws, file_size=3.0,
                                       output_size=1.5, device=CPU, **kw)
    _agree(got, want)
    alive = got.state == S.CL_CREATED
    assert int(alive.sum()) > 0


@pytest.mark.parametrize("seed,n_vms,every,size,bursts,jitter", [
    (0, 3, 50.0, 2, 3, 5.0), (1, 5, 10.0, 4, 2, 12.5),
    (2, 1, 1.0, 1, 7, 0.25)])
def test_bursty_from_jax_noise_matches_jax(seed, n_vms, every, size, bursts,
                                           jitter):
    key = jax.random.PRNGKey(seed)
    want = JW.bursty_arrivals(key, n_vms, burst_every=every,
                              burst_size=size, n_bursts=bursts,
                              jitter=jitter, length_mi=500.0)
    noise = np.asarray(jax.random.uniform(key, (n_vms, size * bursts),
                                          minval=0.0, maxval=jitter))
    got = workloads.bursty_from_noise(noise, burst_every=every,
                                      burst_size=size, n_bursts=bursts,
                                      length_mi=500.0, device=CPU)
    _agree(got, want)


def test_poisson_and_bursty_generators():
    gen = torch.Generator().manual_seed(0)
    cl = workloads.poisson_arrivals(gen, 4, rate_per_vm=0.1, horizon=100.0,
                                    max_per_vm=8, length_mi=1000.0,
                                    device=CPU)
    alive = cl.state == S.CL_CREATED
    assert int(alive.sum()) > 0
    assert bool((cl.submit_time[alive] <= 100.0).all())
    assert bool((cl.remaining[~alive] == 0.0).all())

    cl2 = workloads.bursty_arrivals(torch.Generator().manual_seed(0), 3,
                                    burst_every=50.0, burst_size=2,
                                    n_bursts=3, jitter=5.0, length_mi=500.0,
                                    device=CPU)
    assert cl2.vm.shape[0] == 3 * 6
    assert S.validate_cloudlet_order(cl2.vm)
    base = np.repeat(np.arange(3) * 50.0, 2)
    jit = cl2.submit_time.numpy().reshape(3, 6) - base
    assert bool(((jit >= 0.0) & (jit < 5.0)).all())


def test_seeded_lanes_batch_like_a_sweep():
    """Monte-Carlo arrival sweeps: five seeded lanes in one batched run
    (the JAX test's vmap over five keys), each lane == its single run."""
    hosts = S.make_uniform_hosts(4, pes=1, device=CPU)
    vms = B.build_fleet([B.VmSpec(count=2)], device=CPU)

    def scenario(seed):
        cl = workloads.poisson_arrivals(
            torch.Generator().manual_seed(seed), 2, rate_per_vm=0.05,
            horizon=200.0, max_per_vm=4, length_mi=30_000.0, device=CPU)
        return S.make_datacenter(hosts, vms, cl, reserve_pes=True,
                                 device=CPU)

    dcs = [scenario(7 + s) for s in range(5)]
    out = sweep.run_batch(sweep.stack_scenarios(dcs), max_steps=256)
    ns = [int(B.collect(S.map_tensors(lambda t: t[i], out)).n_completed)
          for i in range(5)]
    assert len(ns) == 5
    assert all(0 <= n <= 8 for n in ns)
    assert sum(ns) > 0
    for i, dc in enumerate(dcs):
        single = run(dc, max_steps=256)
        assert torch.equal(single.cloudlets.finish_time,
                           out.cloudlets.finish_time[i])


@pytest.mark.parametrize("make", ["poisson", "bursty"])
def test_same_seed_same_cloudlets(make):
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        if make == "poisson":
            return workloads.poisson_arrivals(
                gen, 5, rate_per_vm=0.2, horizon=50.0, max_per_vm=6,
                length_mi=100.0, device=CPU)
        return workloads.bursty_arrivals(
            gen, 5, burst_every=20.0, burst_size=3, n_bursts=2, jitter=4.0,
            length_mi=100.0, device=CPU)

    a, b, c = draw(11), draw(11), draw(12)
    for name, x, y in leaves(a, b):
        assert torch.equal(x, y), name
    assert not torch.equal(a.submit_time, c.submit_time)


def test_generators_default_to_the_card(monkeypatch):
    """``device=None`` is the CUDA card: without one the builders raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.poisson_arrivals(gen, 2, rate_per_vm=1.0, horizon=1.0,
                                   max_per_vm=2, length_mi=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.bursty_arrivals(gen, 2, burst_every=1.0, burst_size=1,
                                  n_bursts=1, jitter=1.0, length_mi=1.0)
