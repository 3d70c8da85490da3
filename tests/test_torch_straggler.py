"""The port's straggler study (``repro_torch.ft.straggler``) on the CPU.

Counterparts of ``tests/test_checkpoint_ft.py::test_straggler_policies_ordering``
and ``::test_straggler_backup_beats_none_under_heavy_skew``, and the
step times of all three policies against the JAX package's
``simulate_sync_training`` on the same fleets: equal, element for
element (the durations are f32 differences of finish times that both
engines stamp at the same event times).
"""
import numpy as np
import pytest

from repro.ft import straggler as JS
from repro_torch import ft
from repro_torch.ft import straggler as TS

CPU = "cpu"


def test_ft_exports_only_the_straggler_study():
    """``ft`` exports the straggler study and, since the supervisor was
    ported, JAX's supervisor names (and ``SimulatedFailure``): nothing
    else."""
    public = {n for n in dir(ft) if not n.startswith("_")}
    assert public - {"straggler", "supervisor"} == {
        "simulate_sync_training", "StragglerReport", "FailureInjector",
        "SimulatedFailure", "Supervisor", "SupervisorReport"}


def test_straggler_policies_ordering():
    """DES-validated: backup ~ recovers ideal; none suffers slow_factor."""
    kw = dict(n_workers=32, steps=10, slow_frac=0.1, slow_factor=4.0,
              seed=3, device=CPU)
    none = TS.simulate_sync_training(policy="none", **kw)
    drop = TS.simulate_sync_training(policy="drop", drop_k=28, **kw)
    backup = TS.simulate_sync_training(policy="backup", **kw)
    # no mitigation: every step pays the slowest worker (4x)
    np.testing.assert_allclose(none.slowdown_vs_ideal, 4.0, rtol=1e-3)
    # dropping the slowest 4 of 32 recovers the ideal step time
    np.testing.assert_allclose(drop.slowdown_vs_ideal, 1.0, rtol=1e-3)
    # backup workers recover ideal unless both replicas are slow
    assert backup.slowdown_vs_ideal <= none.slowdown_vs_ideal
    assert backup.mean_step <= none.mean_step


def test_straggler_backup_beats_none_under_heavy_skew():
    kw = dict(n_workers=16, steps=5, slow_frac=0.25, slow_factor=8.0,
              seed=11, device=CPU)
    none = TS.simulate_sync_training(policy="none", **kw)
    backup = TS.simulate_sync_training(policy="backup", **kw)
    assert backup.mean_step < none.mean_step


@pytest.mark.parametrize("policy,drop_fast", [("none", False),
                                              ("drop", True),
                                              ("drop", False),
                                              ("backup", False)])
@pytest.mark.parametrize("kw", [
    dict(n_workers=32, steps=10, slow_frac=0.1, slow_factor=4.0, seed=3),
    dict(n_workers=16, steps=5, slow_frac=0.25, slow_factor=8.0, seed=11),
    dict(n_workers=40, steps=6, slow_frac=0.3, slow_factor=2.5, seed=5,
         work_mi=45_000.0, base_mips=700.0),
], ids=["ordering", "heavy-skew", "odd-mips"])
def test_step_times_equal_jax(policy, drop_fast, kw):
    """``drop_fast`` drops exactly the slow workers (``drop_k = n -
    n_slow``); otherwise ``drop`` keeps its default ``0.95 n``."""
    n = kw["n_workers"]
    drop_k = n - int(round(kw["slow_frac"] * n)) if drop_fast else None
    got = TS.simulate_sync_training(policy=policy, drop_k=drop_k,
                                    device=CPU, **kw)
    want = JS.simulate_sync_training(policy=policy, drop_k=drop_k, **kw)
    assert got.policy == want.policy
    assert got.step_times.dtype == want.step_times.dtype
    np.testing.assert_array_equal(got.step_times, want.step_times)
    for name in ("mean_step", "p99_step", "slowdown_vs_ideal"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.stats.n_events > 0


def test_degrade_keeps_the_state_device_and_dtype():
    """``_degrade`` throttles ``round(slow_frac * n)`` of the workers'
    hosts to ``base / factor``, drawn as JAX's draws them, and leaves the
    spares alone."""
    import torch
    from repro_torch.core import state as S
    n = 20
    hosts = S.make_hosts(np.ones(2 * n), np.full(2 * n, 1000.0, np.float32),
                         4096.0, 1000.0, 1e9, device=CPU)
    vms = S.make_vms([1] * 2 * n, 1000.0, 64.0, 1.0, 10.0, device=CPU)
    cl = S.make_cloudlets(np.arange(2 * n), 1000.0, 0.0, device=CPU)
    dc = S.make_datacenter(hosts, vms, cl, device=CPU)
    out = TS._degrade(dc, n, 0.25, 4.0, 1000.0, seed=7)
    mips = out.hosts.mips_per_pe
    assert mips.dtype == torch.float32 and mips.device == dc.time.device
    slow = np.flatnonzero(mips.numpy() == 250.0)
    want = np.sort(np.random.default_rng(7).choice(n, 5, replace=False))
    np.testing.assert_array_equal(slow, want)
    assert (mips.numpy()[n:] == 1000.0).all()


def test_unknown_policy_raises():
    with pytest.raises(ValueError):
        TS.simulate_sync_training(n_workers=4, steps=2, policy="retry",
                                  device=CPU)
