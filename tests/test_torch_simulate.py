"""What the port's static path adds for users, held against the JAX
package on the CPU: ``run_trace``'s records, the telemetry reducers,
``broker.destroy_idle_vms``, ``market.tiered_cpu_rates``, the
``[simulate]`` lines of the §5 CLI, and the p99 of ``collect`` past
``torch.nanquantile``'s 2^24-value cap."""
import contextlib
import dataclasses
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, make_scenario
from test_torch_state import quickstart_states

from repro.core import broker as JB
from repro.core import market as JM
from repro.core import state as JS
from repro.core import telemetry as JT
from repro.core.engine import run as j_run
from repro.core.engine import run_trace as j_run_trace
from repro.core.provisioning import provision_pending as j_provision
from repro.launch import simulate as j_simulate
from repro_torch.core import broker as B
from repro_torch.core import market as M
from repro_torch.core import state as S
from repro_torch.core import telemetry as T
from repro_torch.core.convert import from_arrays
from repro_torch.core.engine import run, run_trace
from repro_torch.core.provisioning import provision_pending
from repro_torch.launch import simulate

EXACT = ("n_running", "n_done", "active", "n_migrating", "migrations",
         "hosts_down", "n_flows", "n_events", "fleet")


def _trace_pair(jdc, n):
    jfinal, jtrace = j_run_trace(jdc, num_steps=n)
    final, trace = run_trace(from_arrays(jdc, device="cpu"), num_steps=n)
    return (final, trace), (jfinal, jtrace)


@pytest.mark.parametrize("vp,tp", POLICY_GRID)
def test_run_trace_records_match_jax(vp, tp):
    """Discrete fields exact; times and joules within 1e-3, utilization
    and watts within 1e-5 relative."""
    for seed in (0, 3, 8):
        (final, trace), (jfinal, jtrace) = _trace_pair(
            make_scenario(seed, vp, tp), 40)
        ctx = f"seed {seed} ({vp},{tp})"
        for name in EXACT:
            np.testing.assert_array_equal(getattr(trace, name).numpy(),
                                          np.asarray(getattr(jtrace, name)),
                                          err_msg=f"{ctx} {name}")
        np.testing.assert_allclose(trace.time.numpy(),
                                   np.asarray(jtrace.time), rtol=0,
                                   atol=1e-3, err_msg=ctx)
        for name in ("utilization", "watts"):
            np.testing.assert_allclose(getattr(trace, name).numpy(),
                                       np.asarray(getattr(jtrace, name)),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{ctx} {name}")
        assert trace.time.shape == (40,)
        # the trace ends where run ends, and run_trace's steps are run's
        assert bool(~trace.active[-1])
        np.testing.assert_array_equal(
            final.cloudlets.finish_time.numpy(),
            run(from_arrays(make_scenario(seed, vp, tp), device="cpu"),
                leap=False).cloudlets.finish_time.numpy())


def test_telemetry_reducers_match_jax():
    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        tdc, jdc = quickstart_states(policy=policy)
        (final, trace), (jfinal, jtrace) = _trace_pair(jdc, 24)
        # the same reducers on the same (JAX) trace: equal
        for fn in ("completion_curve", "utilization_timeline",
                   "watts_timeline"):
            for a, b in zip(getattr(T, fn)(jtrace), getattr(JT, fn)(jtrace)):
                np.testing.assert_array_equal(a, b)
        assert T.summarize_trace(jtrace) == JT.summarize_trace(jtrace)
        # the port's trace through the port's reducers
        for fn in ("completion_curve", "utilization_timeline",
                   "watts_timeline"):
            (t, y), (jt, jy) = getattr(T, fn)(trace), getattr(JT, fn)(jtrace)
            np.testing.assert_allclose(t, jt, rtol=0, atol=1e-3)
            np.testing.assert_allclose(y, jy, rtol=1e-5)
        np.testing.assert_allclose(T.trace_energy_j(trace),
                                   JT.trace_energy_j(jtrace), rtol=1e-5)
        got, want = T.summarize_trace(trace), JT.summarize_trace(jtrace)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert T.gantt(final) == JT.gantt(jfinal)


def test_telemetry_of_an_empty_trace():
    tdc, _ = quickstart_states()
    quiet = dataclasses.replace(tdc, cloudlets=dataclasses.replace(
        tdc.cloudlets, state=torch.zeros_like(tdc.cloudlets.state)),
        vms=dataclasses.replace(tdc.vms, state=torch.zeros_like(
            tdc.vms.state)))
    _, trace = run_trace(quiet, num_steps=3)
    assert T.summarize_trace(trace)["events"] == 0
    assert T.trace_energy_j(trace) == 0.0


def _small(pkg, dev):
    """tests/test_broker_cis.py's datacenter: 4 hosts of 2 PEs, 2 VMs,
    two waves."""
    kw = {} if pkg is JS else {"device": dev}
    bk = JB if pkg is JS else B
    hosts = pkg.make_uniform_hosts(4, pes=2, mips=1000.0, **kw)
    vms = bk.build_fleet([bk.VmSpec(count=2, pes=1)], **kw)
    cl = bk.build_waves(2, bk.WaveSpec(waves=2, length_mi=30_000.0,
                                       period=10.0), **kw)
    return pkg.make_datacenter(hosts, vms, cl, reserve_pes=True,
                               rates=pkg.make_market(0.01, 0.0, 0.0, 0.0,
                                                     **kw), **kw)


def test_destroy_returns_resources():
    """``test_destroy_returns_resources`` on the port, and equal to the
    JAX reducer on the same final state."""
    out = run(_small(S, "cpu"), max_steps=256)
    before = float(out.hosts.free_pes.sum())
    out2 = B.destroy_idle_vms(out)
    assert float(out2.hosts.free_pes.sum()) == before + 2
    assert bool((out2.vms.state == S.VM_DESTROYED).all())
    assert bool((out2.vms.host == -1).all())
    want = JB.destroy_idle_vms(j_run(_small(JS, None), max_steps=256))
    for blk, names in (("hosts", ("free_ram", "free_bw", "free_storage",
                                  "free_pes")), ("vms", ("state", "host"))):
        for name in names:
            np.testing.assert_array_equal(
                getattr(getattr(out2, blk), name).numpy(),
                np.asarray(getattr(getattr(want, blk), name)), err_msg=name)
    # the freed capacity admits a new fleet
    vms2 = B.build_fleet([B.VmSpec(count=2, pes=1, submit_time=100.0)],
                         device="cpu")
    cl2 = S.make_cloudlets([0, 1], 1000.0, submit_time=100.0, device="cpu")
    dc3 = dataclasses.replace(out2, vms=vms2, cloudlets=cl2,
                              time=torch.tensor(100.0))
    assert bool((provision_pending(dc3).vms.state == S.VM_ACTIVE).all())


@pytest.mark.parametrize("reserve", [True, False])
def test_destroy_matches_jax_mid_run(reserve):
    """Half-way states (some VMs drained, some still working, some never
    placed): the same VMs go, the same pools come back."""
    for seed in range(6):
        for vp, tp in POLICY_GRID[::3]:
            jdc = dataclasses.replace(make_scenario(seed, vp, tp),
                                      reserve_pes=jnp.int32(int(reserve)))
            for k in (4, 9, 256):
                jmid = j_provision(j_run(jdc, max_steps=k, leap=False))
                want = JB.destroy_idle_vms(jmid)
                got = B.destroy_idle_vms(from_arrays(jmid, device="cpu"))
                for blk, name in (("vms", "state"), ("vms", "host"),
                                  ("hosts", "free_ram"),
                                  ("hosts", "free_pes"),
                                  ("hosts", "free_storage")):
                    np.testing.assert_array_equal(
                        getattr(getattr(got, blk), name).numpy(),
                        np.asarray(getattr(getattr(want, blk), name)),
                        err_msg=f"{seed} {k} {blk}.{name}")


def test_surge_pricing():
    """``tests/test_market.py::test_surge_pricing`` on the port."""
    base = S.make_market(0.01, 0.001, 0.0001, 0.002, device="cpu")
    pol = M.PricingPolicy(base=base, surge_threshold=np.float32(0.8),
                          surge_factor=np.float32(3.0))
    hot = M.tiered_cpu_rates(pol, np.float32(0.9))
    cold = M.tiered_cpu_rates(pol, torch.tensor(0.2))
    jpol = JM.PricingPolicy(base=JS.make_market(0.01, 0.001, 0.0001, 0.002),
                            surge_threshold=np.float32(0.8),
                            surge_factor=np.float32(3.0))
    for util, got in ((0.9, hot), (0.2, cold)):
        want = JM.tiered_cpu_rates(jpol, np.float32(util))
        assert float(got.cost_per_cpu_sec) == float(want.cost_per_cpu_sec)
        assert float(got.cost_per_mem) == float(want.cost_per_mem)
    np.testing.assert_allclose(float(hot.cost_per_cpu_sec), 0.03, rtol=1e-6)
    np.testing.assert_allclose(float(cold.cost_per_cpu_sec), 0.01,
                               rtol=1e-6)


def _lines(main, argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["simulate"] + argv)
    with contextlib.redirect_stdout(buf):
        main()
    return [line for line in buf.getvalue().splitlines()
            if line.startswith("[simulate]")]


@pytest.mark.parametrize("argv", [
    ["--hosts", "50"],
    ["--hosts", "50", "--task-policy", "time", "--vm-policy", "time"],
    ["--hosts", "50", "--vms", "20", "--waves", "3", "--trace", "16"],
])
def test_simulate_cli_matches_jax(argv, monkeypatch):
    want = _lines(j_simulate.main, argv, monkeypatch)
    got = _lines(simulate.main, argv + ["--device", "cpu"], monkeypatch)
    assert len(got) >= 3 and got == want


def test_p99_past_2_to_the_24():
    """``collect``'s p99 helper on 2^24 + 1 values (NaNs among them),
    where ``torch.nanquantile`` refuses, against ``np.nanpercentile``."""
    rng = np.random.default_rng(0)
    x = rng.exponential(3600.0, 2 ** 24 + 1).astype(np.float32)
    x[rng.integers(0, x.size, 1000)] = np.nan
    got = float(B.nan_p99(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.nanpercentile(x, 99.0), rtol=1e-6)
    for n in (1, 2, 7, 100):
        y = rng.uniform(0, 10, n).astype(np.float32)
        np.testing.assert_allclose(float(B.nan_p99(torch.from_numpy(y))),
                                   np.nanpercentile(y, 99.0), rtol=1e-6)
    assert np.isnan(float(B.nan_p99(torch.full((5,), float("nan")))))
    assert np.isnan(float(B.nan_p99(torch.zeros(0))))
