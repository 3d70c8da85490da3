"""The port's LM-fleet builders (``workloads.LmWorkloadProfile``,
``profile_from_roofline``, ``cloudlets_from_profile``,
``make_tpu_hosts``), ``launch.simulate --lm-profile`` and
``examples/torch_lm_fleet_sim.py`` on the CPU.

The builders are NumPy arithmetic over simulator state, so their blocks
equal the JAX package's leaf for leaf.  A counterpart of
``tests/test_system.py::test_lm_fleet_profile_roundtrip``, the fleet's
final state against JAX's ``run`` (states, placements and counts exact,
times within 1e-3 s), and the CLI and the example against JAX's output
from a hand-written roofline JSON.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_state import assert_same_state, leaves

from repro.core import broker as JB
from repro.core import engine as JE
from repro.core import state as JS
from repro.core import workloads as JW
from repro.launch import simulate as j_simulate
from repro_torch.core import broker as B
from repro_torch.core import state as S
from repro_torch.core import workloads as W
from repro_torch.core.engine import run
from repro_torch.launch import simulate

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
# tests/test_system.py::test_lm_fleet_profile_roundtrip's numbers
ROUNDTRIP = dict(hlo_gflops=1.0e5, in_bytes=32768 * 4, out_bytes=2 * 151936,
                 chips=256)
ART = {"arch": "qwen2-1.5b", "shape": "prefill_32k", "chips": 256,
       "cost_per_device": {"flops": 1.0e14 / 256},
       "memory": {"peak_bytes_per_device": 6.0e9}}


def test_tpu_constant_is_jax_s():
    assert W.TPU_V5E_MIPS == JW.TPU_V5E_MIPS
    assert W._MI_PER_FLOP == JW._MI_PER_FLOP


@pytest.mark.parametrize("kw", [
    ROUNDTRIP,
    dict(hlo_gflops=2 * 1.5 * 32768.0, hbm_bytes_per_chip=4e9, chips=1),
    dict(hlo_gflops=0.3, in_bytes=7.0, out_bytes=3.0,
         hbm_bytes_per_chip=1.25e9, chips=8),
])
def test_profile_equals_jax(kw):
    got = W.profile_from_roofline("cell", **kw)
    want = JW.profile_from_roofline("cell", **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("n_vms,per_vm,period,first_at", [
    (4, 3, 0.1, 0.0), (16, 12, 0.8, 0.0), (5, 7, 0.37, 2.5), (1, 1, 1.0, 0.0)])
def test_cloudlets_from_profile_equal_jax(n_vms, per_vm, period, first_at):
    prof = W.profile_from_roofline("cell", **ROUNDTRIP)
    jprof = JW.profile_from_roofline("cell", **ROUNDTRIP)
    got = W.cloudlets_from_profile(prof, n_vms, requests_per_vm=per_vm,
                                   period=period, first_at=first_at,
                                   device=CPU)
    want = JW.cloudlets_from_profile(jprof, n_vms, requests_per_vm=per_vm,
                                     period=period, first_at=first_at)
    assert_same_state(got, want)


@pytest.mark.parametrize("n_chips,hbm_gb,ici_gbps", [(8, 16.0, 50.0),
                                                     (3, 95.0, 100.0)])
def test_tpu_hosts_equal_jax(n_chips, hbm_gb, ici_gbps):
    got = W.make_tpu_hosts(n_chips, hbm_gb=hbm_gb, ici_gbps=ici_gbps,
                           device=CPU)
    want = JW.make_tpu_hosts(n_chips, hbm_gb=hbm_gb, ici_gbps=ici_gbps)
    assert_same_state(got, want)


def _roundtrip_fleet(Wm, Bm, Sm, **dev):
    prof = Wm.profile_from_roofline("qwen2-1.5b/prefill_32k", **ROUNDTRIP)
    hosts = Wm.make_tpu_hosts(8, **dev)
    vms = Bm.build_fleet([Bm.VmSpec(count=4, pes=1, mips=197e6,
                                    ram=8 * 1024.0, size=100.0)], **dev)
    cl = Wm.cloudlets_from_profile(prof, 4, requests_per_vm=3, period=0.1,
                                   **dev)
    return Sm.make_datacenter(hosts, vms, cl, task_policy=Sm.TIME_SHARED,
                              reserve_pes=True, **dev)


def test_lm_fleet_profile_roundtrip():
    """Roofline numbers -> cloudlets -> simulated serving fleet."""
    dc = _roundtrip_fleet(W, B, S, device=CPU)
    out = run(dc, max_steps=256)
    done = (out.cloudlets.state == S.CL_DONE).numpy()
    assert done.all()
    # one 1e14-FLOP request on a 197-TFLOP/s chip ~ 0.5 s service time
    exec_t = (out.cloudlets.finish_time
              - out.cloudlets.start_time).numpy()[done]
    assert exec_t.min() >= 1e5 * 1e9 * 1e-6 / 197e6 - 1e-3


def test_lm_fleet_final_state_matches_jax():
    """The roundtrip fleet run to quiescence in both packages: every
    integer leaf equal, every float leaf within 1e-3."""
    got = run(_roundtrip_fleet(W, B, S, device=CPU), max_steps=256)
    want = JE.run(_roundtrip_fleet(JW, JB, JS), max_steps=256)
    n_float = 0
    for name, a, b in leaves(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":
            n_float += 1
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-3,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert n_float > 10


def _lines(main, argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["simulate"] + argv)
    with contextlib.redirect_stdout(buf):
        main()
    return [line for line in buf.getvalue().splitlines()
            if line.startswith("[simulate]")]


@pytest.mark.parametrize("extra", [
    ["--hosts", "16", "--vms", "8", "--waves", "3"],
    ["--hosts", "6", "--vms", "12", "--waves", "4", "--wave-period", "0.2",
     "--task-policy", "time"],
    ["--hosts", "4", "--vms", "8", "--waves", "2", "--vm-policy", "time",
     "--task-policy", "time"],
])
def test_simulate_lm_profile_matches_jax(extra, monkeypatch, tmp_path):
    """``--lm-profile`` from a hand-written roofline JSON prints JAX's
    ``[simulate]`` lines, the ``LM fleet`` line first."""
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(ART))
    argv = ["--lm-profile", str(path)] + extra
    want = _lines(j_simulate.main, argv, monkeypatch)
    got = _lines(simulate.main, argv + ["--device", "cpu"], monkeypatch)
    assert got[0] == "[simulate] LM fleet: qwen2-1.5b/prefill_32k, " \
                     "100.0 TFLOP/request"
    assert len(got) >= 4 and got == want


def test_simulate_lm_profile_trace_matches_jax(monkeypatch, tmp_path):
    """With ``--trace``: the completion curve and the report lines equal
    JAX's; the trace summary's floats within rtol 1e-6 (the port sums
    utilization in f64, JAX in f32)."""
    import ast
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(ART))
    argv = ["--lm-profile", str(path), "--hosts", "16", "--vms", "8",
            "--waves", "2", "--trace", "8"]
    want = _lines(j_simulate.main, argv, monkeypatch)
    got = _lines(simulate.main, argv + ["--device", "cpu"], monkeypatch)
    assert len(got) == len(want)
    summary = [i for i, line in enumerate(want) if "{" in line]
    assert len(summary) == 1
    for i, (a, b) in enumerate(zip(got, want)):
        if i not in summary:
            assert a == b
    a, b = (ast.literal_eval(x[i].split(" ", 1)[1])
            for x, i in ((got, summary[0]), (want, summary[0])))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-6, err_msg=key)


def _example(*args, jax_platform=False):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    if jax_platform:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, check=True, cwd=ROOT,
                          timeout=600).stdout.splitlines()


def test_lm_fleet_example_matches_jax():
    """examples/torch_lm_fleet_sim.py on the CPU prints the JAX example's
    table for the built-in qwen2-1.5b profile: 6 rows, every request
    done."""
    got = _example("examples/torch_lm_fleet_sim.py", "--device", "cpu")
    want = _example("examples/lm_fleet_sim.py", jax_platform=True)
    assert got == want
    rows = [line for line in got if line.count("|") == 4
            and line.strip()[:1].isdigit()]
    assert len(rows) == 6 and all(r.endswith("192") for r in rows)


def test_lm_fleet_example_reads_a_profile(tmp_path):
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(ART))
    got = _example("examples/torch_lm_fleet_sim.py", str(path), "--device",
                   "cpu")
    want = _example("examples/lm_fleet_sim.py", str(path),
                    jax_platform=True)
    assert got == want and got[0].startswith("workload: qwen2-1.5b/")
