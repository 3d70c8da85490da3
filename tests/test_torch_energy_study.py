"""``examples/torch_energy_study.py`` against ``examples/energy_study.py``
on the CPU, and the port's ``scheduling.segment_cumsum_grouped``.

The example's printed rows equal JAX's.  In-process, the same two
studies (the 2x2 grid over two contended scenarios under the G5 curve,
and three provisioning policies under a concave curve) give JAX's
completion sets and placements exactly, finish times within 1e-3 s,
and per-host joules within 1e-3 J of JAX's (the oracle tolerance of
``docs/conformance.md``) or, past 2^13 J a host, within one f32 ulp of
JAX's value: the study's hosts draw 94-135 W for hours, up to 7.8e5 J,
where one ulp is 0.0625 J and the two engines' event sums may part by
an ulp.  A total over hosts is held to the sum of its hosts' bounds
plus one ulp of its own rounding.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import broker as JB
from repro.core import energy as JEN
from repro.core import engine as JE
from repro.core import scheduling as JSC
from repro.core import state as JS
from repro.core import sweep as JSW
from repro_torch.core import broker as B
from repro_torch.core import energy as EN
from repro_torch.core import engine as E
from repro_torch.core import scheduling as SC
from repro_torch.core import segments
from repro_torch.core import state as S
from repro_torch.core import sweep as SW
from repro_torch.core.provisioning import FIRST_FIT, MOST_FULL, ROUND_ROBIN

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def test_segment_cumsum_grouped_is_segment_cumsum():
    assert SC.segment_cumsum_grouped is segments.segment_cumsum
    assert "segment_cumsum_grouped" in SC.__all__
    assert "segment_cumsum_grouped" in JSC.__all__


def _example(*args, jax_platform=False):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    if jax_platform:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, check=True, cwd=ROOT,
                          timeout=600).stdout.splitlines()


def test_energy_study_example_matches_jax():
    """Every printed line equal: 8 policy rows (done, makespan, mean
    response, MJ) and 3 provisioning rows (hosts used, makespan, kJ)."""
    got = _example("examples/torch_energy_study.py", "--device", "cpu")
    want = _example("examples/energy_study.py", jax_platform=True)
    assert got == want
    assert sum(" MJ" in line for line in got) == 8
    assert sum(" kJ" in line for line in got) == 3


def _scenario(Sm, Bm, ENm, n_vms, waves, length_mi, period, **dev):
    idle, peak, g5 = ENm.normalize_watts(ENm.SPEC_G5_WATTS, **dev)
    hosts = Sm.make_uniform_hosts(16, pes=2, mips=1000.0, ram=4096.0,
                                  idle_w=idle, peak_w=peak, power_curve=g5,
                                  **dev)
    vms = Bm.build_fleet([Bm.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                    ram=256.0, size=100.0)], **dev)
    cl = Bm.build_waves(n_vms, Bm.WaveSpec(waves=waves, length_mi=length_mi,
                                           period=period), **dev)
    return Sm.make_datacenter(hosts, vms, cl, reserve_pes=False, **dev)


SCENARIOS = ((48, 3, 240_000.0, 120.0), (24, 4, 120_000.0, 90.0))


def _host_bound(want):
    """Per host, the larger of 1e-3 J and one f32 ulp of JAX's joules."""
    want = np.abs(np.asarray(want, np.float32))
    return np.maximum(1e-3, np.spacing(want))


def _assert_joules(got, want, bound, ctx):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(diff <= bound), f"{ctx}: |diff| {diff} over {bound}"


def _total_bound(host_want, total_want):
    """A total over hosts: its hosts' bounds plus one ulp of the total."""
    return (_host_bound(host_want).sum(axis=-1)
            + np.spacing(np.abs(np.asarray(total_want, np.float32))))


def _agree(got, want, ctx):
    for blk, name in (("cloudlets", "state"), ("vms", "host"),
                      ("vms", "state")):
        np.testing.assert_array_equal(
            getattr(getattr(got, blk), name).numpy(),
            np.asarray(getattr(getattr(want, blk), name)),
            err_msg=f"{ctx} {blk}.{name}")
    np.testing.assert_allclose(got.cloudlets.finish_time.numpy(),
                               np.asarray(want.cloudlets.finish_time),
                               rtol=0, atol=1e-3, err_msg=ctx)
    _assert_joules(got.hosts.energy_j.numpy(), want.hosts.energy_j,
                   _host_bound(want.hosts.energy_j), ctx)


def test_energy_grid_matches_jax():
    batch = SW.stack_scenarios([_scenario(S, B, EN, *s, device=CPU)
                                for s in SCENARIOS])
    jbatch = JSW.stack_scenarios([_scenario(JS, JB, JEN, *s)
                                  for s in SCENARIOS])
    got = SW.run_grid(batch, *SW.policy_grid(device=CPU), max_steps=4096)
    want = JSW.run_grid(jbatch, *JSW.policy_grid(), max_steps=4096)
    for p in range(4):
        for b in range(2):
            _agree(S.map_tensors(lambda t: t[p, b], got),
                   JSW.jax.tree_util.tree_map(lambda t: t[p, b], want),
                   f"cell {p},{b}")
    en = SW.summarize_batch(got).energy_j.numpy()
    jen = np.asarray(JSW.summarize_batch(want).energy_j)
    _assert_joules(en, jen, _total_bound(want.hosts.energy_j, jen),
                   "lane totals")


@pytest.mark.parametrize("policy", [FIRST_FIT, ROUND_ROBIN, MOST_FULL])
def test_energy_provisioning_matches_jax(policy):
    def build(Sm, Bm, ENm, **dev):
        idle, peak, _ = ENm.normalize_watts(ENm.SPEC_G5_WATTS, **dev)
        concave = np.linspace(0.0, 1.0, ENm.K_CURVE) ** 0.25
        hosts = Sm.make_uniform_hosts(16, pes=2, mips=1000.0, ram=4096.0,
                                      idle_w=idle, peak_w=peak,
                                      power_curve=concave, **dev)
        vms = Bm.build_fleet([Bm.VmSpec(count=16, pes=1, mips=1000.0,
                                        ram=256.0, size=100.0)], **dev)
        cl = Bm.build_waves(16, Bm.WaveSpec(waves=2, length_mi=120_000.0,
                                            period=60.0), **dev)
        return Sm.make_datacenter(hosts, vms, cl, vm_policy=Sm.SPACE_SHARED,
                                  task_policy=Sm.SPACE_SHARED,
                                  reserve_pes=True, **dev)
    got = E.run(build(S, B, EN, device=CPU), max_steps=4096,
                provision_policy=policy)
    want = JE.run(build(JS, JB, JEN), max_steps=4096,
                  provision_policy=policy)
    _agree(got, want, f"policy {policy}")
    total = float(JEN.energy_total_j(want))
    _assert_joules(float(EN.energy_total_j(got)), total,
                   _total_bound(want.hosts.energy_j, total), "total")
