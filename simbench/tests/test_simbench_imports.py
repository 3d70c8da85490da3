"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names,
compared whole, in a fresh interpreter."""
import json
import subprocess
import sys

from simbench_tiny import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib.util
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

HARNESS = """
spec = importlib.util.spec_from_file_location('r', {run!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
import simbench.harness, simbench.control, simbench.drivers.s5_sweep
import repro_torch.core.engine, repro_torch.core.sweep
import repro_torch.core.broker, repro_torch.kernels.simstep.ops
for m in ('setup_s', 'simstep_roofline_pct', 'device_idle_pct'):
    simbench.harness.read_metric(m, {{'setup_s': 1.0, 'trace': None,
        'window_s': 1.0, 'calls': [], 'items': 0, 'peak_bytes': 0}})
"""

REFERENCE = """
import simbench.reference.s5, simbench.compare, simbench.generate
import simbench.simstep_bytes
"""


def _loaded(body: str) -> set:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _loaded(HARNESS.format(run=str(ROOT / "simbench" / "run.py")))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
