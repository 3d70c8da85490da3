"""The port stands alone: no module of ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, and the package never
calls a library attention kernel or ``torch.compile`` (``chip_smoke.py``
may, as a timed yardstick only)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _rel(path):
    return str(path.relative_to(ROOT))


def test_package_files_found():
    names = {p.name for p in PACKAGE}
    assert {"attention.py", "ssm.py", "engine.py", "serve.py",
            "ops.py"} <= names


@pytest.mark.parametrize("path", PACKAGE + [ROOT / "chip_smoke.py"],
                         ids=_rel)
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{_rel(path)} imports {bad}"


def test_federation_slice_modules_found():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PACKAGE}
    assert {"core/cis.py", "core/federation.py", "core/experiments.py",
            "core/sweep.py", "core/workloads.py"} <= names
    assert {"torch_intercloud_study.py", "torch_federation_sim.py",
            "torch_network_study.py"} <= {p.name for p in EXAMPLES}


@pytest.mark.parametrize("path", EXAMPLES, ids=_rel)
def test_port_examples_import_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{_rel(path)} imports {bad}"


@pytest.mark.parametrize("path", PACKAGE, ids=_rel)
def test_no_library_attention_or_compile(path):
    text = path.read_text()
    for word in ("scaled_dot_product_attention", "torch.compile"):
        assert word not in text, f"{_rel(path)} uses {word}"
