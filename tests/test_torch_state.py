"""The PyTorch port's state, builders, converter and segment primitives,
held against the JAX package on the CPU.

The converter must round-trip every golden-corpus payload exactly (values
and dtypes); the port's builders must build the very arrays the JAX
builders build; the grouped-segment primitives must equal JAX's.  Also
here: the port imports neither JAX nor the JAX package, and its builders
refuse to fall back to the CPU when no CUDA device is present.
"""
import ast
import dataclasses
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_conformance import POLICY_GRID, SEEDS, make_scenario
from test_golden_corpus import CORPUS, rebuild

from repro.core import broker as JB
from repro.core import segments as JSEG
from repro.core import state as JS
from repro_torch.core import broker as B
from repro_torch.core import energy, segments
from repro_torch.core import state as S
from repro_torch.core.convert import from_arrays, to_numpy
from repro_torch.core.metrics import no_metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]


def leaves(port_obj, other, path=""):
    """(path, port leaf, other leaf) over the port dataclass's fields."""
    for f in dataclasses.fields(port_obj):
        a = getattr(port_obj, f.name)
        b = getattr(other, f.name)
        if dataclasses.is_dataclass(a):
            yield from leaves(a, b, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", a, b


def assert_same_state(port_state, other, ctx=""):
    """Every leaf equal in value, dtype and shape (port tensors or numpy
    arrays against any np.asarray-able leaves)."""
    for name, a, b in leaves(port_state, other):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype, f"{ctx} {name}: {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape, f"{ctx} {name}: {a.shape} vs {b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {name}")


def make_scenario_torch(seed, vm_policy, task_policy, *, n_hosts=3,
                        n_vms=4, per_vm=3):
    """``test_conformance.make_scenario`` built with the port's builders
    (the same numpy draws in the same order)."""
    rng = np.random.default_rng(seed)
    idle = rng.uniform(0.05, 0.2, n_hosts)
    g4 = energy.normalize_watts(energy.SPEC_G4_WATTS, device="cpu")[2]
    lin = energy.linear_curve(device="cpu")
    curves = np.where(rng.integers(0, 2, n_hosts)[:, None] == 1,
                      g4.numpy()[None], lin.numpy()[None])
    hosts = S.make_hosts(rng.integers(1, 4, n_hosts),
                         rng.choice([250.0, 500.0, 1000.0], n_hosts),
                         4096.0, 1000.0, 1e6,
                         idle_w=idle,
                         peak_w=idle + rng.uniform(0.2, 0.8, n_hosts),
                         power_curve=curves, device="cpu")
    vms = S.make_vms(
        rng.integers(1, 3, n_vms),
        rng.choice([250.0, 500.0, 1000.0], n_vms),
        64.0, 1.0, 10.0,
        submit_time=np.round(rng.uniform(0, 5, n_vms), 2).astype(np.float32),
        device="cpu")
    owners = np.repeat(np.arange(n_vms, dtype=np.int32), per_vm)
    submit = np.sort(
        np.round(rng.uniform(0, 20, (n_vms, per_vm)), 2),
        axis=1).reshape(-1).astype(np.float32)
    lengths = np.round(
        rng.uniform(500, 8000, n_vms * per_vm)).astype(np.float32)
    cl = S.make_cloudlets(owners, lengths, submit, device="cpu")
    return S.make_datacenter(hosts, vms, cl, vm_policy=vm_policy,
                             task_policy=task_policy,
                             reserve_pes=bool(seed % 2), device="cpu")


def quickstart_states(n_hosts=20, n_vms=8, waves=3, policy=S.TIME_SHARED):
    """The §5 quickstart scenario (cut to size) from both packages."""
    jdc = JS.make_datacenter(
        JS.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0),
        JB.build_fleet([JB.VmSpec(count=n_vms)]),
        JB.build_waves(n_vms, JB.WaveSpec(waves=waves)),
        vm_policy=JS.SPACE_SHARED, task_policy=policy, reserve_pes=True,
        rates=JS.make_market(0.01, 0.001, 1e-4, 0.002))
    tdc = S.make_datacenter(
        S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                             device="cpu"),
        B.build_fleet([B.VmSpec(count=n_vms)], device="cpu"),
        B.build_waves(n_vms, B.WaveSpec(waves=waves), device="cpu"),
        vm_policy=S.SPACE_SHARED, task_policy=policy, reserve_pes=True,
        rates=S.make_market(0.01, 0.001, 1e-4, 0.002, device="cpu"),
        device="cpu")
    return tdc, jdc


@pytest.fixture(scope="module")
def corpus():
    with open(CORPUS) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["static", "dynamic", "networked",
                                  "elastic", "streamed"])
def test_converter_round_trips_golden_corpus(corpus, kind):
    """JAX state -> port -> numpy -> port: exact values and dtypes on every
    payload of the frozen corpus."""
    for seed, stored in corpus["scenarios"][kind].items():
        for vp, tp in POLICY_GRID:
            jdc = rebuild(stored, vp, tp)
            port = from_arrays(jdc, device="cpu")
            assert_same_state(port, jdc, f"{kind} {seed}")
            back = to_numpy(port)
            assert_same_state(port, back, f"{kind} {seed} to_numpy")
            assert_same_state(from_arrays(back, device="cpu"), jdc,
                              f"{kind} {seed} again")


def test_converter_accepts_dicts_and_port_states():
    tdc, jdc = quickstart_states()
    as_dict = lambda obj: {f.name: (as_dict(getattr(obj, f.name))
                                    if dataclasses.is_dataclass(
                                        getattr(obj, f.name))
                                    else np.asarray(getattr(obj, f.name)))
                           for f in dataclasses.fields(obj)}
    assert_same_state(from_arrays(as_dict(tdc), device="cpu"), jdc)
    assert_same_state(from_arrays(tdc, device="cpu"), jdc)


@pytest.mark.parametrize("seed", SEEDS[:13])
def test_builders_match_jax_on_conformance_scenarios(seed):
    for vp, tp in POLICY_GRID:
        assert_same_state(make_scenario_torch(seed, vp, tp),
                          make_scenario(seed, vp, tp), f"seed {seed}")


@pytest.mark.parametrize("policy", [S.SPACE_SHARED, S.TIME_SHARED])
def test_builders_match_jax_on_quickstart(policy):
    tdc, jdc = quickstart_states(policy=policy)
    assert_same_state(tdc, jdc)


def test_small_builders_match_jax():
    pairs = [
        (S.no_network(5, device="cpu"), JS.no_network(5)),
        (S.no_autoscaler(3, device="cpu"), JS.no_autoscaler(3)),
        (no_metrics(4, device="cpu"), JS.no_metrics(4)),
        (S.make_market(0.01, 0.002, 3e-4, 0.5, device="cpu"),
         JS.make_market(0.01, 0.002, 3e-4, 0.5)),
    ]
    for port, ref in pairs:
        assert_same_state(port, ref)
    np.testing.assert_array_equal(S.no_events(device="cpu").numpy(),
                                  np.asarray(JS.no_events()))
    curve = energy.normalize_watts(energy.SPEC_G5_WATTS, device="cpu")
    from repro.core import energy as JE
    jcurve = JE.normalize_watts(JE.SPEC_G5_WATTS)
    assert curve[:2] == jcurve[:2]
    np.testing.assert_array_equal(curve[2].numpy(), np.asarray(jcurve[2]))
    np.testing.assert_array_equal(energy.linear_curve(device="cpu").numpy(),
                                  np.asarray(JE.linear_curve()))


@pytest.mark.parametrize("ids", [[0, 0, 1, 1, 1, 2], [3, 3, 0, 0, 3, 3, 3],
                                 [5], [0, 1, 2, 3], [2, 2, 2, 2]])
def test_validate_cloudlet_order_matches_jax(ids):
    assert (S.validate_cloudlet_order(torch.tensor(ids))
            == JS.validate_cloudlet_order(np.asarray(ids)))


def _grouped_ids(rng, n):
    runs = rng.integers(1, 6, n)
    ids = rng.integers(-1, 8, n)
    return np.repeat(ids, runs).astype(np.int32)[:n]


@pytest.mark.parametrize("seed", range(8))
def test_segment_primitives_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    ids = _grouped_ids(rng, n)
    t_ids, j_ids = torch.from_numpy(ids), jnp.asarray(ids)
    for name in ("run_starts", "run_ids", "segment_rank"):
        got = getattr(segments, name)(t_ids)
        want = np.asarray(getattr(JSEG, name)(j_ids))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    ivals = rng.integers(0, 5, ids.shape[0]).astype(np.int32)
    fvals = rng.uniform(-10, 10, ids.shape[0]).astype(np.float32)
    for excl in (True, False):
        got = segments.segment_cumsum(torch.from_numpy(ivals), t_ids,
                                      exclusive=excl)
        want = JSEG.segment_cumsum(jnp.asarray(ivals), j_ids, exclusive=excl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = segments.segment_cumsum(torch.from_numpy(fvals), t_ids,
                                      exclusive=excl)
        want = JSEG.segment_cumsum(jnp.asarray(fvals), j_ids, exclusive=excl)
        # f32 prefix sums in another association order than XLA's
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)
    for vals in (ivals, fvals):
        got = segments.segment_min(torch.from_numpy(vals), t_ids)
        want = JSEG.segment_min(jnp.asarray(vals), j_ids)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


BUILDERS = {
    "make_uniform_hosts": lambda **kw: S.make_uniform_hosts(4, **kw),
    "make_hosts": lambda **kw: S.make_hosts([1, 2], 100.0, 1.0, 1.0, 1.0,
                                            **kw),
    "make_vms": lambda **kw: S.make_vms([1], 100.0, 1.0, 1.0, 1.0, **kw),
    "make_cloudlets": lambda **kw: S.make_cloudlets([0, 0], 10.0, **kw),
    "make_market": lambda **kw: S.make_market(**kw),
    "no_network": lambda **kw: S.no_network(3, **kw),
    "no_autoscaler": lambda **kw: S.no_autoscaler(**kw),
    "no_events": lambda **kw: S.no_events(**kw),
    "no_metrics": lambda **kw: no_metrics(3, **kw),
    "linear_curve": lambda **kw: energy.linear_curve(**kw),
    "build_fleet": lambda **kw: B.build_fleet([B.VmSpec(count=2)], **kw),
    "build_waves": lambda **kw: B.build_waves(2, B.WaveSpec(waves=2), **kw),
    "make_datacenter": lambda **kw: S.make_datacenter(
        S.make_uniform_hosts(2, device="cpu"),
        S.make_vms([1], 100.0, 1.0, 1.0, 1.0, device="cpu"),
        S.make_cloudlets([0], 10.0, device="cpu"), **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_default_to_cuda_and_raise_without_it(name, monkeypatch):
    build = BUILDERS[name]
    leaf = lambda obj: (obj if isinstance(obj, torch.Tensor)
                        else next(iter(leaves(obj, obj)))[1])
    assert leaf(build(device="cpu")).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a CUDA device the smoke script exits non-zero and prints
    no result line."""
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
