"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.specs``,
``launch.cost_analysis``, ``kernels.work``) against JAX's and against
the port's own live ranks.

- ``launch.specs``' shape-only inputs, parameters and train states equal
  JAX's ``eval_shape`` of the same, leaf by leaf (shapes and dtypes), for
  every applicable (arch, shape) at smoke size and two archs at full
  size.
- The ring formulas and ``roofline_terms`` as
  ``tests/test_hlo_analysis.py`` checks JAX's, with H100 constants.
- One rank's flops on a (4, 1) mesh are a quarter of one rank's on
  (1, 1), exactly.
- The collectives the dry-run predicts on an abstract mesh (seen from
  rank 0) equal, entry by entry, what each of 4 gloo ranks records on a
  live (2, 2), (1, 4) and (4, 1) mesh, for training, prefill and decode
  at smoke size (one spawn of 4 ranks, ``torch_ranks_worker.
  dryrun_ranks``).
- A cell's JSON feeds ``launch.simulate --lm-profile``; its
  ``model_flops`` follow JAX's formulas.
"""
import json
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import torch_ranks_worker
from repro import configs as JCFG
from repro.launch import specs as JSP
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro_torch import configs as CFG
from repro_torch.kernels.flash_attention import attention, flash_attention
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.launch import dryrun as D
from repro_torch.launch import simulate
from repro_torch.launch import specs as SP
from repro_torch.launch.cost_analysis import (HW, Tally, collective_bw,
                                              collective_bytes,
                                              roofline_terms)
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.train import AdamWConfig, TrainConfig
from repro_torch.tree import tree_flatten

FULL_ARCHS = ("llava-next-34b", "jamba-1.5-large-398b")
SMOKE_CELLS = [(a, s) for a, s, ok in
               ((a, s, CFG.shape_applicable(CFG.get_smoke_config(a), s))
                for a in CFG.ARCH_IDS for s in CFG.SHAPES) if ok]
# small cells: the production cells' kinds and rules at smoke sizes
SMALL = {"train_4k": ("train_4k", 32, 4, "train"),
         "prefill_32k": ("prefill_32k", 32, 4, "prefill"),
         "decode_32k": ("decode_32k", 64, 4, "decode")}
RANK_MESHES = ((2, 2), (1, 4), (4, 1))
RANK_CASES = {f"{arch}:{m[0]}x{m[1]}:{kind}": (arch, m, SMALL[kind])
              for arch, meshes in (("qwen3-0.6b", RANK_MESHES),
                                   ("moonshot-v1-16b-a3b", ((2, 2),)),
                                   ("falcon-mamba-7b", ((1, 4),)))
              for m in meshes for kind in SMALL}
WORLD = 4
RANKS_TIMEOUT = 300             # seconds for the spawned ranks


def _jax_leaves(tree):
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    key = lambda k: str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k))))
    return {"/".join(key(k) for k in path): (tuple(s.shape), str(s.dtype))
            for path, s in leaves}


def _port_leaves(tree):
    paths, leaves, _ = tree_flatten(tree)
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in zip(paths, leaves)}


def _same_shapes(port, jax_tree, ctx):
    got, want = _port_leaves(port), _jax_leaves(jax_tree)
    assert got == want, ctx


def _inputs(arch, shape_name, smoke):
    pick = CFG.get_smoke_config if smoke else CFG.get_config
    jpick = JCFG.get_smoke_config if smoke else JCFG.get_config
    cfg, jcfg = pick(arch), jpick(arch)
    shape, jshape = CFG.SHAPES[shape_name], JCFG.SHAPES[shape_name]
    fn = {"train": ("train_inputs",), "prefill": ("prefill_inputs",),
          "decode": ("decode_inputs",)}[shape.kind]
    for name in fn:
        _same_shapes(getattr(SP, name)(cfg, shape),
                     getattr(JSP, name)(jcfg, jshape),
                     f"{arch} {shape_name} {name}")


@pytest.mark.parametrize("arch,shape_name", SMOKE_CELLS)
def test_input_specs_equal_jax_eval_shape_smoke(arch, shape_name):
    _inputs(arch, shape_name, smoke=True)


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in FULL_ARCHS for s in CFG.SHAPES
    if CFG.shape_applicable(CFG.get_config(a), s)])
def test_input_specs_equal_jax_eval_shape_full(arch, shape_name):
    _inputs(arch, shape_name, smoke=False)


@pytest.mark.parametrize("arch,full", [(a, False) for a in CFG.ARCH_IDS]
                         + [(a, True) for a in FULL_ARCHS])
def test_params_and_train_state_shapes_equal_jax(arch, full):
    cfg = (CFG.get_config if full else CFG.get_smoke_config)(arch)
    jcfg = (JCFG.get_config if full else JCFG.get_smoke_config)(arch)
    _same_shapes(SP.params_shapes(cfg), JSP.params_shapes(jcfg),
                 f"{arch} params")
    if not full:
        _same_shapes(SP.train_state_shapes(cfg, TrainConfig()),
                     JSP.train_state_shapes(jcfg, JTrainConfig(
                         opt=JAdamW())), f"{arch} train state")


# ---------------------------------------------------------------------------
# The ring formulas and the roofline (tests/test_hlo_analysis.py)
# ---------------------------------------------------------------------------
def test_all_reduce_ring_cost():
    st = collective_bytes([("all-reduce", 4096 * 4, 8)])
    assert st.counts["all-reduce"] == 1
    np.testing.assert_allclose(st.by_kind["all-reduce"],
                               2 * 4096 * 4 * 7 / 8, rtol=1e-6)


def test_mixed_collectives():
    st = collective_bytes([("all-gather", 1024 * 512 * 2, 4),
                           ("reduce-scatter", 256 * 4, 4),
                           ("all-to-all", 64 * 64 * 4, 2),
                           ("collective-permute", 128 * 4, 2),
                           ("all-reduce", 32 * 4, 4)])
    assert st.counts == {"all-reduce": 1, "all-gather": 1,
                         "reduce-scatter": 1, "all-to-all": 1,
                         "collective-permute": 1}
    np.testing.assert_allclose(st.by_kind["all-gather"],
                               1024 * 512 * 2 * 3 / 4, rtol=1e-6)
    np.testing.assert_allclose(st.by_kind["reduce-scatter"],
                               256 * 4 * 3, rtol=1e-6)
    np.testing.assert_allclose(st.by_kind["all-to-all"],
                               64 * 64 * 4 / 2, rtol=1e-6)
    np.testing.assert_allclose(st.by_kind["collective-permute"],
                               128 * 4, rtol=1e-6)
    np.testing.assert_allclose(st.by_kind["all-reduce"],
                               2 * 32 * 4 * 3 / 4, rtol=1e-6)
    assert st.wire_bytes == sum(st.by_kind.values())


def test_roofline_terms_math():
    bw = collective_bw(256)
    assert bw == HW["ib_bw"] and collective_bw(4) == HW["nvlink_bw"]
    r = roofline_terms(hlo_flops=HW["peak_flops"] * 0.1,
                       hlo_bytes=HW["hbm_bw"] * 0.05,
                       collective_wire_bytes=bw * 0.2, chips=256,
                       model_flops=HW["peak_flops"] * 0.08 * 256)
    np.testing.assert_allclose(r["compute_s"], 0.1, rtol=1e-6)
    np.testing.assert_allclose(r["memory_s"], 0.05, rtol=1e-6)
    np.testing.assert_allclose(r["collective_s"], 0.2, rtol=1e-6)
    assert r["dominant"] == "collective_s"
    np.testing.assert_allclose(r["useful_flops_ratio"], 0.8, rtol=1e-6)
    np.testing.assert_allclose(r["roofline_fraction"], 0.08 / 0.2,
                               rtol=1e-6)
    assert HW["peak_flops"] == 989e12 and HW["hbm_bw"] == 3.35e12


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------
def test_kernels_report_their_own_work_on_shape_only_tensors():
    """A shape-only call takes the card's route: its operator counts the
    kernel's work (68.7 GFLOP at [4, 2048, 16/8, 128] causal) and the
    bytes it reads and writes, and launches nothing; the plain version on
    real CPU tensors counts no kernel."""
    before = flash_attention.launches
    with FakeTensorMode():
        q = torch.empty(4, 2048, 16, 128, dtype=torch.bfloat16)
        k = v = torch.empty(4, 2048, 8, 128, dtype=torch.bfloat16)
        x = torch.empty(2, 64, 32)
        n = torch.empty(2, 64, 4)
        with FlopCounterMode(display=False) as fc:
            out = attention(q, k, v, causal=True)
            y = selective_scan(x, x, n, n, torch.empty(32, 4),
                               torch.empty(32))
        with Tally() as t:
            attention(q, k, v, causal=True)
    assert tuple(out.shape) == tuple(q.shape) and y.shape == x.shape
    got = D.kernel_flops(fc)
    assert got == {"flash_attention": 4 * 4 * 16 * 2048 * 2048 * 128 / 2,
                   "selective_scan": 7 * 2 * 64 * 32 * 4}
    # q and k, v read, out written (no log-sum-exp without a gradient)
    assert t.accessed == 2 * (2 * q.numel() + 2 * k.numel())
    assert flash_attention.launches == before
    with FlopCounterMode(display=False) as plain:
        attention(*(torch.zeros(1, 8, 2, 16) for _ in range(3)))
    assert D.kernel_flops(plain) == {}


def test_abstract_mesh_refuses_tensors_with_data():
    """Count mode takes shape-only tensors only: a real tensor on an
    abstract mesh has no process group to reduce over, and raises."""
    mesh = abstract_mesh((2, 2), ("data", "model"))
    x = torch.ones(4, 3)
    for collective in (lambda: mesh.psum(x, "data"),
                       lambda: mesh.all_gather(x, "model", 0),
                       lambda: mesh.gather(x, "model", 0),
                       lambda: mesh.scatter(x, "model", 0),
                       lambda: mesh.all_reduce_(x.clone(), "data")):
        with pytest.raises(RuntimeError, match="abstract mesh"):
            collective()
    with FakeTensorMode():
        y = mesh.all_gather(torch.empty(4, 3), "model", 0)
    assert tuple(y.shape) == (8, 3)


def test_tally_counts_a_gathers_gradient_in_place():
    """Autograd scatters a gather's gradient into a fresh zero tensor in
    place on the card, out of place on a ``FakeTensor``: the tally holds
    one gradient-sized tensor there, not two."""
    with FakeTensorMode():
        x = torch.empty(64, 1024, requires_grad=True)   # 262,144 B
        idx = torch.zeros(64, 1, dtype=torch.int64)
        with Tally([x]) as t:
            torch.gather(x, -1, idx).sum().backward()
    size = 64 * 1024 * 4
    assert 2 * size <= t.peak < 2 * size + 4096, t.peak


def test_tally_follows_live_storages():
    with FakeTensorMode():
        a = torch.empty(1000)                    # 4,000 B -> 4,096
        with Tally([a]) as t:
            b = torch.empty(100)                 # 400 B -> 512
            c = b + 1
            del b
            d = torch.empty(2000)                # 8,000 B -> 8,192
            del c, d
    assert t.peak == 4096 + 512 + 8192 and t.live == 4096
    assert t.accessed == 400 + 400      # c = b + 1 (allocations: none)


def _train_flops(mesh_shape):
    cfg = CFG.get_smoke_config("qwen3-0.6b")
    prog, _ = D.lower_cell(cfg, CFG.ShapeSpec(*SMALL["train_4k"]),
                           abstract_mesh(mesh_shape, ("data", "model")),
                           mesh_shape[0] * mesh_shape[1])
    got = D.measure(prog, memory=False)
    assert got["by_kernel"]["flash_attention_bwd"] > 0
    return got["flops"]


def test_flops_divide_by_the_data_axis():
    assert _train_flops((4, 1)) * 4 == _train_flops((1, 1))


# ---------------------------------------------------------------------------
# Predicted collectives against the live ranks' (gloo)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    torch.save({"meshes": RANK_MESHES, "cases": RANK_CASES},
               tmp / "inputs.pt")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # leave cores to the spawned ranks
    ctx = mp.spawn(torch_ranks_worker.dryrun_ranks, args=(WORLD, str(tmp)),
                   nprocs=WORLD, join=False)
    predicted = {}
    for key, (arch, mesh_shape, shape) in RANK_CASES.items():
        prog, _ = D.lower_cell(CFG.get_smoke_config(arch),
                               CFG.ShapeSpec(*shape),
                               abstract_mesh(mesh_shape, ("data", "model")),
                               WORLD)
        predicted[key] = D.measure(prog, memory=False)["entries"]
    deadline = time.monotonic() + RANKS_TIMEOUT
    while not ctx.join(timeout=5):
        assert time.monotonic() < deadline, "the ranks did not finish"
    torch.set_num_threads(threads)
    live = [torch.load(tmp / f"out{WORLD}_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return predicted, live


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_predicted_collectives_equal_the_live_ranks(ranks, case):
    """Every rank's live entries (kind, result bytes, group size), in
    order, equal what the abstract mesh predicts from rank 0; so do the
    wire bytes kind by kind."""
    predicted, live = ranks
    want = predicted[case]
    assert want, case
    for r, got in enumerate(live):
        assert got[case] == want, (case, r)
        assert collective_bytes(got[case]).by_kind == \
            collective_bytes(want).by_kind


# ---------------------------------------------------------------------------
# A production cell's JSON, into --lm-profile
# ---------------------------------------------------------------------------
def test_cell_json_feeds_lm_profile(tmp_path, capsys):
    arch, shape = "qwen3-0.6b", "decode_32k"
    res = D.run_cell(arch, shape, "single", str(tmp_path),
                     **dict(D._DEFAULTS))
    path = tmp_path / f"{arch}__{shape}__single.json"
    art = json.loads(path.read_text())
    jcfg = JCFG.get_config(arch)
    b = JCFG.SHAPES[shape].global_batch
    assert art["model_flops"] == 2 * jcfg.active_param_count() * b
    assert art["chips"] == 256
    assert art["cost_per_device"]["flops"] == res["cost_per_device"]["flops"]
    # JAX's depth programs, in JAX's keys; its extrapolation over the 28
    # layers gives the full trace's flops
    a, b = art["cost_depth1"], art["cost_depth2"]
    assert set(a) == set(b) == {"flops", "bytes", "wire", "by_kind",
                                "counts"}
    nb = CFG.get_config(arch).num_blocks
    assert a["flops"] + (nb - 1) * (b["flops"] - a["flops"]) == \
        art["cost_per_device"]["flops"]
    assert art["memory"]["peak_bytes_per_device"] > art["memory"][
        "argument_bytes"] > 0
    assert art["collectives"]["wire_bytes"] > 0
    capsys.readouterr()
    simulate.main(["--lm-profile", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{arch}/{shape}" in out, out


def test_ssm_bf16_raises(tmp_path):
    """``--ssm-bf16`` no longer raises: the cell runs, and its options
    record the flag as JAX's do (the port's scan is f32 either way)."""
    D.main(["--arch", "falcon-mamba-7b", "--shape", "decode_32k",
            "--ssm-bf16", "1", "--no-cost", "--out", str(tmp_path)])
    path = tmp_path / "falcon-mamba-7b__decode_32k__single__ssm_bf16-True.json"
    art = json.loads(path.read_text())
    assert art["options"]["ssm_bf16"] is True
    assert art["memory"]["peak_bytes_per_device"] > 0


@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "train_4k"),
                                       ("jamba-1.5-large-398b",
                                        "prefill_32k")])
def test_depth_costs_extrapolate_to_the_full_trace(arch, kind):
    """JAX's extrapolation ``a + (nb - 1)(b - a)`` of the depth-1 and
    depth-2 programs' flops equals the full program's, on a small cell
    of the smoke config on (2, 2)."""
    cfg = CFG.get_smoke_config(arch)
    shape, mesh = CFG.ShapeSpec(*SMALL[kind]), abstract_mesh(
        (2, 2), ("data", "model"))
    a, b = D.depth_costs(cfg, shape, mesh, 4)
    full = D.measure(D.lower_cell(cfg, shape, mesh, 4)[0], memory=False)
    assert a["flops"] < b["flops"] or cfg.num_blocks == 1
    nb = cfg.num_blocks
    assert a["flops"] + (nb - 1) * (b["flops"] - a["flops"]) == \
        full["flops"]
    assert a["counts"] == full["collectives"]["counts"] or nb > 1


def test_train_state_shapes_under_the_cells_config():
    """``train_state_shapes`` honours the train config it is given (the
    int8 error-feedback buffers with ``pod_compression``)."""
    cfg = CFG.get_smoke_config("qwen3-0.6b")
    st = SP.train_state_shapes(cfg, TrainConfig(opt=AdamWConfig(),
                                                pod_compression=True))
    assert st.ef_error is not None
