"""The rest of the sharding rules at run time on the CPU (gloo): the
sequence-parallel residual stream (``rules.sp``) in prefill and training,
and decode under tensor parallelism with ``cache_pspecs``' caches, the
KV cache's sequence over ``rules.kv_seq`` included, against the single
process and against JAX's jitted programs on 4 fake devices.

One spawn of 4 ranks (``torch_ranks_worker.sp_decode``) builds the
meshes (1, 4) and (2, 2) in one world and runs every case; JAX's
sharded programs run meanwhile in a subprocess with 4 forced CPU devices
and ``AxisType.Auto`` axes (prefill jitted with ``sp`` constraints and
``param_pspecs`` in-shardings; ``decode_step`` jitted with
``param_pspecs`` and ``cache_pspecs`` in-shardings), and the
single-process port here.  Parameters, tokens, positions and the
caches' contents are drawn from a seeded NumPy generator, the
parameters in the layout of JAX's ``init_params`` (``jax.eval_shape``)
and carried over by ``models.convert.params_from_jax``.  The cases:

- prefill with ``sp``: qwen3-0.6b, falcon-mamba-7b and h2o-danube-1.8b
  on (1, 4) and (2, 2); jamba-1.5-large-398b and moonshot-v1-16b-a3b on
  (1, 4) only (on (2, 2) JAX's expert parallelism sets MoE's capacity
  per data shard, ROADMAP "Known differences"); qwen3-0.6b with 3 heads
  of 22 (attention computed whole on every model rank); a sequence of
  18 that the model axis does not divide (not split, JAX's fallback);
- 3 train steps with ``sp`` (and FSDP) on (1, 4) and (2, 2): qwen3-0.6b,
  falcon-mamba-7b; on (1, 4) moonshot (capacity factor 64, as
  ``test_torch_sharded_train.py``) and the 3-heads case;
- one decode step on (1, 4) without ``kv_seq``: qwen3-0.6b (2 kv heads
  do not divide 4: the cache is replicated over the model axis),
  moonshot (kv heads cut, experts over the model axis),
  falcon-mamba-7b (the Mamba caches' channels cut); with ``kv_seq =
  ("model",)`` on (1, 4): h2o-danube (its sliding window's ring
  buffer), qwen3-0.6b, and qwen3-0.6b with a cache of 30 that 4 does
  not divide (not split); with ``kv_seq = ("data", "model")`` at B = 1
  on (2, 2): jamba (``long_500k``'s layout);
- 16 greedy steps through ``make_serve_step`` on (1, 4): h2o-danube
  with ``kv_seq = ("model",)`` (the ring buffer wraps) and
  falcon-mamba-7b.

Tolerances: prefill logits 2e-5 absolute against one process (they
agree within 7.3e-6; tensor parallelism adds each product's terms in
other groups) and 1e-4 against JAX's sharded program (the single
process already parts from JAX by up to 1e-4 in
``test_torch_models.py``; JAX's sharded programs agree with its one
device within 1.4e-5), top-1 equal to both; losses and grad norms 1e-5
relative, parameters after 3 steps as ``test_torch_sharded_train.py``
holds them to the single process (its ``_check_params``: the norm
scales, which under ``sp`` each rank applies to its block of the
sequence, among them); decode logits and every rank's updated cache
block 1e-5 against one process and 1e-4 against JAX, top-1 equal;
served tokens equal.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks_worker
from repro import configs as JCFG
from repro.models import model as JM
from repro_torch import configs as TCFG
from repro_torch.data.synthetic import config_for, make_batch
from repro_torch.launch.mesh import (abstract_mesh, init_ranks,
                                     make_local_mesh, rules_for_mesh,
                                     shutdown_ranks)
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.models.attention import (decode_attention,
                                          decode_attention_combine,
                                          decode_attention_partial)
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.serve.engine import (ServeConfig, init_server,
                                      make_serve_step, submit)
from repro_torch.sharding.rules import (block_shape, make_constrain,
                                        shard_leaf)
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_sharded_train import PARAM_TOL, _check_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS, SEED = 4, 3, 27
MESHES = {"tp": (1, 4), "both": (2, 2)}
ARCHS = {
    "qwen3": ("qwen3-0.6b", {}),
    "falcon": ("falcon-mamba-7b", {}),
    "h2o": ("h2o-danube-1.8b", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "moonshot": ("moonshot-v1-16b-a3b", {"capacity_factor": 64.0}),
    "odd-heads": ("qwen3-0.6b", {"num_heads": 3, "num_kv_heads": 1,
                                 "head_dim": 22}),
}
# (mesh, case): (arch, batch, seq, held against JAX's program too)
PREFILL = {
    ("tp", "qwen3"): ("qwen3", 4, 16, True),
    ("both", "qwen3"): ("qwen3", 4, 16, True),
    ("tp", "falcon"): ("falcon", 4, 16, True),
    ("both", "falcon"): ("falcon", 4, 16, True),
    ("tp", "h2o"): ("h2o", 4, 16, True),
    ("both", "h2o"): ("h2o", 4, 16, True),
    ("tp", "jamba"): ("jamba", 4, 16, True),
    ("tp", "moonshot"): ("moonshot", 4, 16, True),
    ("tp", "odd-heads"): ("odd-heads", 4, 16, False),
    ("both", "odd-heads"): ("odd-heads", 4, 16, False),
    ("tp", "qwen3-s18"): ("qwen3", 4, 18, False),
}
TRAIN = [("tp", "qwen3"), ("both", "qwen3"), ("tp", "falcon"),
         ("both", "falcon"), ("tp", "moonshot"), ("tp", "odd-heads")]
# name: (mesh, arch, kv_seq, batch, max_seq)
DECODE = {
    "qwen3": ("tp", "qwen3", (), 8, 32),
    "moonshot": ("tp", "moonshot", (), 8, 32),
    "falcon": ("tp", "falcon", (), 8, 32),
    "h2o-kv-model": ("tp", "h2o", ("model",), 8, 32),
    "qwen3-kv-model": ("tp", "qwen3", ("model",), 8, 32),
    "qwen3-kv-odd-smax": ("tp", "qwen3", ("model",), 8, 30),
    "jamba-kv-data-model": ("both", "jamba", ("data", "model"), 1, 32),
}
SERVE = {"h2o-kv-model": ("tp", "h2o", ("model",)),
         "falcon": ("tp", "falcon", ())}
SERVE_STEPS, SERVE_SLOTS, SERVE_MAX_SEQ = 16, 4, 32
TOL = {"prefill": 2e-5, "decode": 1e-5, "jax": 1e-4}
RANKS_TIMEOUT = 300             # seconds for the spawned ranks

JAX_SHARDED = """
import dataclasses, pickle, sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs as JCFG
from repro.launch.mesh import rules_for_mesh
from repro.models import model as JM
from repro.sharding.rules import (batch_pspec, cache_pspecs, make_constrain,
                                  param_pspecs)
assert len(jax.devices()) == 4, jax.devices()
with open(sys.argv[1], "rb") as f:
    spec = pickle.load(f)
meshes = {n: jax.make_mesh(s, ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
          for n, s in spec["meshes"].items()}
leaf = lambda x: isinstance(x, P)
out = {"prefill": {}, "decode": {}}
for key, c in spec["prefill"].items():
    mesh = meshes[c["mesh"]]
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=leaf)
    rules = rules_for_mesh(mesh, sp=True)
    cfg = dataclasses.replace(JCFG.get_smoke_config(c["arch"]), **c["cfg"])
    params = c["params"]
    b = c["tokens"].shape[0]
    constrain = make_constrain(mesh, rules, b)
    fn = jax.jit(lambda p, t: JM.prefill(p, cfg, t, constrain=constrain)[0],
                 in_shardings=(ns(param_pspecs(params, mesh, rules)),
                               ns(batch_pspec(mesh, rules, 2, b))))
    out["prefill"][key] = np.asarray(fn(params, c["tokens"]))
for key, c in spec["decode"].items():
    mesh = meshes[c["mesh"]]
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=leaf)
    rules = rules_for_mesh(mesh, kv_seq=c["kv_seq"])
    cfg = dataclasses.replace(JCFG.get_smoke_config(c["arch"]), **c["cfg"])
    params = c["params"]
    b = c["tokens"].shape[0]
    cs = cache_pspecs(cfg, mesh, rules, b, c["caches"])
    fn = jax.jit(lambda p, t, k, q: JM.decode_step(p, cfg, t, k, q),
                 in_shardings=(ns(param_pspecs(params, mesh, rules)),
                               ns(batch_pspec(mesh, rules, 2, b)), ns(cs),
                               ns(batch_pspec(mesh, rules, 1, b))))
    logits, caches = fn(params, c["tokens"], c["caches"], c["position"])
    out["decode"][key] = {"logits": np.asarray(logits),
                          "caches": jax.tree.map(np.asarray, caches)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(name):
    arch, kw = ARCHS[name]
    return arch, kw, dataclasses.replace(TCFG.get_smoke_config(arch), **kw)


def _np_params(name, rng):
    """Parameters in the layout of JAX's ``init_params`` for ``name``
    (NumPy leaves, seeded draws): normal over the square root of the
    fan-in for matrices, 0.1 x normal for vectors."""
    arch, kw, _ = _cfg(name)
    jcfg = dataclasses.replace(JCFG.get_smoke_config(arch), **kw)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))

    def draw(leaf):
        scale = leaf.shape[-2] ** -0.5 if len(leaf.shape) > 1 else 0.1
        return (rng.standard_normal(leaf.shape, dtype=np.float32)
                * np.float32(scale)).astype(leaf.dtype)
    return jax.tree.map(draw, shapes)


def _tcfg():
    return TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=10))


def _inputs():
    """Every case's inputs: the rank side's (tensors) and JAX's (NumPy,
    in two parts that run side by side: the decode cases and jamba's
    prefill, and the other prefill cases)."""
    rng = np.random.default_rng(SEED)
    params, np_params = {}, {}

    def case(mesh, name):
        arch, kw, cfg = _cfg(name)
        if name not in params:
            np_params[name] = _np_params(name, rng)
            params[name] = params_from_jax(np_params[name], cfg,
                                           device="cpu")
        return cfg, {"mesh": mesh, "arch": arch, "cfg": kw,
                     "params": params[name]}

    def jax_case(c, **kw):
        name = next(k for k, v in params.items() if v is c["params"])
        return {"mesh": c["mesh"], "arch": c["arch"], "cfg": c["cfg"],
                "params": np_params[name], **kw}

    ranks = {"meshes": MESHES, "prefill": {}, "train": {}, "decode": {},
             "serve": {}}
    jax_in = [{"meshes": MESHES, "prefill": {}, "decode": {}}
              for _ in range(2)]
    for (mesh, key), (name, b, s, with_jax) in PREFILL.items():
        cfg, c = case(mesh, name)
        tokens = rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)
        ranks["prefill"][mesh, key] = dict(c, tokens=torch.from_numpy(
            tokens))
        if with_jax:
            part = jax_in[0 if name == "jamba" else 1]
            part["prefill"][mesh, key] = jax_case(c, tokens=tokens)
    for mesh, name in TRAIN:
        cfg, c = case(mesh, name)
        ranks["train"][mesh, name] = dict(c, batches=[
            make_batch(config_for(cfg, 8, 16), s, device="cpu")
            for s in range(STEPS)])
    for key, (mesh, name, kv_seq, b, smax) in DECODE.items():
        cfg, c = case(mesh, name)
        shapes = M.init_cache(cfg, b, smax, device="meta")
        caches = tree_map(lambda t: rng.standard_normal(
            t.shape, dtype=np.float32) * 0.5, shapes)
        tokens = rng.integers(2, cfg.vocab_size, (b, 1)).astype(np.int32)
        # both sides of a full cache, a wrapped ring and an empty one
        position = rng.integers(0, 2 * smax, b).astype(np.int32)
        position[0] = 0
        ranks["decode"][key] = dict(
            c, kv_seq=kv_seq, max_seq=smax,
            caches=cache_from_jax(caches, device="cpu"),
            tokens=torch.from_numpy(tokens),
            position=torch.from_numpy(position))
        jax_in[0]["decode"][key] = jax_case(
            c, kv_seq=kv_seq, caches=caches, tokens=tokens,
            position=position)
    for key, (mesh, name, kv_seq) in SERVE.items():
        cfg, c = case(mesh, name)
        ranks["serve"][key] = dict(
            c, kv_seq=kv_seq,
            scfg={"slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ},
            prompts=[rng.integers(2, cfg.vocab_size, n) for n in (3, 5, 1, 7)],
            max_new=SERVE_MAX_SEQ, steps=SERVE_STEPS)
    return ranks, jax_in


def _single(ranks):
    """The single-process port on every case."""
    out = {"prefill": {}, "train": {}, "decode": {}, "serve": {}}
    with torch.no_grad():
        for key, c in ranks["prefill"].items():
            out["prefill"][key] = M.prefill(c["params"],
                                            _cfg(PREFILL[key][0])[2],
                                            c["tokens"])[0]
    for key, c in ranks["train"].items():
        cfg, tcfg = _cfg(key[1])[2], _tcfg()
        state = init_train_state(cfg, tcfg, params=c["params"])
        step = make_train_step(cfg, tcfg)
        losses, norms = [], []
        for b in c["batches"]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["train"][key] = {"losses": losses, "grad_norms": norms,
                             "params": state.params}
    for key, c in ranks["decode"].items():
        caches = tree_map(torch.clone, c["caches"])
        logits, caches = M.decode_step(c["params"], _cfg(DECODE[key][1])[2],
                                       c["tokens"], caches, c["position"])
        out["decode"][key] = {"logits": logits, "caches": caches}
    for key, c in ranks["serve"].items():
        cfg, scfg = _cfg(SERVE[key][1])[2], ServeConfig(**c["scfg"])
        state = init_server(cfg, scfg, device="cpu")
        for slot, prompt in enumerate(c["prompts"]):
            state = submit(state, slot, prompt, c["max_new"])
        step = make_serve_step(cfg, scfg, c["params"])
        toks = []
        for _ in range(c["steps"]):
            state, tok = step(state)
            toks.append(tok)
        out["serve"][key] = torch.stack(toks)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_decode")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # leave cores to the spawned ranks
    ranks_in, jax_in = _inputs()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for i, part in enumerate(jax_in):
        with open(tmp / f"jax_in{i}.pkl", "wb") as f:
            pickle.dump(part, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_SHARDED, str(tmp / f"jax_in{i}.pkl"),
             str(tmp / f"jax_out{i}.pkl")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    torch.save(ranks_in, tmp / "inputs.pt")
    ctx = mp.spawn(torch_ranks_worker.sp_decode, args=(WORLD, str(tmp)),
                   nprocs=WORLD, join=False)
    single = _single(ranks_in)
    deadline = time.monotonic() + RANKS_TIMEOUT
    while not ctx.join(timeout=2):
        assert time.monotonic() < deadline, "the ranks did not finish"
    torch.set_num_threads(threads)
    jax_out = {"prefill": {}, "decode": {}}
    for i, proc in enumerate(procs):
        _, err = proc.communicate(timeout=RANKS_TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"jax_out{i}.pkl", "rb") as f:
            part = pickle.load(f)
        for kind in jax_out:
            jax_out[kind].update(part[kind])
    outs = [torch.load(tmp / f"out{WORLD}_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return {"ranks": outs, "single": single, "jax": jax_out,
            "inputs": ranks_in}


def _mesh(name, rank):
    return abstract_mesh(MESHES[name], ("data", "model"), rank=rank)


def _my_rows(whole, got, mesh, rank):
    """The rows of ``whole`` (a global batch's) that ``rank`` holds,
    when ``got`` is a block of them."""
    if got.shape[0] == whole.shape[0]:
        return whole
    rows = got.shape[0]
    d = _mesh(mesh, rank).coords["data"]
    return whole[d * rows:(d + 1) * rows]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)
    assert (got.argmax(-1) == want.argmax(-1)).all(), what


@pytest.mark.parametrize("mesh,case", list(PREFILL))
def test_sp_prefill_equals_one_process(runs, mesh, case):
    want = runs["single"]["prefill"][mesh, case]
    s = PREFILL[mesh, case][2]
    for r, out in enumerate(runs["ranks"]):
        got = out["prefill"][mesh, case]
        # the sequence is split wherever the model axis divides it
        split = s % MESHES[mesh][1] == 0
        assert got["seq_axis"] == ("model" if split else None)
        _close(got["logits"], _my_rows(want, got["logits"], mesh, r),
               TOL["prefill"], f"rank {r}")


@pytest.mark.parametrize("mesh,case", [k for k, v in PREFILL.items()
                                       if v[3]])
def test_sp_prefill_equals_jax_sharded(runs, mesh, case):
    want = runs["jax"]["prefill"][mesh, case]
    for r, out in enumerate(runs["ranks"]):
        got = out["prefill"][mesh, case]["logits"]
        _close(got, _my_rows(want, got, mesh, r), TOL["jax"], f"rank {r}")


@pytest.mark.parametrize("mesh,case", TRAIN)
def test_sp_train_equals_one_process(runs, mesh, case):
    got = runs["ranks"][0]["train"][mesh, case]
    want = runs["single"]["train"][mesh, case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-5)
    for other in runs["ranks"][1:]:
        assert other["train"][mesh, case]["losses"] == got["losses"]
    _check_params(got["params"], tree_leaves(want["params"]),
                  PARAM_TOL["single"])


def _cache_blocks(runs, key, want_caches, tol):
    mesh = DECODE[key][0]
    for r, out in enumerate(runs["ranks"]):
        got = out["decode"][key]
        at = _mesh(mesh, r)
        for a, w, s in zip(tree_leaves(got["caches"]),
                           tree_leaves(want_caches), got["specs"]):
            np.testing.assert_allclose(
                a.numpy(), shard_leaf(torch.as_tensor(np.asarray(w)), s,
                                      at).numpy(), atol=tol, rtol=0,
                err_msg=f"rank {r} {s}")


@pytest.mark.parametrize("key", list(DECODE))
def test_decode_equals_one_process(runs, key):
    want = runs["single"]["decode"][key]
    for r, out in enumerate(runs["ranks"]):
        got = out["decode"][key]["logits"]
        _close(got, _my_rows(want["logits"], got, DECODE[key][0], r),
               TOL["decode"], f"rank {r}")
    _cache_blocks(runs, key, want["caches"], TOL["decode"])


@pytest.mark.parametrize("key", list(DECODE))
def test_decode_equals_jax_sharded(runs, key):
    want = runs["jax"]["decode"][key]
    for r, out in enumerate(runs["ranks"]):
        got = out["decode"][key]["logits"]
        _close(got, _my_rows(want["logits"], got, DECODE[key][0], r),
               TOL["jax"], f"rank {r}")
    _cache_blocks(runs, key, want["caches"], TOL["jax"])


@pytest.mark.parametrize("key", list(DECODE))
def test_init_cache_allocates_only_the_rank_block(runs, key):
    """``init_cache(constrain=)``'s shapes: the global shape divided by
    ``cache_pspecs``' specs, on every rank; somewhere the cache is cut,
    but for the fallback of a cache that ``kv_seq`` does not divide."""
    mesh, name, kv_seq, b, smax = DECODE[key]
    whole = tree_leaves(runs["inputs"]["decode"][key]["caches"])
    cut = 0
    for r, out in enumerate(runs["ranks"]):
        got = out["decode"][key]
        at = _mesh(mesh, r)
        want = [tuple(shard_leaf(w, s, at).shape)
                for w, s in zip(whole, got["specs"])]
        assert got["shapes"] == want
        assert want == [block_shape(w.shape, s, at)
                        for w, s in zip(whole, got["specs"])]
        cut += sum(a != tuple(w.shape) for a, w in zip(want, whole))
    # 2 kv heads do not divide 4 ranks, and 30 positions do not split
    # over them: qwen3-0.6b's caches stay whole without kv_seq and with a
    # cache of 30
    assert (cut == 0) == (key in ("qwen3", "qwen3-kv-odd-smax"))


@pytest.mark.parametrize("key", list(SERVE))
def test_served_tokens_equal_one_process(runs, key):
    want = runs["single"]["serve"][key]
    for out in runs["ranks"]:
        assert torch.equal(out["serve"][key], want)


def test_sequence_fallbacks_follow_jax():
    """``seq_axis``: the model axis under ``sp`` when it is larger than
    1 and divides the sequence (JAX's ``Constrainer.__call__``), else
    None; ``kv_seq``: a cache whose positions ``rules.kv_seq`` does not
    divide is not cut (``cache_pspecs``), and its view is None."""
    cfg = TCFG.get_smoke_config("qwen3-0.6b")
    mesh = abstract_mesh((2, 4), ("data", "model"))
    for sp, s, want in ((True, 16, "model"), (True, 18, None),
                        (False, 16, None)):
        c = make_constrain(mesh, rules_for_mesh(mesh, sp=sp), 4)
        assert c.seq_axis(s) == want
        assert (c.seq(s) is None) == (want is None)
    one = abstract_mesh((2, 1), ("data", "model"))
    assert make_constrain(one, rules_for_mesh(one, sp=True), 4).seq(
        16) is None
    for smax, kv_seq, want in ((32, ("model",), ("model",)),
                               (30, ("model",), ()),
                               (32, ("data", "model"), ("data", "model"))):
        rules = rules_for_mesh(mesh, kv_seq=kv_seq)
        specs = M.cache_specs(cfg, mesh, rules, 1, smax)
        c = make_constrain(mesh, rules, 1, cache_specs=specs)
        view = c.kv_seq(c.cache_block_specs["sub0"]["k"])
        assert (view.axes if view else ()) == want
        if view:
            assert view.n == mesh.axis_size(want) and view.index == 0


def test_decode_attention_in_blocks_equals_one_block():
    """``decode_attention`` over n blocks of cache positions (each
    block's partial at its offset, combined over a stacked block dim)
    against one softmax over the whole cache, on a ring buffer and a
    window: 1e-6 (f32)."""
    gen = torch.Generator().manual_seed(3)
    b, smax, h, k, hd = 3, 32, 8, 2, 16
    q = torch.randn((b, 1, h, hd), generator=gen)
    kc, vc = (torch.randn((b, smax, k, hd), generator=gen)
              for _ in range(2))
    cache_len = torch.tensor([1, 17, 32])
    pos = torch.arange(smax)[None, :]
    for window in (None, 8):
        mask = pos < cache_len[:, None]
        if window is not None:
            mask = mask & (pos >= cache_len[:, None] - window)
        qg = q.reshape(b, k, h // k, hd) / hd ** 0.5
        s = torch.einsum("bkgd,bckd->bkgc", qg, kc)
        p = torch.softmax(s.masked_fill(~mask[:, None, None], -torch.inf),
                          dim=-1)
        whole = torch.einsum("bkgc,bckd->bkgd", p, vc).reshape(b, 1, h, hd)
        for n in (1, 4, 16):
            got = decode_attention(q, kc, vc, cache_len, window=window,
                                   blocks=n)
            torch.testing.assert_close(got, whole, atol=1e-6, rtol=0)
        m, l, o = decode_attention_partial(q, kc, vc, cache_len,
                                           window=window)
        torch.testing.assert_close(
            decode_attention_combine(m, l, o).reshape(b, 1, h, hd), whole,
            atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_sp_and_decode_on_world_one_are_bitwise_the_plain_paths(arch):
    """In-process world of one (gloo): ``train`` with ``sp`` rules, and
    greedy decode through ``decode_step(constrain=)`` with the caches of
    ``init_cache(constrain=)``, equal the plain paths bit for bit (every
    axis has size 1: nothing is split or summed)."""
    cfg = TCFG.get_smoke_config(arch)
    quiet = lambda line: None  # noqa: E731
    plain = train(cfg, steps=2, batch=4, seq=16, device="cpu", log=quiet)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    init_ranks("cpu")
    try:
        mesh = make_local_mesh()
        rules = rules_for_mesh(mesh, sp=True)
        rep = train(cfg, steps=2, batch=4, seq=16, device="cpu", log=quiet,
                    mesh=mesh, rules=rules)
        cs = M.cache_specs(cfg, mesh, rules, 2, 16)
        constrain = make_constrain(mesh, rules, 2, cache_specs=cs)
        tok = torch.tensor([[5], [9]])
        runs = []
        for c in (None, constrain):
            caches = M.init_cache(cfg, 2, 16, device="cpu", constrain=c)
            seq, t = [], tok
            for p in range(6):
                logits, caches = M.decode_step(
                    params, cfg, t, caches,
                    torch.full((2,), p, dtype=torch.int32), constrain=c)
                t = logits.argmax(-1)
                seq.append(logits)
            runs.append(torch.stack(seq))
    finally:
        shutdown_ranks()
    assert rep.losses == plain.losses
    for a, b in zip(tree_leaves(rep.state), tree_leaves(plain.state)):
        assert torch.equal(a, b)
    assert torch.equal(runs[0], runs[1])
