#!/usr/bin/env python
"""bf16 losses across ranks against one device, on the CPU: qwen3-0.6b's
smoke config, 8 x 64 tokens, AdamW (peak lr 3e-3, warmup 2), 3 steps.

JAX's jitted ``make_train_step`` (in a subprocess with 4 forced CPU
devices and ``AxisType.Auto`` axes) with ``rules_for_mesh(mesh,
sp=True)`` and with tensor parallelism alone on (1, 4), and data
parallelism on (4, 1), each against one device; the port's
``make_train_step`` on 4 gloo ranks with the same rules on (1, 4)
against one process, from the same parameters (seeded NumPy draws in
JAX's layout, carried over by ``models.convert.params_from_jax``) and
batches.  Prints each run's losses and largest relative difference, and
the first step's gradients leaf by leaf (the port's sp and tensor
parallelism against one process: largest absolute differences).

Run from the repo root (dtype, a scratch directory, the seed)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sp_bf16_witness.py \\
        bfloat16 /tmp/sp_witness 0
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH, B, S, STEPS, LR, WARMUP = "qwen3-0.6b", 8, 64, 3, 3e-3, 2

JAX_SIDE = r'''
import dataclasses, pickle, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs as JCFG
from repro.launch.mesh import rules_for_mesh
from repro.sharding.rules import batch_pspec, make_constrain, param_pspecs
from repro.train import AdamWConfig, TrainConfig, make_train_step
from repro.train.optimizer import OptState, adamw_init
from repro.train.step import TrainState
inp = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(JCFG.get_smoke_config(inp["arch"]),
                          dtype=inp["dtype"])
tcfg = TrainConfig(opt=AdamWConfig(peak_lr=inp["lr"],
                                   warmup_steps=inp["warmup"],
                                   total_steps=10))
params = jax.tree.map(jnp.asarray, inp["params"])
leafp = lambda x: isinstance(x, P)
out = {}
for name, shape, sp in (("one", None, False), ("sp(1,4)", (1, 4), True),
                        ("tp(1,4)", (1, 4), False),
                        ("dp(4,1)", (4, 1), False)):
    sh = None
    if shape is None:
        step = jax.jit(make_train_step(cfg, tcfg))
    else:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        rules = rules_for_mesh(mesh, sp=sp)
        ps = param_pspecs(params, mesh, rules)
        ns = lambda s: NamedSharding(mesh, s)
        sh = jax.tree.map(ns, TrainState(
            params=ps, opt=OptState(step=P(), m=ps, v=ps), ef_error=None),
            is_leaf=leafp)
        bs = {k: ns(batch_pspec(mesh, rules, 2, inp["B"]))
              for k in ("tokens", "targets")}
        step = jax.jit(make_train_step(
            cfg, tcfg, constrain=make_constrain(mesh, rules, inp["B"])),
            in_shardings=(sh, bs))
    st = TrainState(params=params, opt=adamw_init(params), ef_error=None)
    losses = []
    for b in inp["batches"]:
        if sh is not None:
            st = jax.device_put(st, sh)
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    out[name] = losses
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def _port(dtype):
    import torch  # noqa: F401
    from repro_torch import configs as CFG
    from repro_torch.train import AdamWConfig, TrainConfig
    cfg = dataclasses.replace(CFG.get_smoke_config(ARCH), dtype=dtype)
    return cfg, TrainConfig(opt=AdamWConfig(peak_lr=LR, warmup_steps=WARMUP,
                                            total_steps=10))


def _losses(cfg, tcfg, params, batches, constrain=None):
    from repro_torch.train import init_train_state, make_train_step
    state = init_train_state(cfg, tcfg, params=params)
    step = make_train_step(cfg, tcfg, constrain=constrain)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + (k,)))
        else:
            out["/".join(pre + (k,))] = v
    return out


def rank_body(rank, world, tmp, dtype):
    """One gloo rank: sp and TP on (1, 4), the first step's gradients
    gathered whole and 3 steps' losses; rank 0 saves them."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import init_ranks, make_mesh, rules_for_mesh
    from repro_torch.sharding.rules import (make_constrain, param_pspecs,
                                            shard_leaf)
    from repro_torch.train.step import _sum_over_ranks, loss_and_grads
    from repro_torch.tree import tree_map
    init_ranks("cpu", rank=rank, world_size=world,
               init_method=f"file://{os.path.join(tmp, 'store')}")
    inp = torch.load(os.path.join(tmp, "port_in.pt"), weights_only=False)
    cfg, tcfg = _port(dtype)
    out = {}
    for name, sp in (("sp(1,4)", True), ("tp(1,4)", False)):
        mesh = make_mesh((1, world), ("data", "model"))
        rules = rules_for_mesh(mesh, sp=sp)
        specs = param_pspecs(inp["params"], mesh, rules)
        params = tree_map(lambda p, s: shard_leaf(p, s, mesh),
                          inp["params"], specs)
        c = make_constrain(mesh, rules, B, param_specs=specs)
        g = _sum_over_ranks(loss_and_grads(params, cfg, inp["batches"][0],
                                           constrain=c)[2], c)

        def whole(leaf, spec):
            for d, e in enumerate(spec):
                if e is not None and mesh.axis_size(e) > 1:
                    leaf = mesh.all_gather(leaf, e, d)
            return leaf
        with torch.no_grad():
            g = tree_map(whole, g, specs)
        out[name] = {"losses": _losses(cfg, tcfg, params, inp["batches"], c),
                     "grads": g}
    if rank == 0:
        torch.save(out, os.path.join(tmp, "port_out.pt"))


def main():
    dtype, tmp = sys.argv[1], sys.argv[2]
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    os.makedirs(tmp, exist_ok=True)
    sys.path.insert(0, SRC)
    import jax
    from repro import configs as JCFG
    from repro.models import model as JM
    rng = np.random.default_rng(seed)
    jcfg = dataclasses.replace(JCFG.get_smoke_config(ARCH), dtype=dtype)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))

    def draw(leaf):
        scale = leaf.shape[-2] ** -0.5 if len(leaf.shape) > 1 else 0.1
        return (rng.standard_normal(leaf.shape, dtype=np.float32)
                * np.float32(scale)).astype(leaf.dtype)
    np_params = jax.tree.map(draw, shapes)
    batches = [{k: rng.integers(2, jcfg.vocab_size, (B, S)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(STEPS)]
    with open(os.path.join(tmp, "jax_in.pkl"), "wb") as f:
        pickle.dump({"arch": ARCH, "dtype": dtype, "B": B, "lr": LR,
                     "warmup": WARMUP, "params": np_params,
                     "batches": batches}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, os.path.join(tmp, "jax_in.pkl"),
         os.path.join(tmp, "jax_out.pkl")], env=env)

    import torch
    import torch.multiprocessing as mp
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train.step import loss_and_grads
    cfg, tcfg = _port(dtype)
    params = params_from_jax(np_params, cfg, device="cpu")
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    torch.save({"params": params, "batches": tb},
               os.path.join(tmp, "port_in.pt"))
    ctx = mp.spawn(rank_body, args=(4, tmp, dtype), nprocs=4, join=False)
    g1 = _flat(loss_and_grads(params, cfg, tb[0])[2])
    one = _losses(cfg, tcfg, params, tb)
    while not ctx.join(timeout=2):
        pass
    assert jax_proc.wait() == 0, "the JAX side failed"
    jax_out = pickle.load(open(os.path.join(tmp, "jax_out.pkl"), "rb"))
    port = torch.load(os.path.join(tmp, "port_out.pt"), weights_only=False)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    print(f"{ARCH} smoke, {dtype}, {B} x {S}, {STEPS} steps, seed {seed}")
    for k, v in jax_out.items():
        print(f"JAX  {k:8s} {v} largest relative difference from one "
              f"device {rel(v, jax_out['one']):.3e}")
    print(f"port one      {one} (from JAX's one device "
          f"{rel(one, jax_out['one']):.3e})")
    for k, v in port.items():
        print(f"port {k:8s} {v['losses']} largest relative difference from "
              f"one process {rel(v['losses'], one):.3e}")
    fs, ft = _flat(port["sp(1,4)"]["grads"]), _flat(port["tp(1,4)"]["grads"])
    print(f"{'leaf':28s} {'max |g|':>10s} {'sp - one':>10s} {'tp - one':>10s}")
    for k, a in g1.items():
        a = a.float()
        print(f"{k:28s} {float(a.abs().max()):10.3e} "
              f"{float((fs[k].float() - a).abs().max()):10.3e} "
              f"{float((ft[k].float() - a).abs().max()):10.3e}")


if __name__ == "__main__":
    main()
