"""Checkpoints and the supervisor on the port, on the CPU: the
counterparts of the non-sharding cases of ``test_checkpoint_ft.py``
(save/restore round trip, async save, atomicity, rotation, the supervisor
resuming exactly), bf16 leaves stored as their bits, and ``launch.serve
--ckpt`` reading a training checkpoint."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as CFG
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.data.synthetic import config_for, make_batch
from repro_torch.ft import (FailureInjector, SimulatedFailure, Supervisor,
                            simulate_sync_training)
from repro_torch.launch.serve import restore_params
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.tree import tree_flatten, tree_leaves


def _tiny(dtype=None):
    cfg = CFG.get_smoke_config("qwen1.5-0.5b")
    if dtype is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    tcfg = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                       total_steps=50))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, tcfg)
    scfg = config_for(cfg, batch=4, seq_len=16)
    return cfg, state, step, scfg


def _equal(a, b):
    pa, la, _ = tree_flatten(a)
    pb, lb, _ = tree_flatten(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and x.device == y.device, p
        assert torch.equal(x, y), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_restore_roundtrip(tmp_path, dtype):
    _, state, step, scfg = _tiny(dtype)
    state, _ = step(state, make_batch(scfg, 0, device="cpu"))
    save(str(tmp_path), 7, state, blocking=True)
    assert latest_step(str(tmp_path)) == 7
    back = restore(str(tmp_path), 7, state)
    _equal(state, back)
    assert int(back.opt.step) == 1 and back.opt.step.dtype == torch.int32


def test_bf16_leaves_are_stored_as_their_bits(tmp_path):
    x = torch.tensor([1.0, -2.5, 3.0e38, 1e-40, float("nan")],
                     dtype=torch.bfloat16)
    tree = {"w": x, "f": torch.arange(3, dtype=torch.float32)}
    save(str(tmp_path), 0, tree)
    manifest = json.loads((tmp_path / "step_0" / "manifest.json").read_text())
    dtypes = {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
    assert dtypes == {"f": "float32", "w": "bfloat16"}
    with np.load(tmp_path / "step_0" / "shard_0.npz") as z:
        assert z["w"].dtype == np.uint16
        assert np.array_equal(z["w"], x.view(torch.int16).numpy().view(
            np.uint16))
    back = restore(str(tmp_path), 0, tree)
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))


def test_async_save_then_restore(tmp_path):
    _, state, _, _ = _tiny()
    t = save(str(tmp_path), 3, state, blocking=False)
    t.join()
    assert latest_step(str(tmp_path)) == 3
    _equal(state, restore(str(tmp_path), 3, state))


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken before ``save`` returns: changing the
    tensors afterwards does not reach the checkpoint."""
    tree = {"w": torch.arange(1000, dtype=torch.float32)}
    t = save(str(tmp_path), 1, tree, blocking=False)
    tree["w"].zero_()
    t.join()
    back = restore(str(tmp_path), 1, tree)
    assert torch.equal(back["w"], torch.arange(1000, dtype=torch.float32))


def test_atomic_no_partial_checkpoints(tmp_path):
    """A tmp dir without manifest must be invisible to latest_step."""
    _, state, _, _ = _tiny()
    save(str(tmp_path), 1, state, blocking=True)
    os.makedirs(tmp_path / "step_2.tmp")
    (tmp_path / "step_2.tmp" / "junk.npz").write_bytes(b"partial")
    assert latest_step(str(tmp_path)) == 1


def test_manager_rotation(tmp_path):
    _, state, _, _ = _tiny()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    got, back = mgr.restore_latest(state)
    assert got == 4
    _equal(state, back)


def test_manager_async_saves_wait(tmp_path):
    _, state, _, _ = _tiny()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, state)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 5
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        state) == (None, None)


def test_supervisor_restarts_and_resumes_exactly(tmp_path):
    _, state, step, scfg = _tiny()
    batch_fn = lambda s: make_batch(scfg, s, device="cpu")  # noqa: E731

    # uninterrupted reference
    ref_state = state
    ref_losses = []
    for s in range(12):
        ref_state, m = step(ref_state, batch_fn(s))
        ref_losses.append(float(m["loss"]))

    sup = Supervisor(ckpt=CheckpointManager(str(tmp_path / "a"), keep=3),
                     step_fn=step, batch_fn=batch_fn, checkpoint_every=4)
    injector = FailureInjector(fail_at_steps=(6, 9))
    final, rep = sup.run(state, total_steps=12, injector=injector)
    assert rep.restarts == 2
    assert rep.final_step == 12
    assert rep.steps_run == 15           # 6 -> back to 4, 9 -> back to 8
    # pure-function-of-step data pipeline => identical trajectory
    assert rep.losses == ref_losses
    for a, b in zip(tree_leaves(final), tree_leaves(ref_state)):
        assert torch.equal(a, b)


def test_failure_injector_fires_once_per_step():
    inj = FailureInjector(fail_at_steps=(2,))
    inj.maybe_fail(1)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(2)
    inj.maybe_fail(2)


def test_serve_restores_training_checkpoint(tmp_path):
    cfg, state, step, scfg = _tiny()
    state, _ = step(state, make_batch(scfg, 0, device="cpu"))
    CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    fresh = init_train_state(cfg, TrainConfig(),
                             torch.Generator().manual_seed(5),
                             device="cpu").params
    back = restore_params(str(tmp_path), fresh)
    _equal(state.params, back)
    save(str(tmp_path / "bare"), 2, state.params)
    _equal(state.params, restore_params(str(tmp_path / "bare"), fresh))
    assert restore_params(str(tmp_path / "empty"), fresh) is fresh


def test_ft_exports_the_straggler_study_beside_the_supervisor():
    rep = simulate_sync_training(n_workers=16, steps=3, slow_frac=0.25,
                                 slow_factor=2.0, seed=1, policy="none",
                                 device="cpu")
    assert rep.mean_step > 0
