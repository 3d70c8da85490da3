"""End-to-end training on the port: a qwen-family model trained for a few
hundred steps on the synthetic pipeline, with checkpoint/restart fault
injection: the counterpart of ``examples/train_smoke.py``.

    PYTHONPATH=src python examples/torch_train_smoke.py [--steps 300] \
        [--m100] [--device cpu]

Default is the ~5M smoke config for 300 steps.  --m100 switches to a
~100M-parameter bf16 config.  On the CUDA device (the default) the
attention's forward and backward run through the hand-written kernels.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.synthetic import config_for, make_batch
from repro_torch.device import resolve_device
from repro_torch.ft import FailureInjector, Supervisor
from repro_torch.models.config import ModelConfig, uniform_pattern
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step)

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--m100", action="store_true")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
args = ap.parse_args()
device = resolve_device(args.device)

if args.m100:
    cfg = ModelConfig(name="repro-100m", num_layers=12, d_model=768,
                      num_heads=12, num_kv_heads=4, head_dim=64,
                      d_ff=2048, vocab_size=32000,
                      pattern=uniform_pattern(), tie_embeddings=True)
    batch, seq = 4, 256
else:
    cfg = ModelConfig(name="repro-5m", num_layers=4, d_model=128,
                      num_heads=8, num_kv_heads=2, head_dim=16,
                      d_ff=512, vocab_size=2048,
                      pattern=uniform_pattern(), dtype="float32")
    batch, seq = 16, 64

print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params on {device}")
tcfg = TrainConfig(opt=AdamWConfig(peak_lr=3e-3,
                                   warmup_steps=args.steps // 20,
                                   total_steps=args.steps))
state = init_train_state(cfg, tcfg, device=device)
step = make_train_step(cfg, tcfg)
scfg = config_for(cfg, batch, seq)

with tempfile.TemporaryDirectory() as d:
    sup = Supervisor(ckpt=CheckpointManager(d, keep=2), step_fn=step,
                     batch_fn=lambda s: make_batch(scfg, s, device=device),
                     checkpoint_every=max(args.steps // 6, 10))
    injector = FailureInjector(fail_at_steps=(args.steps // 2,))
    state, rep = sup.run(state, total_steps=args.steps, injector=injector)

k = max(len(rep.losses) // 10, 1)
curve = " -> ".join(f"{np.mean(rep.losses[i:i+k]):.3f}"
                    for i in range(0, len(rep.losses), k))
print(f"loss: {curve}")
print(f"steps={rep.steps_run} restarts={rep.restarts} "
      f"(injected failure at step {args.steps // 2} recovered from "
      f"checkpoint)")
assert rep.losses[-1] < rep.losses[0] * 0.8, "training failed to converge"
print("OK: loss decreased through a simulated node failure.")
