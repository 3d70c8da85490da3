"""Serving driver: continuous batching over the decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --requests 12 --slots 4 --max-new 16

Port of ``repro.launch.serve`` (without ``--ckpt``: checkpoint restore is
a later slice).  Generates batched requests against a randomly
initialised model and reports throughput and per-request latency.  Runs
on the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class ServeReport:
    completed: int
    steps: int
    seconds: float
    tokens: int                  # completed * max_new, as the JAX driver
    latencies: list              # seconds per request, in completion order
    state: object                # the final ServerState

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.seconds

    def line(self) -> str:
        lat = np.asarray(self.latencies)
        return (f"[serve] {self.completed} requests, {self.steps} engine "
                f"steps, {self.seconds:.1f}s -> {self.tok_per_s:.1f} tok/s "
                f"(upper bound incl. prompts), latency mean "
                f"{lat.mean() * 1e3:.0f}ms p99 "
                f"{np.percentile(lat, 99) * 1e3:.0f}ms")


def serve(cfg, params, *, requests: int = 12, slots: int = 4,
          max_new: int = 16, prompt_len: int = 8, max_seq: int = 128,
          temperature: float = 0.0, seed: int = 0) -> ServeReport:
    """Serve ``requests`` random prompts to completion on the device that
    holds ``params``; raises if the slots do not drain within the JAX
    driver's step limit, ``requests * (prompt_len + max_new + 4)``."""
    from repro_torch.serve import (ServeConfig, init_server,
                                   make_serve_step, submit)

    device = params["final_norm"].device
    scfg = ServeConfig(slots=slots, max_seq=max_seq, temperature=temperature)
    state = init_server(cfg, scfg, prompt_max=prompt_len + 1,
                        gen_max=max_new, device=device)
    step = make_serve_step(cfg, scfg, params)

    rng = np.random.default_rng(seed)
    pending = [rng.integers(2, cfg.vocab_size,
                            size=(prompt_len,) if not cfg.num_codebooks
                            else (prompt_len, cfg.num_codebooks))
               for _ in range(requests)]
    gen = torch.Generator(device=device).manual_seed(seed)
    t_submit: dict[int, float] = {}
    done_lat: list[float] = []
    completed = steps = 0
    t0 = time.time()

    active = state.active.cpu().numpy()
    while completed < requests:
        # admission: fill free slots (continuous batching)
        for slot in range(slots):
            if not active[slot] and pending:
                state = submit(state, slot, pending.pop(0), max_new)
                t_submit[slot] = time.time()
                active = state.active.cpu().numpy()
        prev_active = active
        state, _ = step(state, gen)
        steps += 1
        active = state.active.cpu().numpy()
        for slot in np.nonzero(prev_active & ~active)[0]:
            done_lat.append(time.time() - t_submit[int(slot)])
            completed += 1
        if steps > requests * (prompt_len + max_new + 4):
            raise RuntimeError("serving did not drain — scheduler bug")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ServeReport(completed=completed, steps=steps,
                       seconds=time.time() - t0, tokens=completed * max_new,
                       latencies=done_lat, state=state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch import configs as CFG
    from repro_torch.models import model as M

    cfg = CFG.get_smoke_config(args.arch) if args.smoke \
        else CFG.get_config(args.arch)
    params = M.init_params(cfg, device=args.device)
    report = serve(cfg, params, requests=args.requests, slots=args.slots,
                   max_new=args.max_new, prompt_len=args.prompt_len,
                   max_seq=args.max_seq, temperature=args.temperature)
    print(report.line())
    return report


if __name__ == "__main__":
    main()
