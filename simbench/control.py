#!/usr/bin/env python3
"""The readings the limits of ``correct`` were set from.

    python3 simbench/control.py --workload <name> --seeds 1 2 3 ...

On the CUDA card.  For each seed, in one process: one call of the
program at the cell's own size, compared with the float64 reference
(the sound runs' readings), then the control, which is the reference computed in bfloat16 (the
precision below the configuration's float32) put in the program's
place and compared in the same way.  One JSON line a seed, then the
largest sound reading and the smallest control reading of each number,
and whether each side passes the cell's limits.  The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))
sys.path.insert(0, str(CHECKOUT / "src"))


def as_program(result, lanes) -> tuple[dict, int, dict]:
    """A reference's ``LaneResult`` in the program's output form: the
    per-lane summary, the event count and the checked lanes' arrays."""
    from simbench import compare
    n = lambda t: t.detach().cpu().double().numpy()
    summary = {"n_done": n(result.n_done), "makespan": n(result.makespan),
               "mean_response": n(result.mean_response),
               "total_cost": n(result.total_cost),
               "energy_j": n(result.energy_j)}
    details = {}
    for lane in lanes:
        placed = n(result.vm_placed[lane]).astype(bool)
        done = n(result.cl_done[lane]).astype(bool).reshape(-1)
        live = n(result.cl_live[lane]).astype(bool).reshape(-1)
        details[lane] = {
            "vm_host": n(result.vm_host[lane]).astype(int),
            "vm_state": (compare.VM_ACTIVE * placed
                         + compare.VM_FAILED * ~placed),
            "cl_state": np.where(done, compare.CL_DONE, np.where(
                live, compare.CL_CREATED, compare.CL_FAILED)),
            "start": n(result.start[lane]).reshape(-1),
            "finish": n(result.finish[lane]).reshape(-1),
            "energy": n(result.host_energy[lane]),
            "mem_cost": n(result.mem_cost[lane]),
            "storage_cost": n(result.storage_cost[lane]),
            "total_cost": n(result.total_cost[lane])}
    return summary, int(n(result.events).sum()), details


def control_checker(driver, dtype):
    """The reference in ``dtype`` in the program's place, for the calls
    the driver kept, compared with the float64 reference."""
    import torch

    from simbench import compare, generate
    from simbench.reference import s5 as reference
    checker = compare.Checker()
    for index, _, _, details in driver.kept:
        scen = generate.call_scenarios(driver.config, driver.traffic,
                                       driver.seed, index)
        lanes = [(p, sc) for p in driver.pairs for sc in scen]
        args = ([sc for _, sc in lanes], [p for p, _ in lanes])
        low = reference.simulate(driver.config, *args, dtype=dtype,
                                 device=driver.device)
        ref = reference.simulate(driver.config, *args, dtype=torch.float64,
                                 device=driver.device)
        checker.add_call(*as_program(low, list(details)), ref)
    return checker


def readings(root: Path, workload: str, seeds, device, config=None,
             traffic=None) -> dict:
    """Each seed's sound and control readings, and the extremes."""
    import torch

    from simbench import harness
    bench = harness.Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell) if config is None else config
    traffic = bench.traffic(cell) if traffic is None else traffic
    limits = bench.limits(cell)
    drivers = importlib.import_module(f"simbench.drivers.{config['kind']}")
    rows = []
    for seed in seeds:
        driver = drivers.Driver(config, traffic, seed, torch.device(device))
        driver.call(1)
        sound_ok, sound = driver.check().verdict(limits)
        ctrl_ok, ctrl = control_checker(driver, torch.bfloat16).verdict(
            limits)
        rows.append({"seed": seed, "sound_correct": sound_ok,
                     "control_correct": ctrl_ok,
                     "sound": {k: v["value"] for k, v in sound.items()},
                     "control": {k: v["value"] for k, v in ctrl.items()}})
        print(json.dumps(rows[-1]), flush=True)
    names = list(rows[0]["sound"])
    return {"workload": workload, "seeds": list(seeds),
            "lower": {k: max(r["sound"][k] for r in rows) for k in names},
            "upper": {k: min(r["control"][k] for r in rows) for k in names},
            "limits": limits,
            "sound_all_correct": all(r["sound_correct"] for r in rows),
            "control_any_correct": any(r["control_correct"] for r in rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    out = readings(CHECKOUT, args.workload, args.seeds, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
