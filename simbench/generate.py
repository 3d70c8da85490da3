"""The one traffic generator: a call's scenarios as plain NumPy inputs.

A copy of the recipe of ``chip_smoke.py::section5`` (the paper's §5
scenario), rewritten to take a seed and to emit NumPy arrays, so that
the program's builders and the reference read the same inputs.  What a
scenario holds comes from its configuration file, what a call holds
from its traffic file.

The published scenario has no random draw: every VM gets one cloudlet of
``length_mi`` a wave, the waves ``period`` apart.  The seed orders the
VMs' groups of cloudlets in the cloudlet list (each VM's cloudlets stay
one run, waves ascending, as the program's builders ask), so every seed
has the same sizes and arrivals, in another order.  Scenario ``j`` of
call ``i`` of a run with seed ``s`` draws from
``numpy.random.default_rng([s, i, j])``: the parent and the change see
the same sequence, and no two calls of a window repeat a cloudlet list.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Scenario", "scenario", "call_scenarios", "lane_pairs",
           "checked_lanes"]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One scenario's cloudlets: VM ``order[k]``'s waves are slots
    ``k*W .. k*W + W-1``, ascending."""
    order: np.ndarray       # i64[V]    the VMs in cloudlet-list order
    vm: np.ndarray          # i32[V*W]
    length: np.ndarray      # f32[V*W]  MI
    submit: np.ndarray      # f32[V*W]  s


def _entropy(seed: int) -> int:
    """A seed of any sign as the non-negative integer NumPy takes."""
    return int(seed) % (1 << 64)


def scenario(config: dict, seed: int, call: int, index: int) -> Scenario:
    """Scenario ``index`` of call ``call`` under ``config``."""
    rng = np.random.default_rng([_entropy(seed), int(call), int(index)])
    n_vms = int(config["vms"]["count"])
    w = config["waves"]
    n_waves = int(w["count"])
    order = rng.permutation(n_vms).astype(np.int64)
    length = np.full(n_vms * n_waves, float(w["length_mi"]), np.float32)
    submit = np.tile((np.arange(n_waves) * float(w["period"])
                      ).astype(np.float32), n_vms)
    vm = np.repeat(order, n_waves).astype(np.int32)
    return Scenario(order=order, vm=vm, length=length, submit=submit)


def call_scenarios(config: dict, traffic: dict, seed: int, call: int
                   ) -> list[Scenario]:
    """The ``seeds_per_call`` scenarios of one call."""
    return [scenario(config, seed, call, j)
            for j in range(int(traffic["seeds_per_call"]))]


def lane_pairs(traffic: dict) -> list[tuple[int, int]]:
    """(vm_policy, task_policy) of each policy pair of the grid."""
    return [(int(a), int(b)) for a, b in traffic["policy_grid"]]


def checked_lanes(traffic: dict, seed: int, call: int) -> list[int]:
    """The lanes of a call whose every entity is compared with the
    reference: drawn from the seed, a lane ``p * B + b`` being scenario
    ``b`` under policy pair ``p``; each pair appears before any repeats."""
    n_pol = len(traffic["policy_grid"])
    n_scen = int(traffic["seeds_per_call"])
    k = min(int(traffic["checked_lanes_per_call"]), n_pol * n_scen)
    rng = np.random.default_rng([_entropy(seed), int(call), 1 << 20])
    pols = [(int(call) + i) % n_pol for i in range(k)]
    return sorted({p * n_scen + int(rng.integers(n_scen)) for p in pols})
