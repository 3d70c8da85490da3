"""The comparison that decides ``correct``: the program's answers against
the plain reference's, as a few numbers, each held to its limit.

Every lane of every call is compared by its summary (completed
cloudlets, makespan, mean response, total cost, total energy) and every
call by its event count; the checked lanes (``generate.checked_lanes``)
also entity by entity: each VM's host and state, each cloudlet's state,
start and finish, each host's joules, and the memory and storage bills.

The numbers:

* ``mismatch``: answers that must be equal and are not (VM hosts and
  states, cloudlet states, completed counts); limit 0;
* ``events_gap``: how far a call's event count lies from the
  reference's, beyond the events where an f32 clock may merge or split
  a near tie (``reference.s5.AMBIGUOUS_S``); limit 0;
* ``time_gap_s``: the widest gap of a start, finish, makespan or mean
  response, in seconds;
* ``energy_rel``: the widest gap of a host's or a lane's joules, as a
  share of the reference's;
* ``cost_rel``: the widest gap of a lane's total bill, as a share of the
  reference's;
* ``create_rel``: the widest gap of a lane's memory or storage bill, as
  a share of the reference's.  The program adds each placed VM's charge
  to an f32 total one at a time, so many equal charges drift from the
  exact sum; it is held apart from ``cost_rel``, whose terms it would
  swamp.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NAMES", "Checker", "VM_ACTIVE", "VM_FAILED", "CL_CREATED",
           "CL_DONE", "CL_FAILED"]

NAMES = ("mismatch", "events_gap", "time_gap_s", "energy_rel", "cost_rel",
         "create_rel")

# the state codes of the program's output (CloudSim's life cycles)
VM_ACTIVE, VM_FAILED = 2, 3
CL_CREATED, CL_DONE, CL_FAILED = 1, 2, 3


def _np(x) -> np.ndarray:
    return x.detach().to("cpu").double().numpy() if hasattr(x, "detach") \
        else np.asarray(x, np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    if got.size == 0:
        return 0.0
    gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def _abs(got, want) -> float:
    got, want = _np(got), _np(want)
    if got.size == 0:
        return 0.0
    return float(np.nan_to_num(np.abs(got - want), nan=np.inf).max())


class Checker:
    """Accumulates the numbers over the calls of a run."""

    def __init__(self):
        self.values = dict.fromkeys(NAMES, 0.0)
        self.lanes = 0          # lanes compared
        self.failed_lanes = 0   # of them, lanes with an unequal exact
        #                         answer

    def _worst(self, name, value):
        self.values[name] = max(self.values[name], float(value))

    def add_call(self, summary: dict, n_events: int, details: dict, ref):
        """One call: ``summary`` maps ``n_done``, ``makespan``,
        ``mean_response``, ``total_cost`` and ``energy_j`` to arrays over
        its lanes; ``n_events`` is its committed events over all lanes;
        ``details`` maps a checked lane to its entity arrays; ``ref`` is
        the reference's ``LaneResult`` of the same lanes, in order."""
        n_done = _np(summary["n_done"])
        bad = n_done != _np(ref.n_done)
        t_gap = np.maximum(
            np.abs(_np(summary["makespan"]) - _np(ref.makespan)),
            np.abs(_np(summary["mean_response"]) - _np(ref.mean_response)))
        self.values["mismatch"] += int(bad.sum())
        self._worst("time_gap_s", np.nan_to_num(t_gap, nan=np.inf).max()
                    if t_gap.size else 0.0)
        self._worst("energy_rel", _rel(summary["energy_j"], ref.energy_j))
        self._worst("cost_rel", _rel(summary["total_cost"], ref.total_cost))
        want = int(_np(ref.events).sum())
        slack = int(_np(ref.ambiguous).sum())
        self._worst("events_gap", max(0, abs(int(n_events) - want) - slack))
        self.lanes += n_done.size
        lane_bad = bad.copy()
        for lane, d in details.items():
            wrong = self._lane(d, ref, lane)
            lane_bad[lane] |= wrong > 0
            self.values["mismatch"] += wrong
        self.failed_lanes += int(lane_bad.sum())

    def _lane(self, d: dict, ref, lane: int) -> int:
        """Entity-by-entity comparison of one lane; returns the count of
        unequal exact answers and folds the gaps into the numbers."""
        placed = _np(ref.vm_placed[lane]).astype(bool)
        host = np.where(placed, _np(ref.vm_host[lane]), -1)
        wrong = int((np.asarray(d["vm_host"]) != host).sum())
        vm_state = np.where(placed, VM_ACTIVE, VM_FAILED)
        wrong += int((np.asarray(d["vm_state"]) != vm_state).sum())
        done = _np(ref.cl_done[lane]).astype(bool).reshape(-1)
        failed = ~_np(ref.cl_live[lane]).astype(bool).reshape(-1)
        cl_state = np.where(done, CL_DONE, np.where(failed, CL_FAILED,
                                                    CL_CREATED))
        wrong += int((np.asarray(d["cl_state"]) != cl_state).sum())
        both = done & (np.asarray(d["cl_state"]) == CL_DONE)
        start = _np(ref.start[lane]).reshape(-1)
        finish = _np(ref.finish[lane]).reshape(-1)
        self._worst("time_gap_s", max(_abs(d["start"][both], start[both]),
                                      _abs(d["finish"][both],
                                           finish[both])))
        self._worst("energy_rel", _rel(d["energy"], ref.host_energy[lane]))
        self._worst("cost_rel", _rel(d["total_cost"], ref.total_cost[lane]))
        self._worst("create_rel", max(
            _rel(d["mem_cost"], ref.mem_cost[lane]),
            _rel(d["storage_cost"], ref.storage_cost[lane])))
        return wrong

    def verdict(self, limits: dict) -> tuple[bool, dict]:
        """(correct, {name: {"value", "limit"}}) under ``limits``."""
        checks = {k: {"value": self.values[k], "limit": float(limits[k])}
                  for k in NAMES}
        ok = self.lanes > 0 and all(c["value"] <= c["limit"]
                                    for c in checks.values())
        return ok, checks
