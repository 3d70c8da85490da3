"""Telemetry reducers (``repro.core.telemetry`` in NumPy).

Turn the per-event ``StepRecord`` trace of ``engine.run_trace`` and a
final state into analyses: the Fig. 8/9 completion curve, utilization
and power timelines, trace energy, the migration, outage and transfer
timelines, a Gantt chart and a trace summary; and ``run_stream``'s
per-chunk records into streaming timelines.
Everything here is NumPy post-processing of tensors brought to the host.
The metrics-plane reducers come with the slice that ports the plane.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import state as S

__all__ = ["completion_curve", "utilization_timeline", "watts_timeline",
           "trace_energy_j", "migration_timeline", "failure_timeline",
           "transfer_timeline", "link_utilization_timeline", "gantt",
           "summarize_trace", "stream_timeline", "summarize_stream_trace"]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def completion_curve(trace) -> tuple[np.ndarray, np.ndarray]:
    """(times, cumulative completions) — the Fig. 8/9 x/y data."""
    act = _np(trace.active)
    return _np(trace.time)[act], _np(trace.n_done)[act]


def utilization_timeline(trace) -> tuple[np.ndarray, np.ndarray]:
    """(times, fleet MIPS utilization in [0,1]) per event step."""
    act = _np(trace.active)
    return _np(trace.time)[act], _np(trace.utilization)[act]


def watts_timeline(trace) -> tuple[np.ndarray, np.ndarray]:
    """(times, fleet watts) per event step.

    ``watts[i]`` is the power drawn during the interval *ending* at
    ``times[i]`` (rates, hence power, are constant between events).
    """
    act = _np(trace.active)
    return _np(trace.time)[act], _np(trace.watts)[act]


def trace_energy_j(trace) -> float:
    """Total fleet joules, ``sum(watts_i * dt_i)`` over the event grid
    (exact: power is piecewise constant between events)."""
    t, w = watts_timeline(trace)
    if len(t) == 0:
        return 0.0
    dt = np.diff(np.concatenate([[0.0], t]))
    return float(np.sum(np.asarray(w, np.float64) * np.maximum(dt, 0.0)))


def migration_timeline(trace) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(times, cumulative migrations, VMs mid-copy after the step) per
    event step."""
    act = _np(trace.active)
    return (_np(trace.time)[act], _np(trace.migrations)[act],
            _np(trace.n_migrating)[act])


def failure_timeline(trace) -> tuple[np.ndarray, np.ndarray]:
    """(times, failed real hosts) per event step: the outage profile."""
    act = _np(trace.active)
    return _np(trace.time)[act], _np(trace.hosts_down)[act]


def transfer_timeline(trace) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(times, cumulative MB of completed staged transfers after the
    step, transfers that drew bandwidth during it) per event step."""
    act = _np(trace.active)
    return (_np(trace.time)[act], _np(trace.transferred_mb)[act],
            _np(trace.n_flows)[act])


def link_utilization_timeline(trace, wan_bw_mbps: float
                              ) -> tuple[np.ndarray, np.ndarray]:
    """(times, WAN gateway utilization in [0, 1]) per event step: each
    interval's completed MB over its length, over the gateway's MB/s."""
    t, mb, _ = transfer_timeline(trace)
    if len(t) == 0:
        return t, np.zeros(0, dtype=mb.dtype)
    dt = np.diff(np.concatenate([[0.0], t]))
    dmb = np.diff(np.concatenate([[0.0], mb]))
    util = np.where(dt > 0, dmb / np.maximum(dt, 1e-12), 0.0)
    return t, np.clip(util / max(float(wan_bw_mbps), 1e-12), 0.0, 1.0)


def stream_timeline(recs) -> Dict[str, np.ndarray]:
    """Per-chunk timelines from ``engine.run_stream``'s records: the
    clock when the chunk ended, the window's occupancy then (never more
    than W), the running peak occupancy and backlog, the cumulative
    retired and failed counts, and the events spent in the chunk."""
    return {name: _np(getattr(recs, name)) for name in (
        "time", "occupancy", "peak_occupancy", "max_backlog", "n_retired",
        "n_failed", "n_events")}


def summarize_stream_trace(recs) -> Dict[str, float]:
    """Scalar roll-up of a streamed lane's per-chunk records."""
    tl = stream_timeline(recs)
    if tl["time"].size == 0:
        return {"chunks": 0, "makespan": 0.0, "peak_occupancy": 0,
                "max_backlog": 0, "retired": 0, "failed": 0, "events": 0}
    return {
        "chunks": int(tl["time"].size),
        "makespan": float(tl["time"][-1]),
        "peak_occupancy": int(tl["peak_occupancy"][-1]),
        "max_backlog": int(tl["max_backlog"][-1]),
        "retired": int(tl["n_retired"][-1]),
        "failed": int(tl["n_failed"][-1]),
        "events": int(tl["n_events"].sum()),
    }


def gantt(dc: S.DatacenterState) -> Dict[int, list]:
    """Per-VM list of (cloudlet slot, start, finish) for completed tasks."""
    cl = dc.cloudlets
    state, vm = _np(cl.state), _np(cl.vm)
    st, ft = _np(cl.start_time), _np(cl.finish_time)
    out: Dict[int, list] = {}
    for i in np.nonzero(state == S.CL_DONE)[0]:
        out.setdefault(int(vm[i]), []).append(
            (int(i), float(st[i]), float(ft[i])))
    return out


def summarize_trace(trace) -> Dict[str, float]:
    """Events, makespan, time-weighted and peak utilization and watts,
    energy, and the last or peak value of each counter of the trace."""
    act = _np(trace.active)
    util = _np(trace.utilization)[act]
    watts = _np(trace.watts)[act]
    t = _np(trace.time)[act]
    if len(t) == 0:
        return {"events": 0, "makespan": 0.0, "mean_util": 0.0,
                "peak_util": 0.0, "energy_total_j": 0.0,
                "mean_watts": 0.0, "peak_watts": 0.0,
                "migrations": 0, "peak_hosts_down": 0,
                "transferred_mb": 0.0, "peak_flows": 0,
                "peak_fleet": 0, "spot_cost": 0.0}
    # time-weighted means over event intervals (interval i ends at t[i])
    dt = np.diff(np.concatenate([[0.0], t]))
    weights = np.maximum(dt, 1e-12)
    return {
        "events": int(act.sum()),
        "makespan": float(t[-1]),
        "mean_util": float(np.average(util, weights=weights)),
        "peak_util": float(util.max()),
        "energy_total_j": trace_energy_j(trace),
        "mean_watts": float(np.average(watts, weights=weights)),
        "peak_watts": float(watts.max()),
        "migrations": int(_np(trace.migrations)[act][-1]),
        "peak_hosts_down": int(_np(trace.hosts_down)[act].max()),
        "transferred_mb": float(_np(trace.transferred_mb)[act][-1]),
        "peak_flows": int(_np(trace.n_flows)[act].max()),
        "peak_fleet": int(_np(trace.fleet)[act].max()),
        "spot_cost": float(_np(trace.spot_cost)[act][-1]),
    }
