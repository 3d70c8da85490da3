"""Telemetry reducers (``repro.core.telemetry`` in NumPy).

Turn the per-event ``StepRecord`` trace of ``engine.run_trace`` and a
final state into analyses: the Fig. 8/9 completion curve, utilization
and power timelines, trace energy, the migration, outage and transfer
timelines, the fleet and spot-spend profiles of an elastic run, a
Gantt chart and a trace summary; ``run_stream``'s per-chunk records into
streaming timelines; and one lane's in-run metrics plane
(``core/metrics.py``) into bucketed timelines, percentiles and a JSON
report (``metrics_report``, schema ``repro.metrics/v1``).
Everything here is NumPy post-processing of tensors brought to the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import state as S

__all__ = ["completion_curve", "utilization_timeline", "watts_timeline",
           "trace_energy_j", "migration_timeline", "failure_timeline",
           "transfer_timeline", "link_utilization_timeline",
           "fleet_timeline", "spot_cost_timeline", "gantt",
           "summarize_trace", "stream_timeline", "summarize_stream_trace",
           "from_metrics", "hist_percentile", "metrics_report",
           "validate_metrics_report", "METRICS_REPORT_SCHEMA"]


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


def fleet_timeline(trace) -> tuple[np.ndarray, np.ndarray]:
    """(times, alive VMs after the step) per event step: the
    autoscaler's scale profile (flat for a non-elastic run)."""
    act = _np(trace.active)
    return _np(trace.time)[act], _np(trace.fleet)[act]


def spot_cost_timeline(trace) -> tuple[np.ndarray, np.ndarray]:
    """(times, cumulative spot $ spent) per event step; the last sample
    is the state's ``scaler.spot_cost``."""
    act = _np(trace.active)
    return _np(trace.time)[act], _np(trace.spot_cost)[act]


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


# ---------------------------------------------------------------------------
# The in-run metrics plane (core/metrics.py)
# ---------------------------------------------------------------------------
_METRICS_INF = 1e29  # first_breach_t sentinel threshold (engine uses 1e30)

METRICS_REPORT_SCHEMA = "repro.metrics/v1"


def from_metrics(dc: S.DatacenterState) -> Dict[str, np.ndarray]:
    """Bucketed timelines from one lane's plane: each bucket's left edge
    (the last is open-ended), the seconds booked into it, and the
    time-weighted bucket means of utilization, watts, fleet, backlog and
    flows (0.0 for buckets no interval touched)."""
    m = dc.metrics
    if _np(m.bucket_dt).ndim != 1:
        raise ValueError("from_metrics reduces one lane; index the batch "
                         "axis first (state.map_tensors(lambda t: t[b], dc))")
    dt = _np(m.bucket_dt).astype(np.float64)
    k = dt.shape[0]
    w = float(_np(m.horizon).astype(np.float64)) / k
    denom = np.maximum(dt, 1e-12)
    mean = lambda x: np.where(dt > 0, _np(x).astype(np.float64) / denom,
                              0.0)
    return {
        "bucket_start": np.arange(k, dtype=np.float64) * w,
        "bucket_dt": dt,
        "utilization": mean(m.bucket_util),
        "watts": mean(m.bucket_watts),
        "fleet": mean(m.bucket_fleet),
        "backlog": mean(m.bucket_backlog),
        "flows": mean(m.bucket_flows),
    }


def hist_percentile(hist, edges, q: float) -> float:
    """The q-th percentile of a histogram: the bin holding it by
    cumulative count, read as the geometric mean of its edges (bins are
    log-spaced), the midpoint of the zero-anchored underflow bin, or the
    lower edge of the open overflow bin.  0.0 when empty."""
    h = _np(hist).astype(np.float64)
    edges = _np(edges).astype(np.float64)
    total = h.sum()
    if total <= 0:
        return 0.0
    c = np.cumsum(h)
    idx = int(np.searchsorted(c, (q / 100.0) * total, side="left"))
    idx = min(idx, len(h) - 1)
    lo, hi = float(edges[idx]), float(edges[idx + 1])
    if hi >= _METRICS_INF:
        return lo
    if lo <= 0.0:
        return hi / 2.0
    return float(np.sqrt(lo * hi))


def metrics_report(dc: S.DatacenterState) -> Dict:
    """JSON-ready report of one lane's plane (schema
    ``repro.metrics/v1``): the bucketed timelines, the three histograms
    and their edges, response p50/p95/p99, the counters, per-host busy
    seconds.  ``first_breach_t`` is None until a breach lands."""
    m = dc.metrics
    tl = from_metrics(dc)
    fb = float(_np(m.first_breach_t).astype(np.float64))
    hist = lambda h: _np(h).astype(np.int64).tolist()
    return {
        "schema": METRICS_REPORT_SCHEMA,
        "enabled": bool(_np(m.enabled)),
        "horizon_s": float(_np(m.horizon).astype(np.float64)),
        "sla_factor": float(_np(m.sla_factor).astype(np.float64)),
        "buckets": {k: v.tolist() for k, v in tl.items()},
        "histograms": {
            "edges": _np(m.edges).astype(np.float64).tolist(),
            "response": hist(m.hist_response),
            "exec": hist(m.hist_exec),
            "wait": hist(m.hist_wait),
        },
        "percentiles": {
            f"response_p{q}": hist_percentile(m.hist_response, m.edges, q)
            for q in (50, 95, 99)
        },
        "counters": {
            "retired": int(_np(m.hist_response).astype(np.int64).sum()),
            "sla_breaches": int(_np(m.sla_breaches)),
            "first_breach_t": None if fb >= _METRICS_INF else fb,
            "peak_backlog": int(_np(m.peak_backlog)),
        },
        "host_busy_s": _np(m.host_busy_s).astype(np.float64).tolist(),
    }


def validate_metrics_report(report: Dict) -> None:
    """Raise ``ValueError`` unless ``report`` is a well-formed v1 report
    (keys, lengths and basic invariants)."""
    if report.get("schema") != METRICS_REPORT_SCHEMA:
        raise ValueError(f"unknown report schema: {report.get('schema')!r}")
    for key in ("enabled", "horizon_s", "sla_factor", "buckets",
                "histograms", "percentiles", "counters", "host_busy_s"):
        if key not in report:
            raise ValueError(f"report missing key: {key}")
    tl = report["buckets"]
    k = len(tl.get("bucket_dt", ()))
    for key in ("bucket_start", "bucket_dt", "utilization", "watts",
                "fleet", "backlog", "flows"):
        if len(tl.get(key, ())) != k or k < 1:
            raise ValueError(f"bucket series {key!r} is not length {k}")
    hs = report["histograms"]
    nb = len(hs.get("response", ()))
    if nb < 2 or len(hs.get("edges", ())) != nb + 1:
        raise ValueError("histogram edges must be one longer than bins")
    for key in ("response", "exec", "wait"):
        h = hs.get(key, ())
        if len(h) != nb or any(int(x) < 0 for x in h):
            raise ValueError(f"histogram {key!r} malformed")
    cnt = report["counters"]
    for key in ("retired", "sla_breaches", "peak_backlog"):
        if int(cnt.get(key, -1)) < 0:
            raise ValueError(f"counter {key!r} must be a non-negative int")
    if sum(int(x) for x in hs["response"]) != int(cnt["retired"]):
        raise ValueError("retired counter disagrees with response histogram")
    fb = cnt.get("first_breach_t")
    if fb is not None and not float(fb) >= 0.0:
        raise ValueError("first_breach_t must be None or >= 0")
    if fb is None and int(cnt["sla_breaches"]) > 0:
        raise ValueError("breaches counted but first_breach_t is None")
