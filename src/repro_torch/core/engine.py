"""Discrete-event engine for static scenarios (``repro.core.engine`` in
PyTorch).

Between two events every execution rate is constant, so the event queue
collapses into min-reductions:

    next event = min( t + remaining/rate  over running cloudlets,
                      submit times        of future cloudlets,
                      submit times        of pending VMs )

and the advance is one fused multiply-subtract.  A *full step* is one
event: provision due VMs, fix every rate (two-level scheduling, level 2
through the ``simstep`` kernel), jump the clock, commit progress,
completions, §3.3 costs and per-host joules.

The event-horizon leap (``leap``, on by default as in the JAX engine):
after a full step that ends in a completion, while no decision can
intervene — no arrival before the next completion, no completion that
would reshuffle a surviving rate (``_drain_safe``) — further completions
commit on the step's frozen rates, re-masked, with the step's own f32
arithmetic and no rate pass (``_body``).  Leap on gives the same bits as
leap off.

Every run is a batch of lanes (a single state is a batch of one; see
``core/scheduling.py``), and the host waits for the device once per
block, not once per event.  A step at quiescence is a bit-exact fixed
point, and every other reason for a lane to stop — ``max_steps``,
``horizon``, a VM whose submit time has come, an open leap window — is
masked per lane and per step on the device: a masked step commits
nothing.  At a block boundary the host reads one small tensor: it runs
a block of leap iterations while some lane's window is open, else it
provisions the due lanes, one after another, and runs a block of full
steps.  The blocks' lengths adapt to what the last block did; the
result does not depend on them, and each lane takes the JAX engine's
sequence of events exactly.

This slice ports the static path: no event table, migration, network,
autoscaler or metrics plane.  ``run`` refuses a scenario that needs one
of them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import energy, scheduling
from repro_torch.core.provisioning import (FIRST_FIT, alive_fleet,
                                           pending_due, provision_pending)
from repro_torch.core.scheduling import (HostPlan, Lanes, host_plan,
                                         lane_axis, lane_min, lanes_of)
from repro_torch.core.segments import pairwise_sum
from repro_torch.core.state import (CL_CREATED, CL_DONE, INF, VM_PENDING,
                                    DatacenterState, map_tensors,
                                    tensor_leaves, with_leaves)

__all__ = ["step", "run", "run_stats", "run_trace", "batched_run",
           "batched_run_stats", "RunStats", "StepRecord", "wants_dynamic",
           "wants_network", "wants_elastic", "wants_probes"]

# completion snap band dt * (1 + 1e-5) + 1e-9, mirrored by the oracle's
# _SNAP_REL/_SNAP_ABS.  The constants are the f32 values the JAX engine
# uses (exact in f32, so torch's scalar casts keep them), applied as an
# f32 multiply then an f32 add.
_SNAP_REL = float(np.float32(1.0 + 1e-5))
_SNAP_ABS = float(np.float32(1e-9))

BLOCK = 32          # most steps (or leap iterations) per host check
_LEAP_DEFAULT = True


class StepRecord(NamedTuple):
    """Telemetry of one simulation event (``step``)."""
    time: torch.Tensor          # f32[] time *after* the step
    n_running: torch.Tensor     # i32[] cloudlets with rate > 0 during step
    n_done: torch.Tensor        # i32[] cumulative completed cloudlets
    utilization: torch.Tensor   # f32[] consumed MIPS / total host MIPS
    watts: torch.Tensor         # f32[] fleet power drawn during the step
    active: torch.Tensor        # bool[] this step advanced the simulation
    n_migrating: torch.Tensor   # i32[] VMs mid-migration after the step
    migrations: torch.Tensor    # i32[] cumulative migrations
    hosts_down: torch.Tensor    # i32[] real hosts currently failed
    transferred_mb: torch.Tensor  # f32[] cumulative staged MB
    n_flows: torch.Tensor       # i32[] transfers drawing bandwidth
    n_events: torch.Tensor      # i32[] events committed by this step
    #                                   (> 1 when the leap fired)
    fleet: torch.Tensor         # i32[] alive VMs after the step
    spot_cost: torch.Tensor     # f32[] cumulative spot spend


class RunStats(NamedTuple):
    """What a run did besides its final state (summed over lanes)."""
    n_events: int       # committed events: full steps and leap iterations
    n_full: int         # committed full steps
    n_steps: int        # full steps evaluated, masked ones included
    n_leap: int         # leap iterations evaluated, masked ones included
    n_blocks: int       # host checks


# ---------------------------------------------------------------------------
# One event, on every lane of a batch
# ---------------------------------------------------------------------------
def _arrivals(dc: DatacenterState) -> torch.Tensor:
    """f32[B] earliest future submit time (cloudlet or VM) of each lane.

    Absolute table values, so an arrival that wins the queue sets the
    clock exactly."""
    cl, vms = dc.cloudlets, dc.vms
    t = dc.time[:, None]
    future_cl = (cl.state == CL_CREATED) & (cl.submit_time > t)
    future_vm = (vms.state == VM_PENDING) & (vms.submit_time > t)
    return torch.minimum(lane_min(torch.where(future_cl, cl.submit_time,
                                              INF)),
                         lane_min(torch.where(future_vm, vms.submit_time,
                                              INF)))


def _commit(dc: DatacenterState, lanes: Lanes, plan: HostPlan, rates,
            finish_dt, dt, t_next, *, stamp_start: bool):
    """The commit of one event at ``rates`` ([B, C]) over ``dt`` ([B]),
    clock to ``t_next``.  Returns (new state, host watts f32[B, H])."""
    cl = dc.cloudlets
    executed = rates * dt[:, None]
    snap = dt * _SNAP_REL + _SNAP_ABS
    # the argmin task(s) finish by construction, immune to f32 rounding
    finished = ((cl.state == CL_CREATED) & (rates > 0.0)
                & (finish_dt <= snap[:, None]))
    remaining = torch.where(finished, 0.0,
                            torch.clamp(cl.remaining - executed, min=0.0))
    start_time = cl.start_time
    if stamp_start:
        start_time = torch.where((rates > 0.0) & (cl.start_time < 0.0),
                                 dc.time[:, None], cl.start_time)

    # market accounting (§3.3), summed per lane in a fixed order
    pe = executed / torch.clamp(plan.slot_mips_pe.view_as(executed),
                                min=1e-30)
    moved = torch.where(finished, cl.file_size + cl.output_size, 0.0)
    pe_seconds, moved_mb = pairwise_sum(torch.stack([pe, moved]))

    # energy: rates, hence watts, are constant on [time, time + dt)
    host_watts = energy.host_power(dc.hosts, energy.utilization_of(
        dc.hosts, scheduling.host_consumed(rates.reshape(-1), lanes, plan)))

    new = dataclasses.replace(
        dc,
        hosts=dataclasses.replace(
            dc.hosts,
            energy_j=dc.hosts.energy_j + host_watts * dt[:, None]),
        cloudlets=dataclasses.replace(
            cl, remaining=remaining, start_time=start_time,
            finish_time=torch.where(finished, t_next[:, None],
                                    cl.finish_time),
            state=torch.where(finished, CL_DONE, cl.state).to(torch.int32)),
        acct=dataclasses.replace(
            dc.acct,
            cpu_cost=dc.acct.cpu_cost
            + dc.rates.cost_per_cpu_sec * pe_seconds,
            bw_cost=dc.acct.bw_cost + dc.rates.cost_per_bw * moved_mb),
        time=t_next)
    return new, host_watts


def _full(dc: DatacenterState, lanes: Lanes, plan: HostPlan):
    """One full step of every lane, provisioning excluded.

    Returns (new state, active bool[B], rates f32[B, C], host watts
    f32[B, H], each VM's runnable cloudlets i32[B*V] before the step,
    opens bool[B]: the step was a completion with no arrival at its end
    and some cloudlet keeps its rate, the leap's gate before
    ``_drain_safe``)."""
    rates, dt_finish, counts = scheduling.lane_rates(dc, lanes, plan)
    cl = dc.cloudlets
    # per-slot completion deltas: the kernel's quotient elementwise
    finish_dt = torch.where(rates > 0.0,
                            cl.remaining / torch.clamp(rates, min=1e-30), INF)
    arrive = _arrivals(dc)
    dt_arr = torch.where(arrive < INF, arrive - dc.time, INF)
    dt = torch.minimum(dt_finish, dt_arr)
    active = dt < INF
    dt = torch.where(active, dt, 0.0)
    # arrivals win ties so the clock lands on the exact submitted time
    t_next = torch.where(active,
                         torch.where(dt_arr <= dt_finish, arrive,
                                     dc.time + dt),
                         dc.time)
    new, host_watts = _commit(dc, lanes, plan, rates, finish_dt, dt, t_next,
                              stamp_start=True)
    # a window can commit only while some cloudlet keeps its rate
    survivors = ((rates > 0.0)
                 & (new.cloudlets.state == CL_CREATED)).any(dim=-1)
    opens = (active & (dt_arr > dt_finish) & (arrive > new.time)
             & survivors)
    return new, active, rates, host_watts, counts, opens


def _drain_safe(n_pre, post: DatacenterState, lanes: Lanes,
                plan: HostPlan):
    """(bool[B], ``run_counts`` of ``post``) — per lane, the commit from
    a state with ``n_pre`` runnable cloudlets a VM to ``post`` cannot
    change any surviving rate.

    A completion reshuffles the shares in two ways.  VM-level reshare: a
    VM running more task units than PEs re-splits its capacity when one
    finishes; safe only when ``n_runnable <= req_pes``.  Eligibility
    flip: without ``reserve_pes`` a VM that drains its last runnable unit
    stops competing for its host; safe when the VM keeps work, PEs are
    reserved, or the VM is alone on its host.  Conservative: False
    forgoes a leap, never corrupts one.
    """
    n_post = scheduling.run_counts(scheduling.lane_runnable(post, lanes),
                                   lanes)
    safe = (n_post == n_pre) | ((n_pre <= plan.pes)
                                & ((n_post >= 1) | plan.keeps_work))
    return safe.view(lanes.n_lanes, lanes.n_vms).all(dim=-1), n_post


def _body(dc: DatacenterState, lanes: Lanes, plan: HostPlan, r0, n_now,
          go):
    """One leap iteration on the lanes ``go``: the next completion on the
    frozen rates ``r0`` ([B, C]), re-masked (survivors keep their exact
    f32 rate, guaranteed by ``_drain_safe``; finished ones drop out).
    It commits only when no arrival comes first and it is drain-safe.
    ``n_now`` is ``run_counts`` of ``dc``.  Returns (state, do bool[B],
    ``run_counts`` of the candidate)."""
    cl = dc.cloudlets
    r = torch.where((cl.state == CL_CREATED) & (cl.remaining > 0.0), r0,
                    0.0)
    finish_dt = torch.where(r > 0.0,
                            cl.remaining / torch.clamp(r, min=1e-30), INF)
    dt_fin = lane_min(finish_dt)
    arr = _arrivals(dc)
    d_arr = torch.where(arr < INF, arr - dc.time, INF)
    dt = torch.minimum(dt_fin, d_arr)
    act = dt < INF
    dt = torch.where(act, dt, 0.0)
    t_next = dc.time + dt
    cand, _ = _commit(dc, lanes, plan, r, finish_dt, dt, t_next,
                      stamp_start=False)
    safe, n_post = _drain_safe(n_now, cand, lanes, plan)
    do = go & act & (d_arr > dt_fin) & (arr > t_next) & safe
    return _select(do, cand, dc), do, n_post


def _select(go: torch.Tensor, new: DatacenterState,
            old: DatacenterState) -> DatacenterState:
    """Lane by lane, ``new`` where ``go`` else ``old``, for the fields a
    commit writes."""
    w = lambda a, b: torch.where(go.view(go.shape + (1,) * (a.ndim - 1)),
                                 a, b)
    nc, oc = new.cloudlets, old.cloudlets
    return dataclasses.replace(
        old,
        hosts=dataclasses.replace(
            old.hosts, energy_j=w(new.hosts.energy_j, old.hosts.energy_j)),
        cloudlets=dataclasses.replace(
            oc, remaining=w(nc.remaining, oc.remaining),
            start_time=w(nc.start_time, oc.start_time),
            finish_time=w(nc.finish_time, oc.finish_time),
            state=w(nc.state, oc.state)),
        acct=dataclasses.replace(
            old.acct, cpu_cost=w(new.acct.cpu_cost, old.acct.cpu_cost),
            bw_cost=w(new.acct.bw_cost, old.acct.bw_cost)),
        time=w(new.time, old.time))


def _where_lanes(go: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
                 lanes: Lanes) -> torch.Tensor:
    """[B*X] ``new`` on the entries of the lanes ``go``, else ``old``."""
    return torch.where(go[:, None], new.view(lanes.n_lanes, -1),
                       old.view(lanes.n_lanes, -1)).view(-1)


def _provision_lanes(batch: DatacenterState, which, policy: int
                     ) -> DatacenterState:
    """``provision_pending`` on the lanes ``which``, one after another;
    each leaf it changes is rebuilt once."""
    old = tensor_leaves(batch)
    new = list(old)
    for b in which:
        lane = map_tensors(lambda t: t[b], batch)
        before = tensor_leaves(lane)
        after = tensor_leaves(provision_pending(lane, policy))
        for i, (x, y) in enumerate(zip(before, after)):
            if y is not x:
                if new[i] is old[i]:
                    new[i] = old[i].clone()
                new[i][b] = y
    return with_leaves(batch, new)


# ---------------------------------------------------------------------------
# Static-path guard
# ---------------------------------------------------------------------------
def wants_dynamic(dc: DatacenterState) -> bool:
    """True when the scenario carries an event table, a migration policy,
    or an in-flight migration."""
    return (dc.events.shape[-2] > 0
            or bool((dc.mig_policy != 0).any())
            or bool((dc.vms.mig_remaining > 0.0).any()))


def wants_network(dc: DatacenterState) -> bool:
    """True when the scenario carries an enabled topology."""
    return bool((dc.net.enabled != 0).any())


def wants_elastic(dc: DatacenterState) -> bool:
    """True when the scenario carries an enabled autoscaler or spot track."""
    return bool((dc.scaler.enabled != 0).any()
                or (dc.scaler.spot_enabled != 0).any())


def wants_probes(dc: DatacenterState) -> bool:
    """True when the scenario carries an enabled metrics plane."""
    return bool((dc.metrics.enabled != 0).any())


def _require_static(dc: DatacenterState) -> None:
    for name, wants in (("dynamic", wants_dynamic),
                        ("networked", wants_network),
                        ("elastic", wants_elastic),
                        ("probed", wants_probes)):
        if wants(dc):
            raise NotImplementedError(
                f"repro_torch runs static scenarios only; this one is "
                f"{name} (its slice of the port is not done yet)")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def step(dc: DatacenterState, *, provision_policy: int = FIRST_FIT,
         leap: bool = False, leap_budget=None, leap_horizon=None
         ) -> tuple[DatacenterState, StepRecord]:
    """Process one simulation event of a static scenario; with ``leap``,
    also the run of completions that follows it while no decision can
    intervene (at most ``leap_budget`` more, none at or past
    ``leap_horizon``), counted in ``StepRecord.n_events``.

    At quiescence (no runnable work, no future submissions) the state
    comes back bit-for-bit unchanged with ``active == False``.
    """
    _require_static(dc)
    if bool(pending_due(dc)):
        dc = provision_pending(dc, provision_policy)
    batch = lane_axis(dc)
    lanes = lanes_of(batch)
    plan = host_plan(batch, lanes)
    new, active, rates, host_watts, n_pre, opens = _full(batch, lanes,
                                                         plan)
    dev = rates.device
    n_events = active.to(torch.int32)
    if leap:
        budget = torch.as_tensor(2 ** 30 if leap_budget is None
                                 else leap_budget, device=dev)
        horizon = torch.clamp(torch.as_tensor(
            INF if leap_horizon is None else leap_horizon,
            dtype=torch.float32, device=dev), max=INF)
        safe, n_now = _drain_safe(n_pre, new, lanes, plan)
        window = opens & safe
        extra = torch.zeros_like(n_events)
        while bool(window.any()):
            for _ in range(BLOCK):
                go = window & (extra < budget) & (new.time < horizon)
                new, window, n_post = _body(new, lanes, plan, rates, n_now,
                                            go)
                extra = extra + window.to(torch.int32)
                n_now = _where_lanes(window, n_post, n_now, lanes)
        n_events = n_events + extra
    new = map_tensors(lambda t: t[0], new)
    rates = rates[0]
    valid_mips = torch.where(dc.hosts.valid, dc.hosts.capacity_mips, 0.0)
    count = lambda m: m.sum(dtype=torch.int32)
    rec = StepRecord(
        time=new.time,
        n_running=count(rates > 0.0),
        n_done=count(new.cloudlets.state == CL_DONE),
        utilization=rates.sum() / torch.clamp(valid_mips.sum(), min=1e-30),
        watts=host_watts[0].sum(),
        active=active[0],
        n_migrating=count(new.vms.mig_remaining > 0.0),
        migrations=new.mig_count,
        hosts_down=count(~new.hosts.valid & (new.hosts.num_pes > 0)),
        transferred_mb=new.net_transferred_mb,
        n_flows=torch.zeros((), dtype=torch.int32, device=dev),
        n_events=n_events[0],
        fleet=alive_fleet(new.vms),
        spot_cost=new.scaler.spot_cost)
    return new, rec


def _drive(batch: DatacenterState, *, max_steps: int, horizon: float,
           provision_policy: int, leap: bool, block: int
           ) -> tuple[DatacenterState, RunStats]:
    """Run every lane of ``batch`` to quiescence (see the module's
    docstring)."""
    if block < 1:
        raise ValueError("block must be >= 1")
    dev = batch.time.device
    lanes = lanes_of(batch)
    nb = lanes.n_lanes
    hor = torch.clamp(torch.tensor(horizon, dtype=torch.float32,
                                   device=dev), max=INF)
    i32 = lambda: torch.zeros((nb,), dtype=torch.int32, device=dev)
    n, n_full, used = i32(), i32(), i32()
    alive = torch.ones((nb,), dtype=torch.bool, device=dev)
    window = torch.zeros((nb,), dtype=torch.bool, device=dev)
    r0 = torch.zeros(batch.cloudlets.remaining.shape, dtype=torch.float32,
                     device=dev)
    n_now = torch.zeros((nb * lanes.n_vms,), dtype=torch.int32, device=dev)
    plan = None
    steps_len, leap_len, kind = block, 1, None
    n_steps = n_leap = n_blocks = 0
    while True:
        live = alive & (n < max_steps) & (batch.time < hor)
        live_h, due_h, window_h, used_h = torch.stack(
            [live.to(torch.int32), (live & pending_due(batch)).to(torch.int32),
             window.to(torch.int32), used]).tolist()
        n_blocks += 1
        most = max(used_h)
        if any(window_h):
            # a block of leap iterations.  A new window starts with one
            # (most windows close at their first iteration) and doubles
            # while it stays open; the next step block is as long as the
            # steps it took to open this one
            if kind == "step":
                steps_len, leap_len = max(1, most), 1
            else:
                leap_len = min(block, 2 * leap_len)
            used = torch.zeros_like(used)
            for _ in range(leap_len):
                go = window & (n < max_steps) & (batch.time < hor)
                batch, window, n_post = _body(batch, lanes, plan, r0, n_now,
                                              go)
                n = n + window.to(torch.int32)
                used = used + window.to(torch.int32)
                n_now = _where_lanes(window, n_post, n_now, lanes)
            n_leap += leap_len
            kind = "leap"
            continue
        if kind == "step":
            steps_len = min(block, 2 * steps_len)   # no window opened
        if not any(live_h):
            break
        due_lanes = [b for b, due in enumerate(due_h) if due]
        if due_lanes:
            batch = _provision_lanes(batch, due_lanes, provision_policy)
            plan = None
        if plan is None:
            plan = host_plan(batch, lanes)
        used = torch.zeros_like(used)
        for _ in range(steps_len):
            go = (alive & (n < max_steps) & (batch.time < hor)
                  & ~pending_due(batch) & ~window)
            new, active, rates, _, n_pre, opens = _full(batch, lanes, plan)
            done = (go & active).to(torch.int32)
            if leap:
                safe, n_post = _drain_safe(n_pre, new, lanes, plan)
                gate = (go & opens & safe & (n + done < max_steps)
                        & (new.time < hor))
                window = window | gate
                r0 = torch.where(gate[:, None], rates, r0)
                n_now = _where_lanes(gate, n_post, n_now, lanes)
            batch = _select(go, new, batch)
            n = n + done
            n_full = n_full + done
            used = used + go.to(torch.int32)
            alive = torch.where(go, active, alive)
        n_steps += steps_len
        kind = "step"
    n_events, full = torch.stack([n.sum(), n_full.sum()]).tolist()
    return batch, RunStats(n_events=n_events, n_full=full, n_steps=n_steps,
                           n_leap=n_leap, n_blocks=n_blocks)


def run_stats(dc: DatacenterState, *, max_steps: int = 1_000_000,
              horizon: float = float("inf"),
              provision_policy: int = FIRST_FIT, leap: bool | None = None,
              block: int = BLOCK) -> tuple[DatacenterState, RunStats]:
    """``run``, also returning what it did (``RunStats``)."""
    _require_static(dc)
    out, stats = _drive(lane_axis(dc), max_steps=max_steps,
                        horizon=horizon, provision_policy=provision_policy,
                        leap=_LEAP_DEFAULT if leap is None else leap,
                        block=block)
    return map_tensors(lambda t: t[0], out), stats


def run(dc: DatacenterState, *, max_steps: int = 1_000_000,
        horizon: float = float("inf"), provision_policy: int = FIRST_FIT,
        leap: bool | None = None, block: int = BLOCK) -> DatacenterState:
    """Run a static scenario to quiescence.

    Stops when the event queue is empty, once the clock has passed
    ``horizon`` (simulated seconds), or after ``max_steps`` events, as
    the JAX engine's ``run`` does; ``leap`` (default on) as there.  At
    most ``block`` steps run between two host checks; the result does
    not depend on it.  Raises ``NotImplementedError`` for a dynamic,
    networked, elastic or probed scenario.
    """
    return run_stats(dc, max_steps=max_steps, horizon=horizon,
                     provision_policy=provision_policy, leap=leap,
                     block=block)[0]


def batched_run_stats(batch: DatacenterState, *, max_steps: int,
                      horizon: float = float("inf"),
                      provision_policy: int = FIRST_FIT,
                      leap: bool | None = None, block: int = BLOCK
                      ) -> tuple[DatacenterState, RunStats]:
    """``batched_run``, also returning what it did (``RunStats``, summed
    over lanes)."""
    _require_static(batch)
    return _drive(batch, max_steps=max_steps, horizon=horizon,
                  provision_policy=provision_policy,
                  leap=_LEAP_DEFAULT if leap is None else leap, block=block)


def batched_run(batch: DatacenterState, *, max_steps: int,
                horizon: float = float("inf"),
                provision_policy: int = FIRST_FIT, leap: bool | None = None,
                block: int = BLOCK) -> DatacenterState:
    """Run a batched state (leading lane axis, ``sweep.stack_scenarios``)
    to quiescence.

    Each lane is masked on ``alive & n < max_steps & time < horizon``,
    finished lanes are frozen by a per-lane select, and the loop ends
    when no lane is live.  Every pass runs once for all lanes (one
    simstep launch a full step), and lane i equals ``run`` of that
    scenario bit for bit.
    """
    return batched_run_stats(batch, max_steps=max_steps, horizon=horizon,
                             provision_policy=provision_policy, leap=leap,
                             block=block)[0]


def run_trace(dc: DatacenterState, *, num_steps: int,
              provision_policy: int = FIRST_FIT
              ) -> tuple[DatacenterState, StepRecord]:
    """Run exactly ``num_steps`` events (leap off), keeping telemetry.

    Returns ``(final state, StepRecord trace)`` with every trace leaf
    stacked to [num_steps].  Steps past quiescence are no-ops flagged
    ``active=False``.  One host sync a step.
    """
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    records = []
    for _ in range(num_steps):
        dc, rec = step(dc, provision_policy=provision_policy)
        records.append(rec)
    return dc, StepRecord(*(torch.stack(leaf) for leaf in zip(*records)))
