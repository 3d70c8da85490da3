"""Discrete-event engine for static scenarios (``repro.core.engine`` in
PyTorch).

Between two events every execution rate is constant, so the event queue
collapses into min-reductions:

    next event = min( t + remaining/rate  over running cloudlets,
                      submit times        of future cloudlets,
                      submit times        of pending VMs )

and the advance is one fused multiply-subtract.  One ``step`` is one
event: provision due VMs, fix every rate (two-level scheduling, level 2
through the ``simstep`` kernel), jump the clock, commit progress,
completions, §3.3 costs and per-host joules.

This slice ports the static path: no event table, migration, network,
autoscaler, metrics plane or event-horizon leap.  ``run`` refuses a
scenario that needs one of them.

``run`` steps in blocks so the host waits for the device once per block,
not once per event.  A step at quiescence is a bit-exact fixed point, and
every other reason to stop — ``max_steps``, ``horizon``, a VM whose
submit time has come — is masked per step on the device: a masked step
commits nothing, and every later step of its block is masked too.  At the
block boundary the host provisions the due VMs and goes on, which
reproduces the JAX engine's sequence of steps exactly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import energy, scheduling
from repro_torch.core.provisioning import (FIRST_FIT, alive_fleet,
                                           pending_due, provision_pending)
from repro_torch.core.state import (CL_CREATED, CL_DONE, INF, VM_PENDING,
                                    DatacenterState)
from repro_torch.kernels.simstep.ops import RowIndex, row_index

__all__ = ["step", "run", "run_stats", "RunStats", "StepRecord",
           "wants_dynamic", "wants_network", "wants_elastic", "wants_probes"]

# completion snap band dt * (1 + 1e-5) + 1e-9, mirrored by the oracle's
# _SNAP_REL/_SNAP_ABS.  The constants are the f32 values the JAX engine
# uses (exact in f32, so torch's scalar casts keep them), applied as an
# f32 multiply then an f32 add.
_SNAP_REL = float(np.float32(1.0 + 1e-5))
_SNAP_ABS = float(np.float32(1e-9))

BLOCK = 32      # steps per host check in ``run``


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
    fleet: torch.Tensor         # i32[] alive VMs after the step
    spot_cost: torch.Tensor     # f32[] cumulative spot spend


class RunStats(NamedTuple):
    """What a ``run`` did besides its final state."""
    n_events: int       # committed (active) steps
    n_steps: int        # steps evaluated, masked ones included
    n_blocks: int       # host checks


def _min_or_inf(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return torch.full((), INF, dtype=torch.float32, device=x.device)
    return x.amin()


def _next_event_deltas(dc: DatacenterState, rates: torch.Tensor):
    """(finish_dt[C], arrive) — per-slot completion deltas and the earliest
    arrival.

    Completions are *deltas* (``remaining / rate``, the kernel's quotient
    elementwise; their minimum is the kernel's ``dt_min``), so one 1e-6 s
    away still advances the state when ``time + dt == time`` in f32.
    Arrivals (cloudlet and VM submit times) are the *absolute* table
    values, so an arrival that wins the queue sets the clock exactly.
    """
    cl, vms = dc.cloudlets, dc.vms
    finish_dt = torch.where(rates > 0.0,
                            cl.remaining / torch.clamp(rates, min=1e-30), INF)
    future_cl = (cl.state == CL_CREATED) & (cl.submit_time > dc.time)
    arr_cl = _min_or_inf(torch.where(future_cl, cl.submit_time, INF))
    future_vm = (vms.state == VM_PENDING) & (vms.submit_time > dc.time)
    arr_vm = _min_or_inf(torch.where(future_vm, vms.submit_time, INF))
    return finish_dt, torch.minimum(arr_cl, arr_vm)


def _advance(dc: DatacenterState, index: RowIndex):
    """The rate pass and the commit of one event, provisioning excluded.

    Returns (new state, active, rates, host watts).
    """
    rates, dt_finish = scheduling.rates_and_dt(dc, index)
    finish_dt, arrive = _next_event_deltas(dc, rates)
    cl, vms = dc.cloudlets, dc.vms

    dt_arr = torch.where(arrive < INF, arrive - dc.time, INF)
    dt = torch.minimum(dt_finish, dt_arr)
    active = dt < INF
    dt = torch.where(active, dt, 0.0)
    # arrivals win ties so the clock lands on the exact submitted time
    t_next = torch.where(active,
                         torch.where(dt_arr <= dt_finish, arrive,
                                     dc.time + dt),
                         dc.time)

    executed = rates * dt
    snap = dt * _SNAP_REL + _SNAP_ABS
    # the argmin task(s) finish by construction, immune to f32 rounding
    finished = (cl.state == CL_CREATED) & (rates > 0.0) & (finish_dt <= snap)
    remaining = torch.where(finished, 0.0,
                            torch.clamp(cl.remaining - executed, min=0.0))
    started = (rates > 0.0) & (cl.start_time < 0.0)

    # market accounting (§3.3)
    nv = vms.req_pes.shape[0]
    nh = dc.hosts.num_pes.shape[0]
    host_of_cl = vms.host[torch.clamp(cl.vm, 0, nv - 1).long()]
    mips_pe = dc.hosts.mips_per_pe[torch.clamp(host_of_cl, 0, nh - 1).long()]
    pe_seconds = torch.sum(executed / torch.clamp(mips_pe, min=1e-30))
    moved_mb = torch.sum(torch.where(finished, cl.file_size + cl.output_size,
                                     0.0))

    # energy: rates, hence watts, are constant on [time, time + dt)
    host_watts = energy.step_power(dc, rates)

    new = dataclasses.replace(
        dc,
        hosts=dataclasses.replace(
            dc.hosts, energy_j=dc.hosts.energy_j + host_watts * dt),
        cloudlets=dataclasses.replace(
            cl, remaining=remaining,
            start_time=torch.where(started, dc.time, cl.start_time),
            finish_time=torch.where(finished, t_next, cl.finish_time),
            state=torch.where(finished, CL_DONE, cl.state).to(torch.int32)),
        acct=dataclasses.replace(
            dc.acct,
            cpu_cost=dc.acct.cpu_cost
            + dc.rates.cost_per_cpu_sec * pe_seconds,
            bw_cost=dc.acct.bw_cost + dc.rates.cost_per_bw * moved_mb),
        time=t_next)
    return new, active, rates, host_watts


def _select(go: torch.Tensor, new: DatacenterState,
            old: DatacenterState) -> DatacenterState:
    """``new`` where ``go`` else ``old``, for the fields ``_advance``
    writes."""
    w = lambda a, b: torch.where(go, a, b)
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


def step(dc: DatacenterState, *, provision_policy: int = FIRST_FIT
         ) -> tuple[DatacenterState, StepRecord]:
    """Process exactly one simulation event of a static scenario.

    At quiescence (no runnable work, no future submissions) the state
    comes back bit-for-bit unchanged with ``active == False``.
    """
    _require_static(dc)
    if bool(pending_due(dc)):
        dc = provision_pending(dc, provision_policy)
    index = row_index(dc.cloudlets.vm, dc.vms.req_pes.shape[0])
    new, active, rates, host_watts = _advance(dc, index)
    valid_mips = torch.where(dc.hosts.valid, dc.hosts.capacity_mips, 0.0)
    count = lambda m: m.sum(dtype=torch.int32)
    rec = StepRecord(
        time=new.time,
        n_running=count(rates > 0.0),
        n_done=count(new.cloudlets.state == CL_DONE),
        utilization=rates.sum() / torch.clamp(valid_mips.sum(), min=1e-30),
        watts=host_watts.sum(),
        active=active,
        n_migrating=count(new.vms.mig_remaining > 0.0),
        migrations=new.mig_count,
        hosts_down=count(~new.hosts.valid & (new.hosts.num_pes > 0)),
        transferred_mb=new.net_transferred_mb,
        n_flows=torch.zeros((), dtype=torch.int32, device=rates.device),
        n_events=active.to(torch.int32),
        fleet=alive_fleet(new.vms),
        spot_cost=new.scaler.spot_cost)
    return new, rec


def run_stats(dc: DatacenterState, *, max_steps: int = 1_000_000,
              horizon: float = float("inf"),
              provision_policy: int = FIRST_FIT, block: int = BLOCK
              ) -> tuple[DatacenterState, RunStats]:
    """``run``, also returning what it did (``RunStats``)."""
    _require_static(dc)
    if block < 1:
        raise ValueError("block must be >= 1")
    dev = dc.time.device
    horizon_t = torch.clamp(torch.tensor(horizon, dtype=torch.float32,
                                         device=dev), max=INF)
    index = row_index(dc.cloudlets.vm, dc.vms.req_pes.shape[0])
    n = torch.zeros((), dtype=torch.int32, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    n_steps = n_blocks = 0
    while True:
        due = pending_due(dc)
        alive_h, more, early, due_h = torch.stack(
            [alive, n < max_steps, dc.time < horizon_t, due]).tolist()
        n_blocks += 1
        if not (alive_h and more and early):
            break
        if due_h:
            dc = provision_pending(dc, provision_policy)
        for _ in range(block):
            go = (alive & (n < max_steps) & (dc.time < horizon_t)
                  & ~pending_due(dc))
            new, active, _, _ = _advance(dc, index)
            dc = _select(go, new, dc)
            n = n + (go & active).to(torch.int32)
            alive = torch.where(go, active, alive)
        n_steps += block
    return dc, RunStats(n_events=int(n), n_steps=n_steps, n_blocks=n_blocks)


def run(dc: DatacenterState, *, max_steps: int = 1_000_000,
        horizon: float = float("inf"), provision_policy: int = FIRST_FIT,
        block: int = BLOCK) -> DatacenterState:
    """Run a static scenario to quiescence.

    Stops when the event queue is empty, once the clock has passed
    ``horizon`` (simulated seconds), or after ``max_steps`` events, as
    the JAX engine's ``run(..., leap=False)`` does.  ``block`` steps run
    between two host checks; the result does not depend on it.  Raises
    ``NotImplementedError`` for a dynamic, networked, elastic or probed
    scenario.
    """
    return run_stats(dc, max_steps=max_steps, horizon=horizon,
                     provision_policy=provision_policy, block=block)[0]
