"""Dense struct-of-arrays state (``repro.core.state`` in PyTorch).

The cloud model of the paper — Datacenter -> Hosts -> VMs -> Cloudlets —
as plain dataclasses of tensors: every array is 1-D over its entity axis
(H hosts, V VMs, C cloudlets, E events), scalars are 0-d tensors, and
field names, dtypes and codes are those of the JAX package, so a state
converts leaf by leaf in either direction (``core/convert.py``).

Streamed scenarios (``engine.run_stream``) carry an arrival queue
(``ArrivalStream``) beside a window of recycled cloudlet slots
(``make_window``); their running aggregates live in ``StreamState``.
Elastic scenarios carry an enabled ``AutoscalerState``
(``make_autoscaler``), probed ones an enabled ``MetricsState``
(``metrics.make_metrics``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.energy import make_power_model
from repro_torch.core.metrics import MetricsState, no_metrics
from repro_torch.core.segments import segment_rank
from repro_torch.device import resolve_device
from repro_torch.spans import span, spanned

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------
INF = 1e30

# scheduling policy codes (host level and VM level use the same codes)
SPACE_SHARED = 0
TIME_SHARED = 1

# VM life cycle
VM_EMPTY = 0
VM_PENDING = 1
VM_ACTIVE = 2
VM_FAILED = 3
VM_DESTROYED = 4

# Cloudlet life cycle
CL_EMPTY = 0
CL_CREATED = 1
CL_DONE = 2
CL_FAILED = 3

# Dynamic-event kinds (rows of the f32[E, 4] event table)
EV_NONE = 0
EV_VM_CREATE = 1
EV_VM_DESTROY = 2
EV_HOST_FAIL = 3
EV_HOST_RECOVER = 4

# Migration trigger policies
MIG_OFF = 0
MIG_THRESHOLD = 1
MIG_DRAIN = 2

# Network staging phases
NET_PRE = 0
NET_STAGE_IN = 1
NET_RUN = 2
NET_STAGE_OUT = 3


@dataclasses.dataclass
class HostState:
    num_pes: torch.Tensor        # i32[H]
    mips_per_pe: torch.Tensor    # f32[H]
    ram: torch.Tensor            # f32[H]   (MB)
    bw: torch.Tensor             # f32[H]   (MB/s)
    storage: torch.Tensor        # f32[H]   (MB)
    free_ram: torch.Tensor       # f32[H]
    free_bw: torch.Tensor        # f32[H]
    free_storage: torch.Tensor   # f32[H]
    free_pes: torch.Tensor       # f32[H]  (reserved only under reserve_pes)
    idle_w: torch.Tensor         # f32[H]  watts at utilization 0
    peak_w: torch.Tensor         # f32[H]  watts at utilization 1
    power_curve: torch.Tensor    # f32[H, K_CURVE]
    energy_j: torch.Tensor       # f32[H]  joules accrued by the engine
    valid: torch.Tensor          # bool[H]

    @property
    def capacity_mips(self) -> torch.Tensor:
        return self.num_pes.to(torch.float32) * self.mips_per_pe


@dataclasses.dataclass
class VmState:
    req_pes: torch.Tensor        # i32[V]
    req_mips: torch.Tensor       # f32[V]  per-PE MIPS requested
    ram: torch.Tensor            # f32[V]
    bw: torch.Tensor             # f32[V]
    size: torch.Tensor           # f32[V]  image size (storage)
    submit_time: torch.Tensor    # f32[V]
    host: torch.Tensor           # i32[V]  -1 while unplaced
    state: torch.Tensor          # i32[V]  VM_* codes
    create_time: torch.Tensor    # f32[V]  when placed (INF before)
    mig_remaining: torch.Tensor  # f32[V]  migration copy seconds left


@dataclasses.dataclass
class CloudletState:
    vm: torch.Tensor             # i32[C]   owning VM slot
    length: torch.Tensor         # f32[C]   total MI
    remaining: torch.Tensor      # f32[C]   MI left
    file_size: torch.Tensor      # f32[C]   MB in
    output_size: torch.Tensor    # f32[C]   MB out
    submit_time: torch.Tensor    # f32[C]
    start_time: torch.Tensor     # f32[C]   first instant with CPU (-1 before)
    finish_time: torch.Tensor    # f32[C]   INF until done
    rank_in_vm: torch.Tensor     # i32[C]   FCFS rank within its VM
    state: torch.Tensor          # i32[C]   CL_* codes
    net_phase: torch.Tensor      # i32[C]   NET_* staging phase
    net_remaining: torch.Tensor  # f32[C]
    net_lat: torch.Tensor        # f32[C]


@dataclasses.dataclass
class NetTopology:
    """Two-tier topology; the all-zero ``no_network`` default is inert."""
    enabled: torch.Tensor        # i32[]
    cluster: torch.Tensor        # i32[H]
    bw_intra: torch.Tensor       # f32[]
    lat_intra: torch.Tensor      # f32[]
    bw_inter: torch.Tensor       # f32[]
    lat_inter: torch.Tensor      # f32[]
    bw_wan: torch.Tensor         # f32[]
    lat_wan: torch.Tensor        # f32[]
    energy_per_mb: torch.Tensor  # f32[]


@dataclasses.dataclass
class AutoscalerState:
    """Closed-loop knobs + spot track; the ``no_autoscaler`` default is
    inert."""
    enabled: torch.Tensor            # i32[]
    util_high: torch.Tensor          # f32[]
    util_low: torch.Tensor           # f32[]
    cooldown: torch.Tensor           # f32[]
    min_fleet: torch.Tensor          # i32[]
    max_fleet: torch.Tensor          # i32[]
    scale_step: torch.Tensor         # i32[]
    price_sensitivity: torch.Tensor  # f32[]
    last_action: torch.Tensor        # f32[]
    up_count: torch.Tensor           # i32[]
    down_count: torch.Tensor         # i32[]
    spot_enabled: torch.Tensor       # i32[]
    spot_t: torch.Tensor             # f32[T]
    spot_price: torch.Tensor         # f32[T]
    spot_cost: torch.Tensor          # f32[]


@dataclasses.dataclass
class MarketRates:
    cost_per_cpu_sec: torch.Tensor   # $ per PE-second consumed
    cost_per_mem: torch.Tensor       # $ per MB at VM creation
    cost_per_storage: torch.Tensor   # $ per MB at VM creation
    cost_per_bw: torch.Tensor        # $ per MB transferred


@dataclasses.dataclass
class Accounting:
    cpu_cost: torch.Tensor       # f32[]
    mem_cost: torch.Tensor       # f32[]
    storage_cost: torch.Tensor   # f32[]
    bw_cost: torch.Tensor        # f32[]

    @property
    def total(self) -> torch.Tensor:
        return self.cpu_cost + self.mem_cost + self.storage_cost + self.bw_cost


@dataclasses.dataclass
class DatacenterState:
    hosts: HostState
    vms: VmState
    cloudlets: CloudletState
    rates: MarketRates
    acct: Accounting
    time: torch.Tensor               # f32[]
    vm_policy: torch.Tensor          # i32[]  host level: SPACE/TIME
    task_policy: torch.Tensor        # i32[]  VM level: SPACE/TIME
    reserve_pes: torch.Tensor        # i32[]  1 => placement reserves PEs
    events: torch.Tensor             # f32[E, 4]
    event_fired: torch.Tensor        # bool[E]
    mig_policy: torch.Tensor         # i32[]
    mig_threshold: torch.Tensor      # f32[]
    mig_energy_per_mb: torch.Tensor  # f32[]
    mig_count: torch.Tensor          # i32[]
    mig_downtime: torch.Tensor       # f32[]
    net: NetTopology
    net_transferred_mb: torch.Tensor  # f32[]
    scaler: AutoscalerState
    metrics: MetricsState


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; from pageable host memory the copy waits for
    the device's queue."""
    with span("sync.build.copy"):
        return torch.from_numpy(a).to(device)


def _vec(x, n: int, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (scalar or sequence) broadcast to a length-``n`` tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.broadcast_to(np.asarray(x, dtype), (n,))
    return _upload(np.array(a), device)


def _scalar(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32}[dtype]
    return _upload(np.asarray(x, np_dtype).reshape(()), device)


def make_hosts(num_pes, mips_per_pe, ram, bw, storage, *, idle_w=0.0,
               peak_w=0.0, power_curve=None, device=None) -> HostState:
    """A host block from per-host sequences (python/numpy).

    ``idle_w``/``peak_w``/``power_curve`` attach a utilization→power model
    (``core/energy.py``); the zero-watt default keeps energy inert.
    """
    dev = resolve_device(device)
    pes_np = np.asarray(num_pes, np.int32).reshape(-1)
    h = pes_np.shape[0]
    f = lambda x: _vec(x, h, np.float32, dev)
    ram, bw, storage = f(ram), f(bw), f(storage)
    pes = _upload(pes_np.copy(), dev)
    idle, peak, curve = make_power_model(h, idle_w, peak_w, power_curve,
                                         device=dev)
    return HostState(
        num_pes=pes, mips_per_pe=f(mips_per_pe),
        ram=ram, bw=bw, storage=storage,
        free_ram=ram.clone(), free_bw=bw.clone(),
        free_storage=storage.clone(),
        free_pes=pes.to(torch.float32),
        idle_w=idle, peak_w=peak, power_curve=curve,
        energy_j=torch.zeros((h,), dtype=torch.float32, device=dev),
        valid=torch.ones((h,), dtype=torch.bool, device=dev))


@spanned("build.hosts")
def make_uniform_hosts(n, *, pes=1, mips=1000.0, ram=1024.0, bw=1000.0,
                       storage=2_000_000.0, idle_w=0.0, peak_w=0.0,
                       power_curve=None, device=None) -> HostState:
    """The paper's §5 host class: 1 core @1000 MIPS, 1 GB RAM, 2 TB."""
    return make_hosts(np.full(n, pes), np.full(n, float(mips)),
                      np.full(n, float(ram)), np.full(n, float(bw)),
                      np.full(n, float(storage)), idle_w=idle_w,
                      peak_w=peak_w, power_curve=power_curve, device=device)


def make_vms(req_pes, req_mips, ram, bw, size, submit_time=0.0, *,
             device=None) -> VmState:
    dev = resolve_device(device)
    pes_np = np.asarray(req_pes, np.int32).reshape(-1)
    v = pes_np.shape[0]
    f = lambda x: _vec(x, v, np.float32, dev)
    return VmState(
        req_pes=_upload(pes_np.copy(), dev),
        req_mips=f(req_mips), ram=f(ram), bw=f(bw), size=f(size),
        submit_time=f(submit_time),
        host=torch.full((v,), -1, dtype=torch.int32, device=dev),
        state=torch.full((v,), VM_PENDING, dtype=torch.int32, device=dev),
        create_time=torch.full((v,), INF, dtype=torch.float32, device=dev),
        mig_remaining=torch.zeros((v,), dtype=torch.float32, device=dev))


@spanned("build.cloudlets")
def make_cloudlets(vm, length, submit_time=0.0, file_size=0.0,
                   output_size=0.0, *, device=None) -> CloudletState:
    """Cloudlet slots MUST be grouped by vm with ranks ascending (FCFS);
    ``validate_cloudlet_order`` checks the invariant host-side."""
    dev = resolve_device(device)
    vm_np = np.asarray(vm, np.int32).reshape(-1)
    c = vm_np.shape[0]
    f = lambda x: _vec(x, c, np.float32, dev)
    vm_t = _upload(vm_np.copy(), dev)
    length = f(length)
    return CloudletState(
        vm=vm_t, length=length, remaining=length.clone(),
        file_size=f(file_size), output_size=f(output_size),
        submit_time=f(submit_time),
        start_time=torch.full((c,), -1.0, dtype=torch.float32, device=dev),
        finish_time=torch.full((c,), INF, dtype=torch.float32, device=dev),
        rank_in_vm=segment_rank(vm_t),
        state=torch.full((c,), CL_CREATED, dtype=torch.int32, device=dev),
        net_phase=torch.full((c,), NET_PRE, dtype=torch.int32, device=dev),
        net_remaining=torch.zeros((c,), dtype=torch.float32, device=dev),
        net_lat=torch.zeros((c,), dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# Streaming arrivals (engine.run_stream): a bounded window of W recycled
# cloudlet slots fed by a chunked arrival queue, so a lane's cloudlet axis
# is W, not the trace length.  The queue is sorted by submit time when it
# is built (NumPy), padded with vm = -1 / submit = INF rows in its last
# chunk only; due arrivals enter the lowest free slots in arrival order,
# and the occupants they displace fold into ``StreamStats``.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ArrivalStream:
    """Chunked arrival queue: K chunks of M rows (f32/i32[K, M]).

    Rows are sorted by (submit time, original index); padding rows
    (``vm == -1``, ``submit == INF``) sit in the final chunk only, so a
    chunk's first row tells whether it carries arrivals.  Every ``vm``
    must name a non-EMPTY VM slot (or one an EV_VM_CREATE row brings to
    life before the arrival); an arrival for a FAILED or DESTROYED VM
    enters the window already failed.
    """
    vm: torch.Tensor            # i32[K, M]  owning VM slot (-1 = padding)
    length: torch.Tensor        # f32[K, M]  MI
    file_size: torch.Tensor     # f32[K, M]  MB staged in
    output_size: torch.Tensor   # f32[K, M]  MB staged out
    submit: torch.Tensor        # f32[K, M]  seconds (INF = padding)


@dataclasses.dataclass
class StreamStats:
    """Running aggregates over retired cloudlets.

    The reservoir samples arrival ``sid`` where ``sid % stride == 0``
    into row ``sid // stride``: a subset fixed by the trace alone, which
    the f64 oracle reproduces.
    """
    n_retired: torch.Tensor     # i32[]  DONE cloudlets folded out
    n_failed: torch.Tensor      # i32[]  FAILED cloudlets folded out
    makespan: torch.Tensor      # f32[]  latest finish over retired DONE
    sum_exec: torch.Tensor      # f32[]  sum of finish - start (DONE)
    sum_response: torch.Tensor  # f32[]  sum of finish - submit (DONE)
    sum_len: torch.Tensor       # f32[]  MI completed
    per_vm_done: torch.Tensor   # i32[V] completed cloudlets per VM
    stride: torch.Tensor        # i32[]  reservoir stride
    res_sid: torch.Tensor       # i32[R] sampled arrival ids (-1 = unfilled)
    res_start: torch.Tensor     # f32[R] their start times
    res_finish: torch.Tensor    # f32[R] their finish times


@dataclasses.dataclass
class StreamState:
    """What a streamed lane carries besides its ``DatacenterState``."""
    cursor: torch.Tensor          # i32[]  next unadmitted row of its chunk
    next_sid: torch.Tensor        # i32[]  arrivals admitted so far
    vm_rank: torch.Tensor         # i32[V] per-VM admission counter
    slot_sid: torch.Tensor        # i32[W] arrival id in each slot (-1)
    peak_occupancy: torch.Tensor  # i32[]  most in-flight cloudlets seen
    max_backlog: torch.Tensor     # i32[]  most due, unadmitted rows seen
    stats: StreamStats


def make_stream(vm, length, submit_time, *, file_size=0.0, output_size=0.0,
                chunk: int = 64, device=None) -> ArrivalStream:
    """A chunked arrival queue, sorted by (submit time, index) with a
    stable NumPy sort and padded in its final chunk with inert
    ``vm = -1 / submit = INF`` rows."""
    dev = resolve_device(device)
    as_np = lambda x: (x.detach().cpu().numpy()
                       if isinstance(x, torch.Tensor) else x)
    vm = np.asarray(as_np(vm), np.int32).reshape(-1)
    n = vm.shape[0]
    f = lambda x: np.broadcast_to(
        np.asarray(as_np(x), np.float32), (n,)).astype(np.float32)
    length, submit = f(length), f(submit_time)
    fs, os_ = f(file_size), f(output_size)
    order = np.lexsort((np.arange(n), submit))
    k = max(1, -(-n // chunk))          # ceil; at least one chunk
    pad = k * chunk - n
    pad_i = lambda a, v: torch.from_numpy(np.concatenate(
        [a[order], np.full(pad, v, a.dtype)]).reshape(k, chunk)).to(dev)
    return ArrivalStream(
        vm=pad_i(vm, -1), length=pad_i(length, 0.0),
        file_size=pad_i(fs, 0.0), output_size=pad_i(os_, 0.0),
        submit=pad_i(submit, np.float32(INF)))


def make_window(n_slots: int, *, device=None) -> CloudletState:
    """W empty cloudlet slots: the cloudlet block of a streamed lane."""
    dev = resolve_device(device)
    z = lambda: torch.zeros((n_slots,), dtype=torch.float32, device=dev)
    i = lambda x: torch.full((n_slots,), x, dtype=torch.int32, device=dev)
    return CloudletState(
        vm=i(-1), length=z(), remaining=z(), file_size=z(),
        output_size=z(), submit_time=z(),
        start_time=torch.full((n_slots,), -1.0, device=dev),
        finish_time=torch.full((n_slots,), INF, device=dev),
        rank_in_vm=i(0), state=i(CL_EMPTY), net_phase=i(NET_PRE),
        net_remaining=z(), net_lat=z())


def make_stream_states(streams: ArrivalStream, n_vms: int, n_slots: int, *,
                       reservoir: int = 64) -> StreamState:
    """The initial carry of each lane of a stacked [B, K, M] queue, on
    its device, with no host read.

    Each lane's reservoir stride is ``ceil(n_total / reservoir)`` of its
    real arrival count, so the sampled subset depends on its trace
    alone."""
    dev = streams.vm.device
    b = streams.vm.shape[0]
    n_total = (streams.vm >= 0).reshape(b, -1).sum(dim=1)
    r = max(reservoir, 1)
    stride = torch.clamp((n_total + r - 1) // r, min=1).to(torch.int32)
    zi = lambda *s: torch.zeros((b,) + s, dtype=torch.int32, device=dev)
    zf = lambda: torch.zeros((b,), dtype=torch.float32, device=dev)
    full = lambda n, x, dt: torch.full((b, n), x, dtype=dt, device=dev)
    stats = StreamStats(
        n_retired=zi(), n_failed=zi(), makespan=zf(), sum_exec=zf(),
        sum_response=zf(), sum_len=zf(), per_vm_done=zi(n_vms),
        stride=stride, res_sid=full(reservoir, -1, torch.int32),
        res_start=full(reservoir, -1.0, torch.float32),
        res_finish=full(reservoir, INF, torch.float32))
    return StreamState(
        cursor=zi(), next_sid=zi(), vm_rank=zi(n_vms),
        slot_sid=full(n_slots, -1, torch.int32), peak_occupancy=zi(),
        max_backlog=zi(), stats=stats)


def make_stream_state(stream: ArrivalStream, n_vms: int, n_slots: int, *,
                      reservoir: int = 64) -> StreamState:
    """The initial carry of one streamed lane (``make_stream_states`` of
    a batch of one)."""
    one = map_tensors(lambda t: t.unsqueeze(0), stream)
    return map_tensors(lambda t: t[0], make_stream_states(
        one, n_vms, n_slots, reservoir=reservoir))


def validate_cloudlet_order(vm_ids) -> bool:
    """Host-side invariant check: cloudlet slots grouped by vm id runs."""
    if isinstance(vm_ids, torch.Tensor):
        vm_ids = vm_ids.detach().cpu().numpy()
    seen, prev = set(), None
    for x in np.asarray(vm_ids).tolist():
        if x != prev:
            if x in seen:
                return False
            seen.add(x)
            prev = x
    return True


def make_topology(cluster, *, bw_intra=1000.0, lat_intra=0.0,
                  bw_inter=500.0, lat_inter=0.0, bw_wan=100.0,
                  lat_wan=0.0, energy_per_mb=0.0, device=None) -> NetTopology:
    """An *enabled* two-tier topology from a host -> cluster map.

    ``cluster`` is a length-H sequence of edge-cluster ids in ``[0, H)``
    (hosts sharing an id share an edge cluster).  Bandwidths in MB/s,
    latencies in seconds, ``energy_per_mb`` in J charged to the serving
    host per staged MB.
    """
    dev = resolve_device(device)
    if isinstance(cluster, torch.Tensor):
        cluster = cluster.detach().cpu().numpy()
    g = lambda x: _scalar(x, torch.float32, dev)
    return NetTopology(
        enabled=_scalar(1, torch.int32, dev),
        cluster=torch.from_numpy(
            np.asarray(cluster, np.int32).reshape(-1).copy()).to(dev),
        bw_intra=g(bw_intra), lat_intra=g(lat_intra),
        bw_inter=g(bw_inter), lat_inter=g(lat_inter),
        bw_wan=g(bw_wan), lat_wan=g(lat_wan),
        energy_per_mb=g(energy_per_mb))


def no_network(n_hosts: int, *, device=None) -> NetTopology:
    """The disabled topology (all zeros) — the non-networked default."""
    dev = resolve_device(device)
    z = lambda: torch.zeros((), dtype=torch.float32, device=dev)
    return NetTopology(
        enabled=torch.zeros((), dtype=torch.int32, device=dev),
        cluster=torch.zeros((n_hosts,), dtype=torch.int32, device=dev),
        bw_intra=z(), lat_intra=z(), bw_inter=z(), lat_inter=z(),
        bw_wan=z(), lat_wan=z(), energy_per_mb=z())


def make_autoscaler(*, util_high=0.8, util_low=0.2, cooldown=0.0,
                    min_fleet=0, max_fleet=1_000_000, scale_step=1,
                    price_sensitivity=0.0, spot_t=None, spot_price=None,
                    device=None) -> AutoscalerState:
    """An *enabled* autoscaler; attach a spot track by passing both tables.

    ``spot_t`` must start at 0.0 and strictly increase; segment ``i``
    prices ``[spot_t[i], spot_t[i+1])`` at ``spot_price[i]`` $ per
    alive-VM-second (the last segment extends to the end of the run).
    """
    dev = resolve_device(device)
    spot_on = spot_t is not None and spot_price is not None
    if spot_on:
        st = np.asarray(spot_t, np.float32).reshape(-1)
        sp = np.asarray(spot_price, np.float32).reshape(-1)
        if st.shape != sp.shape:
            raise ValueError("spot_t and spot_price must have equal length")
        if st.shape[0] == 0 or st[0] != 0.0 or np.any(np.diff(st) <= 0.0):
            raise ValueError("spot_t must start at 0 and strictly increase")
    else:
        st = np.zeros((1,), np.float32)
        sp = np.zeros((1,), np.float32)
    f = lambda x: _scalar(x, torch.float32, dev)
    i = lambda x: _scalar(x, torch.int32, dev)
    return AutoscalerState(
        enabled=i(1), util_high=f(util_high), util_low=f(util_low),
        cooldown=f(cooldown), min_fleet=i(min_fleet),
        max_fleet=i(max_fleet), scale_step=i(scale_step),
        price_sensitivity=f(price_sensitivity), last_action=f(-1e30),
        up_count=i(0), down_count=i(0), spot_enabled=i(1 if spot_on else 0),
        spot_t=torch.from_numpy(st).to(dev),
        spot_price=torch.from_numpy(sp).to(dev), spot_cost=f(0.0))


def no_autoscaler(n_segments: int = 1, *, device=None) -> AutoscalerState:
    """The disabled autoscaler (all zeros) — the non-elastic default."""
    dev = resolve_device(device)
    z = lambda: torch.zeros((), dtype=torch.float32, device=dev)
    i = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return AutoscalerState(
        enabled=i(), util_high=z(), util_low=z(), cooldown=z(),
        min_fleet=i(), max_fleet=i(), scale_step=i(),
        price_sensitivity=z(), last_action=z(), up_count=i(),
        down_count=i(), spot_enabled=i(),
        spot_t=torch.zeros((n_segments,), dtype=torch.float32, device=dev),
        spot_price=torch.zeros((n_segments,), dtype=torch.float32,
                               device=dev),
        spot_cost=z())


def make_events(times, kinds, targets, params=0.0, *, device=None
                ) -> torch.Tensor:
    """f32[E, 4] event table from per-event sequences.

    ``times`` in seconds, ``kinds`` EV_* codes, ``targets`` the VM slot
    (EV_VM_*) or host slot (EV_HOST_*) the event acts on, ``params``
    reserved (0).  Rows need not be sorted by time: the engine applies
    every due row.
    """
    dev = resolve_device(device)
    if isinstance(times, torch.Tensor):
        times = times.detach().cpu().numpy()
    t = np.asarray(times, np.float32).reshape(-1)
    col = lambda x: np.broadcast_to(np.asarray(x, np.float32), t.shape)
    return torch.from_numpy(np.stack(
        [t, col(kinds), col(targets), col(params)], axis=1)).to(dev)


def no_events(*, device=None) -> torch.Tensor:
    """The empty event table (E = 0) — the static-scenario default."""
    return torch.zeros((0, 4), dtype=torch.float32,
                       device=resolve_device(device))


def make_market(cost_per_cpu_sec=0.0, cost_per_mem=0.0, cost_per_storage=0.0,
                cost_per_bw=0.0, *, device=None) -> MarketRates:
    dev = resolve_device(device)
    g = lambda x: _scalar(x, torch.float32, dev)
    return MarketRates(g(cost_per_cpu_sec), g(cost_per_mem),
                       g(cost_per_storage), g(cost_per_bw))


def map_tensors(fn, obj):
    """The same dataclass tree (a state or any block of it) with ``fn``
    applied to every tensor."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return fn(obj)


def tensor_leaves(obj) -> list:
    """Every tensor of a dataclass tree, in field order."""
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in tensor_leaves(getattr(obj, f.name))]
    return [obj]


def with_leaves(obj, leaves):
    """``obj`` rebuilt with ``leaves`` (in ``tensor_leaves`` order)."""
    it = iter(leaves)
    return map_tensors(lambda _: next(it), obj)


def to_device(obj, device):
    """A copy of a state (or any block of it) on ``device``."""
    return map_tensors(lambda t: t.to(device), obj)


@spanned("build.datacenter")
def make_datacenter(hosts: HostState, vms: VmState, cloudlets: CloudletState,
                    *, vm_policy=SPACE_SHARED, task_policy=SPACE_SHARED,
                    reserve_pes=True, rates: MarketRates | None = None,
                    events=None, mig_policy=MIG_OFF, mig_threshold=0.8,
                    mig_energy_per_mb=0.0, net: NetTopology | None = None,
                    scaler: AutoscalerState | None = None,
                    metrics: MetricsState | None = None,
                    device=None) -> DatacenterState:
    """Assemble a datacenter on ``device``; blocks built elsewhere are
    moved there."""
    dev = resolve_device(device)
    nh = hosts.num_pes.shape[0]
    f32 = lambda x: _scalar(x, torch.float32, dev)
    i32 = lambda x: _scalar(x, torch.int32, dev)
    if events is None:
        events = no_events(device=dev)
    elif not isinstance(events, torch.Tensor):
        events = torch.from_numpy(
            np.asarray(events, np.float32).reshape(-1, 4)).to(dev)
    return DatacenterState(
        hosts=to_device(hosts, dev), vms=to_device(vms, dev),
        cloudlets=to_device(cloudlets, dev),
        rates=to_device(rates if rates is not None
                        else make_market(device=dev), dev),
        acct=Accounting(f32(0.0), f32(0.0), f32(0.0), f32(0.0)),
        time=f32(0.0),
        vm_policy=i32(vm_policy),
        task_policy=i32(task_policy),
        reserve_pes=i32(1 if reserve_pes else 0),
        events=events.to(device=dev, dtype=torch.float32),
        event_fired=torch.zeros((events.shape[0],), dtype=torch.bool,
                                device=dev),
        mig_policy=i32(mig_policy),
        mig_threshold=f32(mig_threshold),
        mig_energy_per_mb=f32(mig_energy_per_mb),
        mig_count=i32(0),
        mig_downtime=f32(0.0),
        net=to_device(net if net is not None
                      else no_network(nh, device=dev), dev),
        net_transferred_mb=f32(0.0),
        scaler=to_device(scaler if scaler is not None
                         else no_autoscaler(device=dev), dev),
        metrics=to_device(metrics if metrics is not None
                          else no_metrics(nh, device=dev), dev),
    )
