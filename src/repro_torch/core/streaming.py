"""Streamed arrivals on a batch of lanes: admission, retirement and the
per-chunk bookkeeping of ``engine.run_stream`` (``repro.core.engine``'s
``_admit_due``, ``_retire_slot``, ``_retire_remaining`` and the chunk
scan of ``_stream_core``, in PyTorch).

A streamed lane's cloudlet block is a window of W slots; its workload
is an ``ArrivalStream`` of K chunks of M rows, read here as one flat
queue of K*M rows a lane.  ``StreamRun`` carries each lane's place in
that queue and runs the admission pass: one vectorised device pass over
every lane, with no host read, at the top of each full step.

The pass keeps the JAX engine's rules exactly.  Due arrivals are taken
in queue order; arrival j claims ``F[#live arrivals before j]``, where F
is the ascending list of the window's free slots (state != CL_CREATED);
an arrival for a FAILED or DESTROYED VM enters as CL_FAILED without
using its slot up, so the next arrival claims that slot again and
retires it.  The pass stops at the first row that is not due, or where
the live arrivals fill the free slots.  It looks at ``W + EXTRA`` rows at
most; a lane with dead arrivals left past them reports its pass
incomplete, does not step, and goes on with the pass at the next step
(at the same clock, so nothing changes).

JAX admits one chunk at a time and *hands off* between chunks (a loop
iteration that admits and does not step).  The flat queue admits across
chunk borders in one pass, which admits the same arrivals between two
steps; each border it crosses ends its chunk there, and the chunk's
``StreamChunkRecord`` is written from prefix counts at the border.  A
chunk also ends where JAX's chunk loop stops: after an inactive step, or
at the step budget ``max_steps_per_chunk``, when the unadmitted rows
left in the chunk are dropped, as JAX drops them.

Every occupant a claim displaces, and every occupant left at the end,
folds into ``StreamStats``.  The float sums of a pass add in a fixed
order (a pairwise tree over the pass's rows, ``segments.pairwise_sum``),
so a lane gives the same bits alone or in a batch, for any chunk size
and with the leap on or off.  JAX's sums run in claim order, so the two
agree within tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.segments import pairwise_sum, segment_rank
from repro_torch.core.state import (CL_CREATED, CL_DONE, CL_FAILED, INF,
                                    NET_PRE, VM_DESTROYED, VM_FAILED,
                                    ArrivalStream, DatacenterState,
                                    StreamState, StreamStats)

__all__ = ["StreamChunkRecord", "StreamRun", "EXTRA"]

EXTRA = 32      # rows a pass looks at beyond the window size


class StreamChunkRecord(NamedTuple):
    """What a streamed lane records once per arrival chunk."""
    time: torch.Tensor            # f32  clock when the chunk ended
    occupancy: torch.Tensor       # i32  in-flight (CL_CREATED) slots then
    peak_occupancy: torch.Tensor  # i32  running max occupancy
    max_backlog: torch.Tensor     # i32  running max of due, unadmitted rows
    n_retired: torch.Tensor       # i32  cumulative DONE folded out
    n_failed: torch.Tensor        # i32  cumulative FAILED folded out
    n_events: torch.Tensor        # i32  events committed in the chunk


def _excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running sum along the last axis, in i64."""
    x = x.long()
    return torch.cumsum(x, dim=-1) - x


_FIELDS = StreamChunkRecord._fields
_EVENTS = _FIELDS.index("n_events")


class StreamRun:
    """The streamed side of a batched run: each lane's ``StreamState``,
    its place in its queue, and its per-chunk records.

    Per lane: ``chunk`` (the chunk whose loop runs; K once the lane is
    done), ``cursor`` (next unadmitted row of the flat queue),
    ``n_chunk`` (events committed in the chunk, against
    ``max_steps_per_chunk``), ``alive`` (the chunk's last step was
    active) and ``admitted`` (this step's admission pass is complete; the
    step may commit).  ``engine`` calls ``begin`` at the top of every
    full step (a lane whose chunk must end waits for the next block
    boundary, where ``begin`` ends it) and at block boundaries before the
    event table, ``commit`` and ``leap`` after events commit, and
    ``finish`` at the end.  The records and the reservoir are kept as one
    f64 table each while the run lasts (exact for their i32 and f32
    fields), so a pass writes each with one scatter."""

    def __init__(self, streams: ArrivalStream, state: StreamState, *,
                 n_slots: int, max_steps_per_chunk: int):
        if max_steps_per_chunk < 1:
            raise ValueError("max_steps_per_chunk must be >= 1")
        b, k, m = streams.vm.shape
        dev = streams.vm.device
        flat = lambda t: t.reshape(b, k * m)
        self.q_vm = flat(streams.vm).long()
        self.q_length = flat(streams.length)
        self.q_file = flat(streams.file_size)
        self.q_out = flat(streams.output_size)
        self.q_submit = flat(streams.submit)
        self.n_lanes, self.n_chunks, self.width = b, k, m
        self.n_rows = k * m
        self.n_candidates = n_slots + EXTRA + 1
        self.max_steps = max_steps_per_chunk
        # per chunk: only padding follows it (padding sits at the end)
        self.pad_after = torch.cat([
            streams.vm[:, 1:, 0] < 0,
            torch.ones((b, 1), dtype=torch.bool, device=dev)], dim=1)
        stats = state.stats
        self.state = dataclasses.replace(state, stats=dataclasses.replace(
            stats, res_sid=None, res_start=None, res_finish=None))
        res = torch.stack([stats.res_sid.double(), stats.res_start.double(),
                           stats.res_finish.double()], dim=-1)
        self.res = torch.cat([res, res[:, :1]], dim=1)  # a spare last row
        lanes = lambda dt, x: torch.full((b,), x, dtype=dt, device=dev)
        self.chunk = lanes(torch.long, 0)
        self.cursor = lanes(torch.long, 0)
        self.n_chunk = lanes(torch.int32, 0)
        self.alive = lanes(torch.bool, True)
        self.admitted = lanes(torch.bool, False)
        self.records = torch.zeros((b, k + 1, len(_FIELDS)),
                                   dtype=torch.float64, device=dev)
        self.n_passes = 0

    # ---- what the engine reads ---------------------------------------------
    def _over(self) -> torch.Tensor:
        """bool[B] — the running chunk ends before the lane's next step:
        its last step was inactive, or it spent its budget."""
        return ~self.alive | (self.n_chunk >= self.max_steps)

    def _ends(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(``_over``, bool[B] the lane's run ends with its chunk: the
        last chunk, or an inactive step with only padding after)."""
        over = self._over()
        k = torch.clamp(self.chunk, max=self.n_chunks - 1)
        pad = self.pad_after.gather(1, k[:, None])[:, 0]
        last = (self.chunk + 1 >= self.n_chunks) | (~self.alive & pad)
        return over, over & last

    def live(self) -> torch.Tensor:
        """bool[B] — lanes that will step again."""
        return (self.chunk < self.n_chunks) & ~self._ends()[1]

    def ending(self) -> torch.Tensor:
        """bool[B] — lanes whose running chunk must end before their next
        pass (``begin(..., ends=True)``)."""
        return (self.chunk < self.n_chunks) & self._over()

    def ready(self) -> torch.Tensor:
        """bool[B] — lanes whose admission pass is complete."""
        return (self.chunk < self.n_chunks) & self.admitted

    def admitting(self) -> torch.Tensor:
        """bool[B] — lanes in the middle of an admission pass."""
        return (self.chunk < self.n_chunks) & ~self.admitted

    def next_arrival(self) -> torch.Tensor:
        """f32[B] submit time of each lane's next unadmitted row (INF
        when the queue is exhausted; padding rows carry INF)."""
        got = self.q_submit.gather(1, torch.clamp(
            self.cursor, max=self.n_rows - 1)[:, None])[:, 0]
        return got.masked_fill(self.cursor >= self.n_rows, INF)

    def budget(self) -> torch.Tensor:
        """bool[B] — the chunk may commit another event."""
        return self.n_chunk < self.max_steps

    def commit(self, go: torch.Tensor, active: torch.Tensor,
               events: torch.Tensor) -> None:
        """The lanes ``go`` committed a full step (``events`` of them)."""
        self.n_chunk = self.n_chunk + events.to(torch.int32)
        self.alive = torch.where(go, active, self.alive)
        self.admitted = self.admitted & ~go

    def leap(self, done: torch.Tensor) -> None:
        """A leap iteration committed an event on the lanes ``done``."""
        self.n_chunk = self.n_chunk + done.to(torch.int32)

    # ---- chunk ends --------------------------------------------------------
    def _occupancy(self, dc: DatacenterState) -> torch.Tensor:
        return (dc.cloudlets.state == CL_CREATED).sum(dim=1)

    def _now(self, dc: DatacenterState) -> list:
        """The record fields as the lane stands (f64[B] each)."""
        st = self.state
        return [dc.time.double(), self._occupancy(dc).double(),
                st.peak_occupancy.double(), st.max_backlog.double(),
                st.stats.n_retired.double(), st.stats.n_failed.double(),
                self.n_chunk.double()]

    def _end_chunks(self, dc: DatacenterState, lanes: torch.Tensor) -> None:
        """End the running chunk of ``lanes`` that JAX's chunk loop would
        leave before its next iteration: after an inactive step or at
        the budget.  Its unadmitted rows are dropped; after an inactive
        step followed by padding chunks only, those chunks take its final
        counts with no events (each would run one inactive step) and the
        lane is done."""
        over, last = self._ends()
        end = lanes & over
        hi = torch.where(end, torch.where(last, self.n_chunks,
                                          self.chunk + 1), self.chunk)
        k = torch.arange(self.n_chunks + 1, device=hi.device)[None]
        lo = self.chunk[:, None]
        hit = (k >= lo) & (k < hi[:, None])
        now = torch.stack(self._now(dc), dim=1)[:, None]
        rec = torch.where(hit[..., None], now, self.records)
        rec[..., _EVENTS] = rec[..., _EVENTS].masked_fill(hit & (k > lo),
                                                          0.0)
        self.records = rec
        self.cursor = torch.where(end & (hi < self.n_chunks),
                                  hi * self.width, self.cursor)
        self.chunk = hi
        self.n_chunk = self.n_chunk.masked_fill(end, 0)
        self.alive = self.alive | end

    # ---- retirement --------------------------------------------------------
    def _fold(self, done, failed, sid, vm, fin, sta, sub, length
              ) -> StreamStats:
        """The stats with the retired occupants ([B, N] masks and fields)
        folded in: counts, makespan, the sums (a pairwise tree along N),
        per-VM completions; and the reservoir."""
        stats = self.state.stats
        b, v = stats.per_vm_done.shape
        dev = done.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sums = pairwise_sum(torch.stack([
            torch.where(done, fin - sta, zero),
            torch.where(done, fin - sub, zero),
            torch.where(done, length, zero)]))
        base = torch.arange(b, device=dev)[:, None] * v
        per_vm = stats.per_vm_done.reshape(-1).index_add(
            0, (torch.clamp(vm.long(), 0, max(v - 1, 0)) + base).reshape(-1),
            done.to(torch.int32).reshape(-1)).view(b, v)
        r = self.res.shape[1] - 1
        stride = stats.stride.long()[:, None]
        sid = sid.long()
        row = torch.div(sid, stride, rounding_mode="floor")
        take = ((done | failed) & (sid >= 0) & (sid - row * stride == 0)
                & (row < r))
        row = torch.where(take, row, r)[..., None].expand(-1, -1, 3)
        self.res = self.res.scatter(1, row, torch.stack(
            [sid.double(), sta.double(), fin.double()], dim=-1))
        i32 = lambda t: t.to(torch.int32)
        return dataclasses.replace(
            stats,
            n_retired=i32(stats.n_retired + done.sum(dim=1)),
            n_failed=i32(stats.n_failed + failed.sum(dim=1)),
            makespan=torch.maximum(stats.makespan, torch.where(
                done, fin, zero).amax(dim=1) if done.shape[1] else zero),
            sum_exec=stats.sum_exec + sums[0],
            sum_response=stats.sum_response + sums[1],
            sum_len=stats.sum_len + sums[2],
            per_vm_done=per_vm)

    # ---- the admission pass ------------------------------------------------
    def begin(self, dc: DatacenterState, mask: torch.Tensor, *,
              ends: bool = False) -> DatacenterState:
        """The top of a step for the lanes ``mask``: with ``ends``, end
        the chunks JAX would end (``ending``; the engine does it at block
        boundaries and holds those lanes until then), then run the
        admission pass on every lane whose pass for this step is not
        complete yet (a no-op for the others)."""
        todo = mask & (self.chunk < self.n_chunks) & ~self.admitted
        if ends:
            self._end_chunks(dc, todo)
            todo = todo & (self.chunk < self.n_chunks)
        self.n_passes += 1
        return self._admit(dc, todo & ~self._over())

    def _admit(self, dc: DatacenterState, act: torch.Tensor
               ) -> DatacenterState:
        """The admission pass on the lanes ``act`` (see the module's
        docstring): the window with the admitted arrivals in place, the
        displaced occupants folded, the crossed chunks recorded."""
        cl, vms, st = dc.cloudlets, dc.vms, self.state
        b, w = cl.state.shape
        v = vms.state.shape[1]
        g = self.n_candidates
        dev = cl.state.device
        j = torch.arange(g, device=dev)[None]
        row = self.cursor[:, None] + j                          # [B, G]
        at = torch.clamp(row, max=self.n_rows - 1)
        q = lambda t: t.gather(1, at)
        qvm, qsub = q(self.q_vm), q(self.q_submit)
        due = (qvm >= 0) & (row < self.n_rows) & (qsub <= dc.time[:, None])
        vm = torch.clamp(qvm, 0, max(v - 1, 0))
        vstate = vms.state.gather(1, vm)
        live = (vstate != VM_FAILED) & (vstate != VM_DESTROYED)
        taken = cl.state == CL_CREATED                          # [B, W]
        free = ~taken
        live_before = _excl(due & live)
        ok = (due & (live_before < free.sum(dim=1, keepdim=True))
              & act[:, None])
        admit = torch.cumsum((~ok).to(torch.int32), dim=1) == 0
        incomplete = admit[:, -1]
        admit = admit & (j < g - 1)
        n_adm = admit.sum(dim=1)
        live_adm = admit & live

        # the ascending list of free slots; arrival j claims F[live_before]
        f_at = (torch.cumsum(free.long(), dim=1) - 1).masked_fill(taken, w)
        slots = torch.full((b, w + 1), w - 1, dtype=torch.long,
                           device=dev).scatter(1, f_at, torch.arange(
                               w, device=dev).expand(b, w))
        slot = slots.gather(1, torch.clamp(live_before, max=w))

        # each claim retires one occupant: the slot's own for the first
        # arrival a slot takes in this pass, else the dead arrival before
        first = admit.clone()
        first[:, 1:] &= live_adm[:, :-1]
        again = admit & ~first
        occ = lambda t: t.gather(1, slot)
        o_sid = occ(st.slot_sid)
        o_state = occ(cl.state)
        done = first & (o_sid >= 0) & (o_state == CL_DONE)
        failed = (first & (o_sid >= 0) & (o_state == CL_FAILED)) | again
        sid0 = st.next_sid.long()[:, None]
        stats = self._fold(
            done, failed, torch.where(again, sid0 + j - 1, o_sid.long()),
            occ(cl.vm), occ(cl.finish_time).masked_fill(again, INF),
            occ(cl.start_time).masked_fill(again, -1.0),
            occ(cl.submit_time), occ(cl.length))

        # chunk borders the pass reaches: row x = (k + 1) * M, every row
        # before it admitted and x itself due, ends chunk k there, with
        # the counts as they stand at x
        m = self.width
        cross = (due & (j <= n_adm[:, None]) & (row % m == 0)
                 & (row // m > self.chunk[:, None]) & act[:, None])
        ended = torch.where(cross, row // m - 1, self.n_chunks)
        occ0 = self._occupancy(dc)
        at_occ = occ0[:, None] + live_before
        f64 = lambda t: t.double().expand(b, g)
        vals = torch.stack([
            f64(dc.time[:, None]), f64(at_occ),
            f64(torch.maximum(st.peak_occupancy[:, None], at_occ)),
            f64(st.max_backlog[:, None]),
            f64(st.stats.n_retired[:, None] + _excl(done)),
            f64(st.stats.n_failed[:, None] + _excl(failed)),
            f64(self.n_chunk[:, None] * (ended == self.chunk[:, None]))],
            dim=-1)
        self.records = self.records.scatter(
            1, ended[..., None].expand(-1, -1, len(_FIELDS)), vals)
        n_cross = cross.sum(dim=1)
        self.chunk = self.chunk + n_cross
        self.n_chunk = self.n_chunk.masked_fill(n_cross > 0, 0)

        # the arrivals that stay: each claimed slot's last claimant; its
        # rank is the VM's counter plus the VM's earlier arrivals in the
        # pass
        stays = admit.clone()
        stays[:, :-1] &= live[:, :-1] | ~admit[:, 1:]
        base_v = torch.arange(b, device=dev)[:, None] * v
        gvm = torch.where(admit, vm + base_v, b * v).reshape(-1)
        order = torch.argsort(gvm * (b * g) + torch.arange(
            b * g, device=dev), stable=True)
        before = torch.empty_like(gvm)
        before[order] = segment_rank(gvm[order]).long()
        rank = st.vm_rank.gather(1, vm) + before.view(b, g)
        # src: the candidate each window slot takes its new occupant from
        src = torch.full((b * w + 1,), -1, dtype=torch.long, device=dev)
        src = src.index_put_((torch.where(
            stays, slot + torch.arange(b, device=dev)[:, None] * w,
            b * w).reshape(-1),), torch.arange(b * g, device=dev))
        src = src[:b * w].view(b, w)
        hit = src >= 0
        src = torch.clamp(src, min=0)
        take = lambda x, old: torch.where(
            hit, x.reshape(-1)[src].to(old.dtype), old)
        put = lambda x, old: old.masked_fill(hit, x)
        length = take(q(self.q_length), cl.length)
        new_cl = dataclasses.replace(
            cl, vm=take(qvm, cl.vm), length=length,
            remaining=torch.where(hit, length, cl.remaining),
            file_size=take(q(self.q_file), cl.file_size),
            output_size=take(q(self.q_out), cl.output_size),
            submit_time=take(qsub, cl.submit_time),
            start_time=put(-1.0, cl.start_time),
            finish_time=put(INF, cl.finish_time),
            rank_in_vm=take(rank, cl.rank_in_vm),
            state=take(torch.full_like(qvm, CL_FAILED).masked_fill_(
                live, CL_CREATED), cl.state),
            net_phase=put(NET_PRE, cl.net_phase),
            net_remaining=put(0.0, cl.net_remaining),
            net_lat=put(0.0, cl.net_lat))
        cursor = self.cursor + n_adm
        # the due rows left in the cursor's chunk (rows are sorted by
        # submit time, padding last), once the pass is complete
        due_end = torch.searchsorted(self.q_submit,
                                     dc.time[:, None].contiguous(),
                                     right=True)[:, 0]
        backlog = torch.clamp(torch.minimum(
            due_end, (self.chunk + 1) * m) - cursor, min=0)
        complete = act & ~incomplete
        i32 = lambda t: t.to(torch.int32)
        self.state = dataclasses.replace(
            st, next_sid=i32(st.next_sid + n_adm),
            vm_rank=st.vm_rank.reshape(-1).index_add(
                0, gvm.clamp(max=max(b * v - 1, 0)),
                i32(admit).reshape(-1)).view(b, v),
            slot_sid=take(sid0 + j, st.slot_sid),
            peak_occupancy=torch.maximum(
                st.peak_occupancy, i32(occ0 + live_adm.sum(dim=1))),
            max_backlog=torch.where(complete, torch.maximum(
                st.max_backlog, i32(backlog)), st.max_backlog),
            stats=stats)
        self.cursor = cursor
        self.admitted = self.admitted | complete
        return dataclasses.replace(dc, cloudlets=new_cl)

    # ---- the end of the run ------------------------------------------------
    def finish(self, dc: DatacenterState
               ) -> tuple[StreamState, StreamChunkRecord]:
        """End every lane's last chunks, fold the occupants still in the
        window, and return (``StreamState``, per-chunk records)."""
        self._end_chunks(dc, self.chunk < self.n_chunks)
        st, cl = self.state, dc.cloudlets
        sid = st.slot_sid
        stats = self._fold(
            (sid >= 0) & (cl.state == CL_DONE),
            (sid >= 0) & (cl.state == CL_FAILED), sid, cl.vm,
            cl.finish_time, cl.start_time, cl.submit_time, cl.length)
        res = self.res[:, :-1]
        stats = dataclasses.replace(
            stats, res_sid=res[..., 0].to(torch.int32),
            res_start=res[..., 1].float(), res_finish=res[..., 2].float())
        last = (self.n_chunks - 1) * self.width
        cursor = torch.clamp(self.cursor - last, 0, self.width)
        rec = self.records[:, :-1]
        records = StreamChunkRecord(*(
            rec[..., i].float() if name == "time"
            else rec[..., i].to(torch.int32)
            for i, name in enumerate(_FIELDS)))
        return (dataclasses.replace(st, stats=stats,
                                    cursor=cursor.to(torch.int32)),
                records)
