"""The sweep driver: a researcher's script that runs the §5 experiment
under the traffic file's policy pairs, one call after another.

A call builds its seeds' scenarios with the program's builders
(``state.make_uniform_hosts``, ``broker.build_fleet``,
``state.make_cloudlets``, ``state.make_datacenter``), stacks them
(``sweep.stack_scenarios``), fuses them with the policy pairs into
one lane axis and runs every lane to quiescence (``sweep.fuse_grid`` and
``engine.batched_run_stats``: what ``sweep.run_grid`` runs, with the
counts it drops), then brings ``sweep.summarize_batch``'s per-lane
summaries to the host.  It ends there.

Spans, in host seconds, each ending in a synchronisation: ``build``
(builders and stack), ``run`` (fuse and run) and ``summary``; a call
also returns them as host-clock intervals (``phases``), which name the
device's idle gaps in a trace.  The
checked lanes' entity arrays are copied to the host after the summary;
that copy is the benchmark's and is left out of the window.
"""
from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch

from simbench import compare, generate, simstep_bytes
from simbench.reference import s5 as reference

__all__ = ["Driver"]

CHECK_LANES = 64        # lanes the reference runs at once


class Driver:
    """One cell's calls on ``device``, with what the check needs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core import broker, engine, state, sweep
        self.broker, self.engine = broker, engine
        self.state, self.sweep = state, sweep
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.pairs = generate.lane_pairs(traffic)
        # what sweep.run_grid runs with when not told otherwise
        self.max_steps = inspect.signature(
            sweep.run_grid).parameters["max_steps"].default
        self.kept = []          # (call, n_events, summary, details)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _scenario(self, sc):
        c, S, B = self.config, self.state, self.broker
        h, v, w, r = c["hosts"], c["vms"], c["waves"], c["rates"]
        dev = self.device
        hosts = S.make_uniform_hosts(
            int(h["count"]), pes=int(h["pes"]), mips=float(h["mips"]),
            ram=float(h["ram"]), bw=float(h["bw"]),
            storage=float(h["storage"]), idle_w=float(h["idle_w"]),
            peak_w=float(h["peak_w"]), device=dev)
        vms = B.build_fleet([B.VmSpec(
            count=int(v["count"]), pes=int(v["pes"]), mips=float(v["mips"]),
            ram=float(v["ram"]), bw=float(v["bw"]), size=float(v["size"]))],
            device=dev)
        cl = S.make_cloudlets(sc.vm, sc.length, sc.submit,
                              float(w["file_size"]), float(w["output_size"]),
                              device=dev)
        return S.make_datacenter(
            hosts, vms, cl, reserve_pes=bool(c["reserve_pes"]),
            rates=S.make_market(float(r["cpu"]), float(r["mem"]),
                                float(r["storage"]), float(r["bw"]),
                                device=dev),
            device=dev)

    def call(self, index: int, keep: bool = True) -> dict:
        """Call ``index``; returns its spans (s), its counts, the lanes it
        ran and ``excluded_s``, the benchmark's own time inside it."""
        scen = generate.call_scenarios(self.config, self.traffic, self.seed,
                                       index)
        t0 = time.perf_counter()
        batch = self.sweep.stack_scenarios([self._scenario(s) for s in scen])
        self._sync()
        t1 = time.perf_counter()
        vm_p = torch.tensor([p[0] for p in self.pairs], dtype=torch.int32,
                            device=self.device)
        task_p = torch.tensor([p[1] for p in self.pairs], dtype=torch.int32,
                              device=self.device)
        fused = self.sweep.fuse_grid(batch, vm_p, task_p)
        del batch
        final, stats = self.engine.batched_run_stats(
            fused, max_steps=self.max_steps)
        del fused
        self._sync()
        t2 = time.perf_counter()
        s = self.sweep.summarize_batch(final)
        summary = {k: getattr(s, k).cpu().numpy()
                   for k in ("n_done", "makespan", "mean_response",
                             "total_cost", "energy_j")}
        t3 = time.perf_counter()
        if keep:
            lanes = generate.checked_lanes(self.traffic, self.seed, index)
            details = {lane: self._details(final, lane) for lane in lanes}
            self.kept.append((index, stats.n_events, summary, details))
        del final
        t4 = time.perf_counter()
        return {"spans": {"build": t1 - t0, "run": t2 - t1,
                          "summary": t3 - t2},
                "phases": [("build", t0, t1), ("run", t1, t2),
                           ("summary", t2, t3), ("check copy", t3, t4)],
                "counters": {"n_steps": stats.n_steps,
                             "n_leap": stats.n_leap,
                             "n_events": stats.n_events,
                             "n_full": stats.n_full,
                             "n_blocks": stats.n_blocks,
                             "n_plans": stats.n_plans},
                "items": len(self.pairs) * len(scen),
                "excluded_s": t4 - t3}

    @staticmethod
    def _details(final, lane: int) -> dict:
        host = lambda t: t[lane].cpu().numpy()
        return {"vm_host": host(final.vms.host),
                "vm_state": host(final.vms.state),
                "cl_state": host(final.cloudlets.state),
                "start": host(final.cloudlets.start_time),
                "finish": host(final.cloudlets.finish_time),
                "energy": host(final.hosts.energy_j),
                "mem_cost": host(final.acct.mem_cost),
                "storage_cost": host(final.acct.storage_cost),
                "total_cost": host(final.acct.total)}

    def trace_inputs(self) -> dict:
        """What the trace's readers need beside the trace: the least
        bytes and float operations of one simstep launch of a call
        (``simstep_launch_bytes``, ``simstep_launch_ops``), from the
        fused lanes' slot layout, rows numbered across lanes, a task
        policy a row."""
        sc = generate.scenario(self.config, self.seed, 0, 0)
        n_vms = int(self.config["vms"]["count"])
        lanes = len(self.pairs) * int(self.traffic["seeds_per_call"])
        rows = (sc.vm.astype(np.int64)[None]
                + n_vms * np.arange(lanes)[:, None]).reshape(-1)
        sizes = simstep_bytes.index_sizes(rows, lanes * n_vms)
        return {"simstep_launch_bytes":
                simstep_bytes.launch_bytes(sizes, per_row=True),
                "simstep_launch_ops": simstep_bytes.launch_ops(sizes)}

    def check(self) -> compare.Checker:
        """Every kept call against the float64 reference on the
        program's device, the lanes of whole calls batched
        ``CHECK_LANES`` or fewer at a time."""
        checker = compare.Checker()
        per_call = len(self.pairs) * int(self.traffic["seeds_per_call"])
        step = max(1, CHECK_LANES // per_call)
        for at in range(0, len(self.kept), step):
            block = self.kept[at:at + step]
            lanes = []
            for index, _, _, _ in block:
                scen = generate.call_scenarios(self.config, self.traffic,
                                               self.seed, index)
                lanes += [(p, sc) for p in self.pairs for sc in scen]
            ref = reference.simulate(self.config, [sc for _, sc in lanes],
                                     [p for p, _ in lanes],
                                     dtype=torch.float64, device=self.device)
            for k, (_, n_events, summary, details) in enumerate(block):
                part = slice(k * per_call, (k + 1) * per_call)
                checker.add_call(summary, n_events, details,
                                 reference.LaneResult(**{
                                     f.name: getattr(ref, f.name)[part]
                                     for f in dataclasses.fields(ref)}))
            del ref
        return checker
