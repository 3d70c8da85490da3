#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA device and check it.

    python3 chip_smoke.py        (from the root of a checkout)

Phases, each printing its own lines; any failed check raises and the
script exits non-zero:

  1. header: the card (nvidia-smi name and power limit), torch and CUDA
     versions, and the build of every kernel from the checkout's sources,
     with ptxas's registers and spills for every instantiation (the
     tensor-core flash kernel must not spill, nor have its wgmma
     serialized);
  2. each kernel against its plain PyTorch version on the card, on edge
     tiles and at the main path's shapes, and timed there (simstep on
     dense tiles and on ragged ones: rows of 0 to 100,000 slots, slots of
     no row, bitwise); then a small random scenario runs on the card and
     on the CPU (the plain kernel) and must agree;
  3. the paper's §5 experiment at its 10,000 hosts, both task policies,
     against the closed-form answers;
  4. the paper's largest datacenter: 100,000 hosts, 50,000 VMs, 500,000
     cloudlets, both task policies, the same closed-form checks per wave
     and per host, with wall time, events/s and device bytes;
  4b. the same datacenter with a skewed binding (``s5-100k-skewed``): VM 0
     holds 200,000 cloudlets and every other VM 6, time-shared, against
     closed-form finish times and per-host energy;

  5. the LM serving slice, with TF32 off for matrix products and
     convolutions (so f32 comparisons hold f32 precision): the
     flash-attention and selective-scan kernels against their plain
     versions on edge cases and timed at the main path's shapes (flash in
     bf16 on its tensor-core design and in f32 on its FMA design); small
     models (smoke configs, f32) on the card against the CPU, prefill and
     greedy serving; full-depth bf16 prefill of qwen3-0.6b (4 x 2048) and
     falcon-mamba-7b (2 x 2048) through the kernels, then serving 16
     requests on 8 slots with each; prefill against token-by-token
     decode at full width in f32, depth cut to 4 layers.

  6. the event-horizon leap: a staggered static scenario (512 hosts of
     2 PEs, 256 VMs, 3 waves) leap on and leap off, bitwise equal, with
     fewer full steps on;
  7. the paper's largest datacenter under the 2x2 policy grid in one
     ``run_grid`` call (4 lanes, 2,000,000 slots a simstep launch): every
     lane equals its single run bitwise and meets the §5 closed forms;
  8. 64 lanes (16 seeds x the grid) of 256 shared hosts, 4 VMs on every
     host: every lane equals its single run bitwise;
  9. the §5 CLI (``repro_torch.launch.simulate --hosts 10000 --trace 64``)
     against the closed forms;
 10. ``s5-100k-dyn``: the paper's largest datacenter with an event table
     of all four kinds (1,000 hosts of busy VMs fail mid-wave and
     recover later, 500 other VMs are destroyed, 500 latent VMs with a
     cloudlet each are created), both task policies, against closed
     forms: surviving cloudlets at their static §5 times, exact FAILED
     counts, created VMs' cloudlets at their closed-form times, per-host
     joules with nothing drawn while a host is down;
 11. ``migration-16x``: ``bench_migration``'s threshold case at 16x its
     size (4,096 hosts, 1,536 VMs, three host failures, THRESHOLD 0.6),
     leap on == leap off bitwise, against the same run on the CPU, at
     least one migration;
 12. ``s5-100k-net``: the paper's largest datacenter staging 50 MB in and
     20 MB out per cloudlet over ``bench_network``'s topology, both task
     policies: every cloudlet done, byte conservation within the f32
     accumulation's bound; the same recipe at 10,000 hosts against the
     CPU;
 13. ``dyn-lanes``: 8 small dynamic and networked scenarios (numpy
     copies of the conformance recipes) x the 2x2 grid in one batch:
     every lane equals its single run bitwise, and the batch agrees with
     the CPU;
 14. streamed arrivals (``engine.run_stream``), level 2 on simstep
     through the regrouped window: ``stream-s5-100k``, the paper's
     largest datacenter as a stream in chunks of 65,536, space-shared
     through a window of two waves (a backlog of up to four; the
     resident closed forms, and the reservoir equal to the resident run)
     and time-shared through a window of every slot (equal to the
     resident run bitwise); ``stream-tight``, 10,000 hosts and 50,000
     arrivals through 5,000 slots, card == CPU and chunk 1,024 == chunk
     8,192 bitwise; ``stream-poisson``, ``bench_streaming``'s lane at
     2,000 arrivals, leap on == off bitwise and card == CPU, with
     cloudlets/s; ``stream-lanes``, 4 small streamed scenarios x the 2x2
     grid in one ``run_stream_grid``, every lane == its single run (the
     resident comparisons read every arrival's times from a reservoir of
     stride 1);
 15. ``s5-100k-elastic``: the paper's largest datacenter with a latent
     half (25,000 of 50,000 slots start VM_EMPTY, their cloudlets half as
     long), a watermark autoscaler and a four-segment spot track, both
     task policies: at least two scale-ups and two scale-downs, the fleet
     in its bounds on every ``run_trace`` record, actions a cooldown
     apart, the spot spend equal to the f64 integral of price x fleet,
     every cloudlet done, the card equal to the CPU;
 16. ``s5-100k-probed``: §5 time-shared with a metrics plane (32 buckets,
     24 bins, SLA factor 2): probes on == off on every other leaf, leap
     on == off with the plane, 500,000 retirements, the buckets spanning
     the makespan, busy seconds and SLA counters against closed forms;
 17. ``policy-search``: ``bench_elasticity``'s headroom lanes, 8 seeds x
     12 autoscaler points in one ``run_policy_search``: every cell ==
     its single run bitwise, card == CPU; then ``run_elasticity_study``
     with probes on, card == CPU on counts and the Pareto mask;
 18. ``elastic-stream-lanes``: 4 elastic streamed scenarios (numpy copies
     of the conformance recipe) x the 2x2 grid in one
     ``run_stream_grid``, every lane == its single run, card == CPU; a
     probed streamed lane (``bench_metrics``' lane at 2,000 arrivals),
     chunk 256 == chunk 4,096 bitwise and card == CPU;
 19. ``intercloud-100k``: the paper's largest datacenter split into a
     federation of four §5 host parks (10,000, 20,000, 30,000 and 40,000
     hosts at $0.01-0.05 a PE-s) shopped by ten users of 5,000 §5 VMs:
     the CIS and the broker route them (exactly [0,0,1,1,1,1,2,2,2,2]),
     the registry rows meet their closed forms and equal the CPU's, and
     ``run_study`` runs the 2x2 grid as 16 lanes padded to 40,000 hosts:
     every cell meets the §5 closed forms, the idle provider stays inert,
     provider 2's cells equal their single runs bitwise, and the card
     equals the CPU at 1/100 scale; routing and study walls apart;
 20. ``dispatch``: the ``lanes-64`` and ``dyn-lanes`` batches through the
     lane dispatcher (``sweep.run_sharded``) over [card] and [card,
     card], bitwise equal to ``run_batch``; ``federated_run`` over [card,
     card] bitwise equal to ``vmap_federation``;
 21. what the migration, network, elastic, probe and streaming passes cost
     a full step at 100,000 hosts (the same run, bit for bit, with each
     set switched on), with host ops a step counted on the CPU, and the
     wall of a host-plan rebuild.

Phase 2 also holds simstep with a task policy per row (a batch's lanes)
against its plain version, and times it at 4 lanes of [50000, 10]; and
on padded indexes (a streamed window's), against its plain version and
against the unpadded index.

Phases 3, 4 and 4b are the simulator's main path, and 6 to 20 each a
path of its own (20 two: the dispatched batches and the federated run): simstep's launch count is set to 0 just before phase 3
and read just after phase 4b, and set to 0 just before and read just
after each run of the later ones (``launches_by_path`` in the kernels'
record; every path must show launches).  The full-depth
prefills are the LM slice's main path: the flash-attention and
selective-scan counts are set to 0 just before each and read just after,
and the bf16 prefill's dtype must route its flash launches to the
tensor-core kernel.
The next-to-last line is the kernels' JSON record, the last the
device's.  Without a CUDA device, or outside a checkout, the script
fails before printing either.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32, outside tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# SFU (MUFU) exponentials: 16 per SM per clock on sm_90 (CUDA programming
# guide, arithmetic instruction throughput), 132 SMs at 1.98 GHz boost
SFU_OPS_PER_S = 16 * 132 * 1.98e9
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:66
SCAN_TOL = 2e-4                                     # tests/test_kernels.py:103
LM_CELLS = (("qwen3-0.6b", 4), ("falcon-mamba-7b", 2))   # (arch, batch)
# the scan kernel's design: N/4 lanes a channel, dt/x/B/C staged by cp.async
SCAN_DESIGN = "lane-split-cp.async"
PREFILL_LEN = 2048
RTOL = ATOL = 1e-6              # tests/test_simstep_parity.py's tolerance
SIMSTEP_DESIGN = "ragged-packed-warp"
CL_DONE = 2                     # repro_torch.core.state.CL_DONE
# simstep's ragged edge tiles (row lengths): both sides of the 32-slot
# window and of a 1,024-slot chunk, a 100,000-slot row; rows of 30-70
# slots; the main path's uniform rows; the skewed datacenter's rows
RAGGED = {"edges": [0, 1, 31, 32, 33, 64, 1024, 100_000],
          "around-64": list(range(30, 71)) * 3,
          "uniform": [10] * 50_000,
          "skewed": [200_000] + [6] * 49_999}

# JAX engine's §5 answers (BENCH_policies.json fig8_fig9 resp_by_wave)
SPACE_RESP = [1200.0 + 600.0 * w for w in range(10)]
TIME_RESP = [2200.0, 4823.5713, 6623.5713, 7423.5713, 7823.5713, 7973.5713,
             7853.5713, 7553.5713, 7125.0, 6600.0]


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, reps=200, warmup=3):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed, so host overhead is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(fn, reps=200):
    """Milliseconds per eager call (host dispatch included)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_tile(seed, v, k, device):
    """test_simstep_parity's tile: drained slots, an all-idle row, a
    zero-capacity row, a row with more PEs than slots."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rem = rng.uniform(0.0, 5000.0, (v, k)).astype(np.float32)
    rem[rng.uniform(size=(v, k)) < 0.15] = 0.0
    run = rng.uniform(size=(v, k)) < 0.7
    cap = rng.uniform(100.0, 2000.0, v).astype(np.float32)
    pes = rng.integers(1, 4, v).astype(np.float32)
    rows = rng.permutation(v)
    run[rows[0]] = False
    cap[rows[min(1, v - 1)]] = 0.0
    pes[rows[-1]] = k + rng.integers(1, 5)
    return [torch.from_numpy(a).to(device) for a in (rem, run, cap, pes)]


def ragged_tile(seed, lengths, device, gaps=True):
    """VM rows of the given lengths in a shuffled slot order, runs of slots
    of no row (vm -1 or V) between some of them, drained slots, an
    all-idle row, a zero-capacity row and a row with more PEs than slots.
    With ``gaps=False`` the rows lie in VM order with nothing between
    them, as a scenario builds them.  Returns (index, [remaining,
    runnable, cap, pes])."""
    import numpy as np
    import torch
    from repro_torch.kernels.simstep import row_index
    rng = np.random.default_rng(seed)
    v = len(lengths)
    if gaps:
        vm = []
        for r in rng.permutation(v):
            if rng.uniform() < 0.3:
                vm += [int(rng.choice([-1, v]))] * int(rng.integers(1, 4))
            vm += [int(r)] * int(lengths[r])
        vm = np.asarray(vm + [-1], np.int32)
    else:
        vm = np.repeat(np.arange(v, dtype=np.int32), lengths)
    c = vm.size
    rem = rng.uniform(0.0, 5000.0, c).astype(np.float32)
    rem[rng.uniform(size=c) < 0.15] = 0.0
    run = rng.uniform(size=c) < 0.7
    cap = rng.uniform(100.0, 2000.0, v).astype(np.float32)
    pes = rng.integers(1, 4, v).astype(np.float32)
    rows = rng.permutation(v)
    run[vm == rows[0]] = False
    cap[rows[min(1, v - 1)]] = 0.0
    pes[rows[-1]] = lengths[rows[-1]] + rng.integers(1, 5)
    index = row_index(torch.from_numpy(vm).to(device), v)
    return index, [torch.from_numpy(a).to(device)
                   for a in (rem, run, cap, pes)]


def padded_tile(seed, lengths, tail, device):
    """``ragged_tile``'s rows in VM order with ``tail`` slots of no row
    after them, as a streamed window's regrouped view lays them out.
    Returns (its ``row_index``, its ``padded_row_index``, [remaining,
    runnable, cap, pes])."""
    import torch
    from repro_torch.kernels.simstep import padded_row_index, row_index
    _, (rem, run, cap, pes) = ragged_tile(seed, lengths, device, gaps=False)
    v = len(lengths)
    vm = torch.cat([torch.arange(v, dtype=torch.int32).repeat_interleave(
        torch.as_tensor(lengths)), torch.full((tail,), -1,
                                              dtype=torch.int32)]).to(device)
    rem = torch.cat([rem, torch.full((tail,), 5.0, device=device)])
    run = torch.cat([run, torch.ones((tail,), dtype=torch.bool,
                                     device=device)])
    return (row_index(vm, v), padded_row_index(vm, v),
            [rem, run, cap, pes])


def simstep_bound(index, per_row=False):
    """(bound ms, bound_by, bytes) of one simstep call on ``index``: each
    slot's remaining, runnable and row id read and its rate written, each
    row's capacity and pes (and, ``per_row``, task policy) read and
    dt_min written, the window table, the empty-row list, the chunk table
    and the long rows' start and length read once; ~12 float operations
    a slot."""
    c, v = index.n_slots, index.n_rows
    n_long = int(index.chunk_first.unique().numel())
    moved = (c * (4 + 1 + 4 + 4) + v * (4 + 4 + 4 + 4 * per_row)
             + 4 * (not per_row)
             + 4 * index.window.numel() + 4 * index.empty.numel()
             + 8 * index.chunk_row.numel() + 8 * n_long)
    ops = c * 12
    by_bytes = moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
    bound = max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return bound, "bytes" if by_bytes else "operations", moved


def phase_kernels(device):
    """Phase 2: simstep against its plain version; returns its record
    (without the main path's launch count)."""
    import numpy as np
    import torch
    from repro_torch.kernels.simstep import (simstep, simstep_ragged,
                                             simstep_ragged_ref, simstep_ref)

    shapes = [(8, 16), (13, 8), (3, 128), (32, 4), (7, 33), (1000, 300),
              (50, 10), (50000, 10)]
    worst, cases, bitwise = 0.0, 0, 0
    for v, k in shapes:
        for seed in range(2):
            tile = random_tile(seed, v, k, device)
            for policy in (0, 1):
                pol = torch.tensor(policy, dtype=torch.int32, device=device)
                got = simstep(*tile, pol)
                want = simstep_ref(*tile, pol)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
                    worst = max(worst, float((g - w).abs().max()))
                cases += 1
                bitwise += all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"[kernels] simstep (dense wrapper) vs plain version: {cases} "
          f"tiles, both policies, rtol={RTOL} atol={ATOL}: "
          f"max_abs_err={worst!r}, bitwise equal on {bitwise}/{cases}")

    rcases = rbitwise = 0
    for name, lengths in RAGGED.items():
        for seed in range(2):
            index, (rem, run, cap, pes) = ragged_tile(seed, lengths, device)
            for policy in (0, 1):
                pol = torch.tensor(policy, dtype=torch.int32, device=device)
                got = simstep_ragged(rem, run, index, cap, pes, pol)
                want = simstep_ragged_ref(rem, run, index, cap, pes, pol)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
                    worst = max(worst, float((g - w).abs().max()))
                rcases += 1
                rbitwise += all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"[kernels] simstep_ragged vs plain version: {rcases} ragged "
          f"tiles ({', '.join(RAGGED)}; rows of no slot, slots of no row, "
          f"pes above a row's length, idle and zero-capacity rows), both "
          f"policies: max_abs_err={worst!r}, bitwise equal on "
          f"{rbitwise}/{rcases}")
    check(rbitwise == rcases and bitwise == cases,
          "simstep is not bitwise equal to its plain version")

    # a task policy per row, as a batch of lanes gives it
    pcases = pbitwise = 0
    for name, lengths in RAGGED.items():
        for seed in range(2):
            index, (rem, run, cap, pes) = ragged_tile(seed, lengths, device)
            pol = torch.from_numpy(np.random.default_rng(seed).integers(
                0, 2, index.n_rows).astype(np.int32)).to(device)
            got = simstep_ragged(rem, run, index, cap, pes, pol)
            want = simstep_ragged_ref(rem, run, index, cap, pes, pol)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                worst = max(worst, float((g - w).abs().max()))
            pcases += 1
            pbitwise += all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"[kernels] simstep_ragged with a task policy per row (a random "
          f"mix) vs plain version: {pcases} ragged tiles ({', '.join(RAGGED)}"
          f"): bitwise equal on {pbitwise}/{pcases}")
    check(pbitwise == pcases, "simstep with a task policy per row is not "
          "bitwise equal to its plain version")

    # a padded index (a streamed window's, sizes fixed by the slot count):
    # empty spans, -1 empty rows and -1 chunks must write nothing
    from repro_torch.kernels.simstep import padded_row_index
    dcases = dbitwise = 0
    for name, lengths in RAGGED.items():
        for tail in (0, 37):
            index, padded, (rem, run, cap, pes) = padded_tile(
                0, lengths, tail, device)
            pol = torch.from_numpy(np.random.default_rng(tail).integers(
                0, 2, index.n_rows).astype(np.int32)).to(device)
            got = simstep_ragged(rem, run, padded, cap, pes, pol)
            want = simstep_ragged_ref(rem, run, padded, cap, pes, pol)
            exact = simstep_ragged(rem, run, index, cap, pes, pol)
            torch.cuda.synchronize()
            dcases += 1
            dbitwise += all(torch.equal(g, w) and torch.equal(g, e)
                            for g, w, e in zip(got, want, exact))
    print(f"[kernels] simstep_ragged on padded indexes (empty spans, -1 "
          f"empty-row and chunk entries) vs plain version and vs the "
          f"unpadded index: {dcases} grouped tiles ({', '.join(RAGGED)}, "
          f"with and without slots of no row at the end): bitwise equal on "
          f"{dbitwise}/{dcases}")
    check(dbitwise == dcases, "simstep on a padded index disagrees")

    times = {}
    pol = torch.tensor(1, dtype=torch.int32, device=device)
    index, padded, (rem, run, cap, pes) = padded_tile(0, RAGGED["uniform"],
                                                      0, device)
    padded_ms = device_ms(lambda: simstep_ragged(rem, run, padded, cap, pes,
                                                 pol))
    print(f"[kernels] simstep_ragged uniform on its padded index "
          f"({padded.window.numel() - 1} spans, "
          f"{padded.chunk_row.numel()} chunk entries, all padding past "
          f"{index.window.numel() - 1} and 0): kernel {padded_ms!r} ms "
          f"(device, graph replay)")
    for name in ("uniform", "skewed"):
        index, (rem, run, cap, pes) = ragged_tile(0, RAGGED[name], device,
                                                  gaps=False)
        call = lambda: simstep_ragged(rem, run, index, cap, pes, pol)
        ms = device_ms(call)
        plain_ms = device_ms(
            lambda: simstep_ragged_ref(rem, run, index, cap, pes, pol))
        call_ms = eager_ms(call)
        bound_ms, bound_by, moved = simstep_bound(index)
        times[name] = (ms, plain_ms, bound_ms, bound_by)
        print(f"[kernels] simstep_ragged {name} ({index.n_rows} rows, "
              f"{index.n_slots} slots, {index.window.numel() - 1} windows, "
              f"{index.chunk_row.numel()} long-row chunks) on the "
              f"{SIMSTEP_DESIGN} design: kernel {ms!r} ms "
              f"(device, graph replay), eager call {call_ms!r} ms, plain "
              f"version {plain_ms!r} ms, bound {bound_ms!r} ms ({moved} "
              f"bytes, {bound_by}), library call: none")
    # the fused grid's level 2: 4 lanes of [50000, 10], the task policy
    # of lane p on its rows (policy_grid's 0, 1, 0, 1)
    index, (rem, run, cap, pes) = ragged_tile(0, [10] * 200_000, device,
                                              gaps=False)
    pol = torch.tensor([0, 1, 0, 1], dtype=torch.int32,
                       device=device).repeat_interleave(50_000)
    got = simstep_ragged(rem, run, index, cap, pes, pol)
    want = simstep_ragged_ref(rem, run, index, cap, pes, pol)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "simstep on 4 lanes with a task policy per row disagrees")
    call = lambda: simstep_ragged(rem, run, index, cap, pes, pol)
    grid_ms = device_ms(call)
    grid_plain_ms = device_ms(
        lambda: simstep_ragged_ref(rem, run, index, cap, pes, pol))
    grid_bound_ms, grid_by, moved = simstep_bound(index, per_row=True)
    print(f"[kernels] simstep_ragged 4 lanes x [50000, 10] ({index.n_slots} "
          f"slots, {index.n_rows} rows, a task policy per row) on the "
          f"{SIMSTEP_DESIGN} design: kernel {grid_ms!r} ms (device, graph "
          f"replay), plain version {grid_plain_ms!r} ms, bound "
          f"{grid_bound_ms!r} ms ({moved} bytes, {grid_by}), bitwise equal")
    ms, plain_ms, bound_ms, bound_by = times["uniform"]
    return {"name": "simstep", "route": "cuda", "design": SIMSTEP_DESIGN,
            "source": "src/repro_torch/kernels/simstep/csrc/simstep.cu",
            "replaces": "src/repro/kernels/simstep/simstep.py:49",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "skewed_ms": times["skewed"][0],
            "skewed_plain_ms": times["skewed"][1],
            "skewed_bound_ms": times["skewed"][2],
            "padded_ms": padded_ms,
            "per_row_slots": index.n_slots, "per_row_ms": grid_ms,
            "per_row_plain_ms": grid_plain_ms,
            "per_row_bound_ms": grid_bound_ms}


def section5(n_hosts, n_vms, policy, device):
    """The §5 scenario: paper hosts (1 PE @1000 MIPS, 1 GB, 2 TB) with a
    100 W idle / 200 W peak linear power model, ``n_vms`` 1-PE VMs, ten
    waves of 1.2M MI cloudlets 600 s apart, PEs reserved."""
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    hosts = S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                                 device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=10, length_mi=1_200_000.0,
                                         period=600.0), device=device)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=policy, reserve_pes=True,
                             rates=S.make_market(0.01, 0.001, 1e-4, 0.002,
                                                 device=device),
                             device=device)


def check_section5(final, stats, policy, n_vms, tag):
    """The closed-form §5 answers, per wave and per host (``stats``, the
    run's ``RunStats`` for the printed line, may be None)."""
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    rep = B.collect(final)
    n_cl = 10 * n_vms
    check(int(rep.n_completed) == n_cl and int(rep.n_failed) == 0,
          f"{tag}: {int(rep.n_completed)}/{n_cl} done")
    check(float(rep.makespan) == 12000.0, f"{tag}: makespan "
          f"{float(rep.makespan)!r}")
    cl = final.cloudlets
    ft = cl.finish_time.double().cpu().numpy()
    st = cl.start_time.double().cpu().numpy()
    sub = cl.submit_time.double().cpu().numpy()
    wave = np.rint(sub / 600.0).astype(int)
    resp = [float((ft - sub)[wave == w].mean()) for w in range(10)]
    if policy == S.SPACE_SHARED:
        check(bool(np.all(ft - st == 1200.0)), f"{tag}: exec != 1200 s")
        check(resp == SPACE_RESP, f"{tag}: response by wave {resp}")
    else:
        err = max(abs(a - b) for a, b in zip(resp, TIME_RESP))
        check(err <= 1e-3, f"{tag}: response by wave {resp} (err {err})")
        # every VM's cloudlets are alike, so every VM gives the same answer
        per_vm = (ft - sub).reshape(n_vms, 10)
        check(bool(np.all(np.abs(per_vm - per_vm[0]) <= 1e-3)),
              f"{tag}: VMs disagree")
    energy = final.hosts.energy_j.double().cpu().numpy()
    busy = np.zeros(energy.shape[0], bool)
    busy[final.vms.host.cpu().numpy()] = True
    e_busy = np.abs(energy[busy] / 2.4e6 - 1.0).max()
    e_idle = (np.abs(energy[~busy] / 1.2e6 - 1.0).max() if (~busy).any()
              else 0.0)                 # a park with every host busy
    check(busy.sum() == n_vms and e_busy <= 1e-5 and e_idle <= 1e-5,
          f"{tag}: energy off by {e_busy!r} (busy), {e_idle!r} (idle)")
    exec_t = ft - st
    steps = ("" if stats is None else
             f"{stats.n_events} events in {stats.n_steps} steps, "
             f"{stats.n_blocks} host checks, ")
    print(f"[{tag}] {int(rep.n_completed)}/{n_cl} done, exec "
          f"{exec_t.min():.4f}-{exec_t.max():.4f} s, makespan "
          f"{float(rep.makespan)!r} s, response by wave {resp}, energy "
          f"rel err busy {e_busy:.3g} idle {e_idle:.3g}, "
          f"{steps}bill ${float(rep.total_cost):.2f}")


def state_bytes(dc):
    import dataclasses
    import torch
    total = 0
    for f in dataclasses.fields(dc):
        v = getattr(dc, f.name)
        total += (v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                  else state_bytes(v))
    return total


def phase_section5(device, card, n_hosts=10_000):
    """Phase 3: §5 at the paper's 10,000 hosts."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        dc = section5(n_hosts, 50, policy, device)
        before = simstep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = simstep.launches - before
        check(launched == stats.n_steps >= stats.n_full,
              f"simstep launches {launched}, steps {stats.n_steps}, full "
              f"steps {stats.n_full}")
        check_section5(final, stats, policy, 50, f"s5-10k-{policy}")
        print(f"[s5-10k-{policy}] wall {wall!r} s, simstep launches "
              f"{launched} ({card})")


def phase_agreement(device):
    """A small heterogeneous scenario run on the card and on the CPU (the
    plain kernel): the whole engine agrees, not only the kernel."""
    import numpy as np
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats

    rng = np.random.default_rng(7)
    hosts = dict(num_pes=rng.integers(1, 4, 6),
                 mips_per_pe=rng.choice([250.0, 500.0, 1000.0], 6),
                 ram=4096.0, bw=1000.0, storage=1e6, idle_w=0.1, peak_w=0.5)
    vm_pes = rng.integers(1, 3, 8)
    owners = np.repeat(np.arange(8, dtype=np.int32), rng.integers(0, 5, 8))
    lengths = np.round(rng.uniform(500, 8000, owners.size)).astype(np.float32)
    submit = np.round(rng.uniform(0, 20, owners.size), 2).astype(np.float32)
    submit = np.concatenate([np.sort(submit[owners == v]) for v in range(8)])
    vm_sub = np.round(rng.uniform(0, 5, 8), 2).astype(np.float32)
    for vp in (S.SPACE_SHARED, S.TIME_SHARED):
        for tp in (S.SPACE_SHARED, S.TIME_SHARED):
            outs = []
            for dev in (device, "cpu"):
                dc = S.make_datacenter(
                    S.make_hosts(**hosts, device=dev),
                    S.make_vms(vm_pes, 500.0, 64.0, 1.0, 10.0,
                               submit_time=vm_sub, device=dev),
                    S.make_cloudlets(owners, lengths, submit, device=dev),
                    vm_policy=vp, task_policy=tp, reserve_pes=False,
                    device=dev)
                outs.append(run_stats(dc, max_steps=512))
            (gpu, gs), (cpu, cs) = outs
            check(gs.n_events == cs.n_events, "small scenario: event counts")
            check(torch.equal(gpu.cloudlets.state.cpu(), cpu.cloudlets.state),
                  "small scenario: cloudlet states")
            check(torch.equal(gpu.vms.host.cpu(), cpu.vms.host),
                  "small scenario: placements")
            err = float((gpu.cloudlets.finish_time.cpu()
                         - cpu.cloudlets.finish_time).abs().max())
            e_err = float((gpu.hosts.energy_j.cpu()
                           - cpu.hosts.energy_j).abs().max())
            check(err <= 1e-3 and e_err <= 1e-3,
                  f"small scenario: finish err {err}, energy err {e_err}")
    print(f"[small] card == CPU on a random 6-host/8-VM/{owners.size}-cloudlet"
          f" scenario, all four policy pairs (states, placements, events "
          f"exact; times and joules within 1e-3)")


def phase_scale(device, card, n_hosts=100_000, n_vms=50_000):
    """Phase 4: the paper's largest datacenter."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from repro_torch.core.provisioning import provision_pending
    from repro_torch.kernels.simstep import simstep

    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        dc = section5(n_hosts, n_vms, policy, device)
        nbytes = state_bytes(dc)
        before = simstep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = simstep.launches - before
        check(launched == stats.n_steps >= stats.n_full,
              f"simstep launches {launched}, steps {stats.n_steps}")
        tag = f"s5-100k-{policy}"
        check_section5(final, stats, policy, n_vms, tag)
        # the two parts of the run, timed apart: placing the fleet, then
        # stepping the placed state to quiescence
        t0 = time.perf_counter()
        placed = provision_pending(dc)
        torch.cuda.synchronize()
        prov = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_stats(placed, max_steps=8192)
        torch.cuda.synchronize()
        stepping = time.perf_counter() - t0
        print(f"[{tag}] {n_hosts} hosts, {n_vms} VMs, {10 * n_vms} "
              f"cloudlets: wall {wall!r} s, {stats.n_events} events, "
              f"{stats.n_events / wall!r} events/s; timed apart: "
              f"provisioning {prov!r} s, stepping {stepping!r} s; state "
              f"{nbytes} bytes on the device, peak allocated "
              f"{torch.cuda.max_memory_allocated()} bytes ({card})")


def phase_skewed(device, card, n_hosts=100_000, n_vms=50_000, big=200_000,
                 small=6):
    """Phase 4b: the paper's largest datacenter with a skewed binding: one
    wave at t = 0 of 1,200,000 MI cloudlets, VM 0 holding ``big`` and
    every other VM ``small``; time-shared only (space-shared would take
    VM 0's cloudlets one event each).  Closed forms: VM v's cloudlets all
    finish at n_v * 1.2e6 / 1000 s, in 2 events; its host draws 200 W
    until then and 100 W after, until the last event; idle hosts 100 W
    throughout."""
    import numpy as np
    import torch
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    counts = np.full(n_vms, small)
    counts[0] = big
    owners = np.repeat(np.arange(n_vms, dtype=np.int32), counts)
    dc = S.make_datacenter(
        S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                             device=device),
        B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0, ram=512.0,
                                bw=10.0, size=1000.0)], device=device),
        S.make_cloudlets(owners, 1_200_000.0, device=device),
        vm_policy=S.SPACE_SHARED, task_policy=S.TIME_SHARED,
        reserve_pes=True, device=device)
    nbytes = state_bytes(dc)
    tag = "s5-100k-skewed" if n_hosts == 100_000 else f"s5-{n_hosts}-skewed"
    before = simstep.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final, stats = run_stats(dc, max_steps=8192)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = simstep.launches - before
    check(launched == stats.n_steps > 0, f"{tag}: simstep launches "
          f"{launched}, steps {stats.n_steps}")
    rep = B.collect(final)
    n_cl = int(counts.sum())
    check(int(rep.n_completed) == n_cl and int(rep.n_failed) == 0,
          f"{tag}: {int(rep.n_completed)}/{n_cl} done")
    check(stats.n_events == 2, f"{tag}: {stats.n_events} events, want 2")
    finish = final.cloudlets.finish_time.double().cpu().numpy()
    want = counts[owners] * 1.2e6 / 1000.0
    # 1e-6 relative: f32 spacing at 2.4e8 s is 16 s (6.7e-8 relative),
    # and the clock takes two f32 steps to get there
    t_err = float(np.abs(finish / want - 1.0).max())
    check(t_err <= 1e-6, f"{tag}: finish times off by {t_err!r} relative")
    t_end = big * 1.2e6 / 1000.0
    energy = final.hosts.energy_j.double().cpu().numpy()
    want_e = np.full(n_hosts, 100.0 * t_end)
    host = final.vms.host.cpu().numpy()
    busy = counts * 1.2e6 / 1000.0
    want_e[host] = 200.0 * busy + 100.0 * (t_end - busy)
    e_err = float(np.abs(energy / want_e - 1.0).max())
    check(e_err <= 1e-5, f"{tag}: energy off by {e_err!r} relative")
    print(f"[{tag}] {n_hosts} hosts, {n_vms} VMs, {n_cl} cloudlets (VM 0 "
          f"holds {big}, the others {small}), time-shared: {n_cl}/{n_cl} "
          f"done, finish times rel err {t_err:.3g}, energy rel err "
          f"{e_err:.3g}; wall {wall!r} s, {stats.n_events} events in "
          f"{stats.n_steps} steps, simstep launches {launched}; state "
          f"{nbytes} bytes on the device, peak allocated "
          f"{torch.cuda.max_memory_allocated()} bytes ({card})")


def staggered(device, n_hosts=512, n_vms=256, waves=3, seed=0):
    """tests/test_leap_parity.py's drain-safe workload (its recipe,
    copied): hosts of 2 PEs and 2 GB, 1-PE VMs, waves of 600,000 MI
    every 300 s with each cloudlet's length jittered by up to 40%,
    reserved PEs, time-shared VMs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    rng = np.random.default_rng(seed)
    hosts = S.make_uniform_hosts(n_hosts, pes=2, ram=2048.0, device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=waves, length_mi=600_000.0,
                                         period=300.0), device=device)
    jit = torch.from_numpy((1.0 + 0.4 * rng.random(
        tuple(cl.length.shape))).astype(np.float32)).to(device)
    cl = dataclasses.replace(cl, length=cl.length * jit,
                             remaining=cl.remaining * jit)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=S.TIME_SHARED, reserve_pes=True,
                             device=device)


def same_state(a, b):
    """Every leaf of two states equal, bit for bit."""
    import torch
    from repro_torch.core.state import tensor_leaves
    return all(bool(torch.equal(x, y))
               for x, y in zip(tensor_leaves(a), tensor_leaves(b)))


def lane(batch, *idx):
    from repro_torch.core.state import map_tensors
    return map_tensors(lambda t: t[idx], batch)


def phase_leap(device, card, launched, n_hosts=512, n_vms=256):
    """Phase 6: the event-horizon leap on the card, on a staggered static
    scenario, leap on against leap off: bitwise equal, some step commits
    more than one event, and the leap takes fewer full steps."""
    import torch
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    dc = staggered(device, n_hosts, n_vms)
    out = {}
    for leap in (False, True):
        torch.cuda.synchronize()
        simstep.launches = 0
        t0 = time.perf_counter()
        final, stats = run_stats(dc, leap=leap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched["leap" if leap else "leap-off"] = simstep.launches
        check(simstep.launches == stats.n_steps > 0,
              f"leap={leap}: launches {simstep.launches}, steps "
              f"{stats.n_steps}")
        out[leap] = (final, stats, wall)
    (off, s_off, w_off), (on, s_on, w_on) = out[False], out[True]
    n_cl = 3 * n_vms
    done = int((on.cloudlets.state == CL_DONE).sum())
    check(done == n_cl, f"leap: {done}/{n_cl} done")
    check(same_state(on, off), "leap on != leap off")
    check(s_on.n_events == s_off.n_events == s_off.n_full,
          f"leap: events {s_on.n_events} vs {s_off.n_events}")
    check(s_on.n_events > s_on.n_full, "leap: no step committed more than "
          "one event")
    check(s_on.n_full < s_off.n_full, f"leap: {s_on.n_full} full steps, "
          f"leap off {s_off.n_full}")
    print(f"[leap] staggered {n_hosts} hosts x 2 PEs, {n_vms} VMs, {n_cl} "
          f"cloudlets: leap on == leap off bitwise, {s_on.n_events} events; "
          f"leap off {s_off.n_full} full steps in {w_off!r} s "
          f"({s_off.n_blocks} host checks); leap on {s_on.n_full} full "
          f"steps and {s_on.n_events - s_on.n_full} leapt events "
          f"({s_on.n_leap} leap iterations, {s_on.n_blocks} host checks) "
          f"in {w_on!r} s ({card})")


def phase_grid(device, card, launched, n_hosts=100_000, n_vms=50_000):
    """Phase 7: the paper's largest datacenter under the 2x2 policy grid
    in one run_grid call: 4 lanes, 4 x 500,000 slots in each simstep
    launch.  Every lane equals its single run bit for bit and meets the
    §5 closed forms for its task policy."""
    import dataclasses
    import torch
    from repro_torch.core import sweep
    from repro_torch.core.engine import batched_run_stats, run_stats
    from repro_torch.kernels.simstep import simstep

    batch = sweep.stack_scenarios([section5(n_hosts, n_vms, 0, device)])
    vm_p, task_p = sweep.policy_grid(device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    simstep.launches = 0
    t0 = time.perf_counter()
    grid = sweep.run_grid(batch, vm_p, task_p, max_steps=8192)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched["grid-100k"] = n_grid = simstep.launches
    peak = torch.cuda.max_memory_allocated()
    _, gstats = batched_run_stats(sweep.fuse_grid(batch, vm_p, task_p),
                                  max_steps=8192)
    check(n_grid == gstats.n_steps > 0, f"grid: {n_grid} simstep launches "
          f"for {gstats.n_steps} full steps of 4 lanes")
    singles, n_single = 0.0, 0
    for p, (vp, tp) in enumerate(zip(vm_p.tolist(), task_p.tolist())):
        dc = dataclasses.replace(section5(n_hosts, n_vms, tp, device),
                                 vm_policy=vm_p[p].clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        singles += time.perf_counter() - t0
        n_single += stats.n_steps
        check(same_state(lane(grid, p, 0), single),
              f"grid lane {p} ({vp},{tp}) != its single run")
        check_section5(single, stats, tp, n_vms, f"grid-{vp}{tp}")
    print(f"[grid-100k] {n_hosts} hosts, {n_vms} VMs, {10 * n_vms} "
          f"cloudlets x policy_grid() in one run_grid: 4 lanes, "
          f"{4 * 10 * n_vms} slots a simstep launch; every lane == its "
          f"single run bitwise and meets the §5 closed forms; batched wall "
          f"{wall!r} s, the four single runs {singles!r} s; simstep "
          f"launches {n_grid} (single runs {n_single}); peak allocated "
          f"{peak} bytes ({card})")


def shared_hosts(seed, n_hosts, device):
    """benchmarks/bench_policies.py::bench_sweep's lanes with shared
    hosts: 4 VMs on every 1-PE host, PEs not reserved, 4 waves of a
    per-seed length.  Two VM classes of per-seed MIPS, each in one run
    of slots (so first fit places a run at a time): 2*H VMs of 768 MB,
    two to a 2 GB host, then 2*H of 256 MB in the 512 MB left.  A host's
    time-shared demand is a sum of unequal f32 terms, whose value
    depends on the order of the additions."""
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    rng = np.random.default_rng(seed)
    half = 2 * n_hosts
    mips = np.repeat(np.round(rng.uniform(200.0, 1000.0, 2), 3), half)
    length = float(rng.integers(600, 1200) * 1000)
    return S.make_datacenter(
        S.make_uniform_hosts(n_hosts, ram=2048.0, idle_w=100.0,
                             peak_w=200.0, device=device),
        S.make_vms(np.ones(2 * half), mips, np.repeat([768.0, 256.0], half),
                   10.0, 1000.0, device=device),
        B.build_waves(2 * half, B.WaveSpec(waves=4, length_mi=length,
                                           period=600.0), device=device),
        reserve_pes=False, device=device)


def phase_lanes(device, card, launched, n_seeds=16, n_hosts=256):
    """Phase 8: 64 lanes (16 seeds x the 2x2 grid) of shared hosts in one
    run_grid: 4 VMs placed on every host, and every lane equals its single
    run bit for bit (the check on the order of per-host sums)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import sweep
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    base = [shared_hosts(seed, n_hosts, device) for seed in range(n_seeds)]
    vm_p, task_p = sweep.policy_grid(device=device)
    torch.cuda.synchronize()
    simstep.launches = 0
    t0 = time.perf_counter()
    grid = sweep.run_grid(sweep.stack_scenarios(base), vm_p, task_p,
                          max_steps=1 << 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched["lanes-64"] = n_grid = simstep.launches
    hosts = grid.vms.host.reshape(-1, 4 * n_hosts).cpu().numpy()
    per_host = np.stack([np.bincount(h, minlength=n_hosts) for h in hosts])
    check(bool((per_host == 4).all()), "lanes: not 4 VMs on every host")
    singles, events, lanes = 0.0, 0, 4 * n_seeds
    for p in range(4):
        for b, dc in enumerate(base):
            cell = dataclasses.replace(dc, vm_policy=vm_p[p].clone(),
                                       task_policy=task_p[p].clone())
            t0 = time.perf_counter()
            single, stats = run_stats(cell, max_steps=1 << 20)
            torch.cuda.synchronize()
            singles += time.perf_counter() - t0
            events += stats.n_events
            check(same_state(lane(grid, p, b), single),
                  f"lanes: lane {p},{b} != its single run")
            done = int((single.cloudlets.state == CL_DONE).sum())
            check(done == 16 * n_hosts, f"lanes: {done} done in {p},{b}")
    print(f"[lanes-64] {lanes} lanes ({n_seeds} seeds x the 2x2 grid) of "
          f"{n_hosts} hosts with 4 VMs on every host, reserve_pes off, 4 "
          f"waves: every lane == its single run bitwise; {events} events; "
          f"batched wall {wall!r} s ({n_grid} simstep launches), the "
          f"{lanes} single runs {singles!r} s ({card})")


def phase_simulate(device, card, launched, n_hosts=10_000):
    """Phase 9: the §5 CLI (repro_torch.launch.simulate) on the card,
    --trace 64: completions and makespan equal the closed forms."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels.simstep import simstep

    from repro_torch.launch import simulate
    buf = io.StringIO()
    simstep.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, rep = simulate.main(["--hosts", str(n_hosts), "--trace", "64",
                                "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched["simulate"] = simstep.launches
    check(int(rep.n_completed) == 500 and int(rep.n_failed) == 0,
          f"simulate: {int(rep.n_completed)}/500 done")
    check(float(rep.makespan) == 12000.0,
          f"simulate: makespan {float(rep.makespan)!r}")
    lines = buf.getvalue().splitlines()
    for line in lines[-4:]:
        print(line)
    print(f"[simulate-cli] --hosts {n_hosts} --trace 64 on the card: 500/500 "
          f"done, makespan 12000.0 s; wall {wall!r} s, {simstep.launches} "
          f"simstep launches ({card})")


# ---------------------------------------------------------------------------
# Dynamic datacenters and the network (phases 10-13)
# ---------------------------------------------------------------------------
# s5-100k-dyn's event times: failures mid-wave 0, a destroy mid-wave 2,
# recoveries, then the latent VMs' creation; none falls on a completion
T_FAIL, T_DESTROY, T_RECOVER, T_CREATE = 300.0, 3100.0, 4500.0, 6300.0


def s5_dynamic(n_hosts, n_vms, policy, device, n_fail, n_destroy,
               n_create):
    """The §5 datacenter with an event table of all four kinds: the hosts
    of VMs 0..n_fail-1 (first fit puts VM v on host v) fail at T_FAIL
    and recover at T_RECOVER; VMs n_fail..n_fail+n_destroy-1 are
    destroyed at T_DESTROY; n_create latent (VM_EMPTY) slots, each with
    one 1,200,000 MI cloudlet submitted at T_CREATE, are created then.
    Migration off, PEs reserved."""
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    hosts = S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                                 device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms + n_create, pes=1,
                                  mips=1000.0, ram=512.0, bw=10.0,
                                  size=1000.0)], device=device)
    vms.state[n_vms:] = S.VM_EMPTY
    waves = B.build_waves(n_vms, B.WaveSpec(waves=10, length_mi=1_200_000.0,
                                            period=600.0), device="cpu")
    latent = np.arange(n_vms, n_vms + n_create)
    cl = S.make_cloudlets(
        np.concatenate([waves.vm.numpy(), latent]), 1_200_000.0,
        np.concatenate([waves.submit_time.numpy(),
                        np.full(n_create, T_CREATE, np.float32)]),
        0.3, 0.3, device=device)
    fail = np.arange(n_fail)
    doomed = np.arange(n_fail, n_fail + n_destroy)
    events = S.make_events(
        np.repeat([T_FAIL, T_RECOVER, T_DESTROY, T_CREATE],
                  [n_fail, n_fail, n_destroy, n_create]),
        np.repeat([S.EV_HOST_FAIL, S.EV_HOST_RECOVER, S.EV_VM_DESTROY,
                   S.EV_VM_CREATE], [n_fail, n_fail, n_destroy, n_create]),
        np.concatenate([fail, fail, doomed, latent]), device=device)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=policy, reserve_pes=True,
                             rates=S.make_market(0.01, 0.001, 1e-4, 0.002,
                                                 device=device),
                             events=events, device=device)


def check_s5_dynamic(final, policy, n_vms, n_fail, n_destroy, n_create,
                     tag):
    """Closed forms of ``s5_dynamic``.  Every VM sits alone on an
    identical 1-PE host, so an evicted VM re-placed in the same instant
    keeps its schedule: every cloudlet of a surviving VM finishes at its
    static §5 time (submit + the wave's response); a destroyed VM's
    cloudlets with a static finish after T_DESTROY are FAILED, the others
    DONE; a created VM's cloudlet finishes at T_CREATE + 1200 s.  A host
    draws 100 W while up, 200 W while its VM runs, 0 W while down:
    busy for 12,000 s under a surviving VM, until T_FAIL under an evicted
    one and from T_FAIL on under its new host, until T_DESTROY under a
    destroyed one, 1,200 s under a created one, and down from T_FAIL to
    T_RECOVER.  Returns the largest errors."""
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    t_end = 12000.0
    resp = SPACE_RESP if policy == S.SPACE_SHARED else TIME_RESP
    cl, vms = final.cloudlets, final.vms
    vm = cl.vm.cpu().numpy()
    sub = cl.submit_time.double().cpu().numpy()
    fin = cl.finish_time.double().cpu().numpy()
    state = cl.state.cpu().numpy()
    orig = vm < n_vms
    wave = np.where(orig, np.rint(sub / 600.0), 0).astype(int)
    static_fin = np.where(orig, sub + np.asarray(resp)[wave],
                          T_CREATE + 1200.0)
    doomed = (vm >= n_fail) & (vm < n_fail + n_destroy)
    want_failed = doomed & (static_fin > T_DESTROY)
    per_vm = int(sum(600.0 * w + resp[w] > T_DESTROY for w in range(10)))
    rep = B.collect(final)
    check(int(rep.n_failed) == n_destroy * per_vm == int(want_failed.sum()),
          f"{tag}: {int(rep.n_failed)} FAILED, want {n_destroy} x {per_vm}")
    check(bool(np.all((state == S.CL_FAILED) == want_failed))
          and bool(np.all((state == S.CL_DONE) == ~want_failed)),
          f"{tag}: cloudlet states off the closed form")
    t_err = float(np.abs(fin - static_fin)[~want_failed].max())
    check(t_err <= 1e-3, f"{tag}: finish times off by {t_err!r} s")
    host = vms.host.cpu().numpy()
    vstate = vms.state.cpu().numpy()
    ids = np.arange(n_vms + n_create)
    stays = (ids >= n_fail + n_destroy) & (ids < n_vms)
    evicted, created = ids < n_fail, ids >= n_vms
    check(bool(np.all(host[stays] == ids[stays])),
          f"{tag}: a surviving VM left its first-fit host")
    gone = (ids >= n_fail) & (ids < n_fail + n_destroy)
    check(bool(np.all(vstate[gone] == S.VM_DESTROYED))
          and bool(np.all(host[gone] == -1)), f"{tag}: destroyed VMs")
    moved = np.concatenate([host[evicted], host[created]])
    check(bool(np.all(vstate[evicted | created | stays] == S.VM_ACTIVE))
          and np.unique(moved).size == moved.size
          and bool(np.all(host[evicted] >= n_vms)),
          f"{tag}: evicted and created VMs not on distinct free hosts")
    check(bool(final.hosts.valid.all()) and bool(final.event_fired.all())
          and abs(float(final.time) - t_end) <= 1e-3,
          f"{tag}: hosts down, events unfired or clock "
          f"{float(final.time)!r} at the end")
    n_hosts = final.hosts.num_pes.shape[0]
    up = np.full(n_hosts, t_end)
    up[:n_fail] -= T_RECOVER - T_FAIL
    busy = np.zeros(n_hosts)
    np.add.at(busy, ids[stays], t_end)
    np.add.at(busy, ids[evicted], T_FAIL)
    np.add.at(busy, host[evicted], t_end - T_FAIL)
    np.add.at(busy, ids[gone], T_DESTROY)
    np.add.at(busy, host[created], 1200.0)
    want_e = 100.0 * up + 100.0 * busy
    energy = final.hosts.energy_j.double().cpu().numpy()
    e_err = float(np.abs(energy / want_e - 1.0).max())
    check(e_err <= 1e-5, f"{tag}: energy off by {e_err!r} relative")
    return t_err, e_err, per_vm


def run_line(stats):
    """What a run did, for the phase lines."""
    return (f"{stats.n_events} events, {stats.n_full} full steps of "
            f"{stats.n_steps} evaluated, {stats.n_leap} leap iterations, "
            f"{stats.n_blocks} host checks, {stats.n_plans} plan rebuilds")


def phase_s5_dynamic(device, card, launched, n_hosts=100_000,
                     n_vms=50_000, n_fail=1000, n_destroy=500,
                     n_create=500):
    """Phase 10: the paper's largest datacenter with host failures and
    recoveries, VM destroys and VM creates (``s5_dynamic``), both task
    policies, against its closed forms."""
    import torch
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    tag = "s5-100k-dyn" if n_hosts == 100_000 else f"s5-{n_hosts}-dyn"
    simstep.launches = 0
    for policy in (0, 1):
        dc = s5_dynamic(n_hosts, n_vms, policy, device, n_fail, n_destroy,
                        n_create)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_err, e_err, per_vm = check_s5_dynamic(
            final, policy, n_vms, n_fail, n_destroy, n_create,
            f"{tag}-{policy}")
        print(f"[{tag}-{policy}] {n_hosts} hosts, {n_vms} VMs + {n_create} "
              f"created, {10 * n_vms + n_create} cloudlets; {n_fail} hosts "
              f"down {T_FAIL}-{T_RECOVER} s, {n_destroy} VMs destroyed at "
              f"{T_DESTROY} s ({per_vm} cloudlets each FAILED), {n_create} "
              f"created at {T_CREATE} s: closed forms hold (finish err "
              f"{t_err:.3g} s, energy rel err {e_err:.3g}); wall {wall!r} s,"
              f" {run_line(stats)} ({card})")
    launched["s5-100k-dyn"] = simstep.launches


def migration_scenario(device, scale=16):
    """``benchmarks/bench_policies.py::bench_migration``'s threshold case
    (its recipe, copied) at ``scale`` times its size: 256*scale hosts of
    2 PEs and 2,048 MB, 96*scale one-PE VMs, 4 waves of 600,000 MI every
    300 s with each length jittered by up to +-30%, hosts 0, 1 and 2
    failing at 200, 500 and 900 s, THRESHOLD migration at 0.6, reserved
    PEs, space-shared VMs and time-shared tasks."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    n_hosts, n_vms = 256 * scale, 96 * scale
    rng = np.random.default_rng(7)
    hosts = S.make_uniform_hosts(n_hosts, pes=2, ram=2048.0, device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=4, length_mi=600_000.0,
                                         period=300.0), device=device)
    jit = torch.from_numpy((0.7 + 0.6 * rng.random(
        tuple(cl.length.shape))).astype(np.float32)).to(device)
    cl = dataclasses.replace(cl, length=cl.length * jit,
                             remaining=cl.remaining * jit)
    events = S.make_events([200.0, 500.0, 900.0], [S.EV_HOST_FAIL] * 3,
                           [0, 1, 2], device=device)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=S.TIME_SHARED, reserve_pes=True,
                             events=events, mig_policy=S.MIG_THRESHOLD,
                             mig_threshold=0.6, device=device)


def agree(gpu, cpu, g_stats, c_stats, tag):
    """The card's final state against the CPU's (the plain kernel):
    states, placements, event and migration counts exact; times, joules,
    downtime and transferred MB within 1e-3.  Returns the largest float
    error."""
    import torch
    check(g_stats.n_events == c_stats.n_events,
          f"{tag}: events {g_stats.n_events} (card) vs {c_stats.n_events}")
    for name, a, b in (("cloudlet states", gpu.cloudlets.state,
                        cpu.cloudlets.state),
                       ("VM states", gpu.vms.state, cpu.vms.state),
                       ("placements", gpu.vms.host, cpu.vms.host),
                       ("migrations", gpu.mig_count, cpu.mig_count)):
        check(torch.equal(a.cpu(), b), f"{tag}: {name} differ")
    err = 0.0
    for a, b in ((gpu.cloudlets.finish_time, cpu.cloudlets.finish_time),
                 (gpu.cloudlets.start_time, cpu.cloudlets.start_time),
                 (gpu.hosts.energy_j, cpu.hosts.energy_j),
                 (gpu.mig_downtime, cpu.mig_downtime),
                 (gpu.net_transferred_mb, cpu.net_transferred_mb)):
        err = max(err, float((a.cpu().double() - b.double()).abs().max()))
    check(err <= 1e-3, f"{tag}: card and CPU differ by {err!r}")
    return err


def phase_migration(device, card, launched, scale=16):
    """Phase 11: ``migration_scenario`` at 16x bench_migration's size on
    the card, leap on and leap off (bitwise equal), against the same
    run on the CPU."""
    import torch
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    tag = "migration-16x" if scale == 16 else f"migration-{scale}x"
    runs = {}
    for leap in (True, False):
        dc = migration_scenario(device, scale)
        torch.cuda.synchronize()
        simstep.launches = 0
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=1 << 20, leap=leap)
        torch.cuda.synchronize()
        runs[leap] = (final, stats, time.perf_counter() - t0)
        if leap:
            launched["migration-16x"] = simstep.launches
    (on, s_on, w_on), (off, s_off, w_off) = runs[True], runs[False]
    check(same_state(on, off), f"{tag}: leap on != leap off")
    check(s_on.n_events == s_off.n_events, f"{tag}: leap changed events")
    t0 = time.perf_counter()
    cpu, s_cpu = run_stats(migration_scenario("cpu", scale),
                           max_steps=1 << 20)
    w_cpu = time.perf_counter() - t0
    err = agree(on, cpu, s_on, s_cpu, tag)
    n_mig = int(on.mig_count)
    check(n_mig >= 1, f"{tag}: no migration")
    n_cl = 4 * 96 * scale
    done = int((on.cloudlets.state == CL_DONE).sum())
    check(done == n_cl, f"{tag}: {done}/{n_cl} done")
    print(f"[{tag}] {256 * scale} hosts x 2 PEs, {96 * scale} VMs, {n_cl} "
          f"cloudlets, 3 host failures, THRESHOLD 0.6: {n_mig} migrations, "
          f"{float(on.mig_downtime)!r} s downtime, {n_cl}/{n_cl} done; leap "
          f"on == leap off bitwise; card == CPU (states, placements, events, "
          f"migrations exact; max float err {err:.3g}); leap on wall "
          f"{w_on!r} s: {run_line(s_on)}; leap off wall {w_off!r} s: "
          f"{run_line(s_off)}; CPU {w_cpu!r} s ({card})")


def s5_networked(n_hosts, n_vms, policy, device):
    """The §5 datacenter on ``bench_network``'s topology
    (``benchmarks/bench_policies.py:341-344``): hosts in 8 clusters by
    ``i % 8``, 1000/500/200 MB/s access/uplink/WAN, 0.001/0.005/0.05 s
    latencies; each cloudlet stages 50 MB in and 20 MB out."""
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    hosts = S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                                 device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    cl = B.build_waves(n_vms, B.WaveSpec(waves=10, length_mi=1_200_000.0,
                                         period=600.0, file_size=50.0,
                                         output_size=20.0), device=device)
    net = S.make_topology(np.arange(n_hosts) % 8, bw_intra=1000.0,
                          lat_intra=0.001, bw_inter=500.0, lat_inter=0.005,
                          bw_wan=200.0, lat_wan=0.05, device=device)
    return S.make_datacenter(hosts, vms, cl, vm_policy=S.SPACE_SHARED,
                             task_policy=policy, reserve_pes=True,
                             rates=S.make_market(0.01, 0.001, 1e-4, 0.002,
                                                 device=device),
                             net=net, device=device)


def check_bytes(final, stats, tag):
    """Every cloudlet DONE, and byte conservation: the MB booked equal
    the file and output sizes of the DONE cloudlets.  Each event adds
    its drained MB (whole sizes, summed exactly: integers below 2^24) to
    an f32 total, which rounds by at most half its spacing each time, so
    the tolerance is events x spacing(total) / 2."""
    import numpy as np
    cl = final.cloudlets
    n_cl = cl.state.shape[0]
    done = int((cl.state == CL_DONE).sum())
    check(done == n_cl, f"{tag}: {done}/{n_cl} done")
    want = float((cl.file_size.double() + cl.output_size.double()).sum())
    got = float(final.net_transferred_mb)
    tol = stats.n_events * float(np.spacing(np.float32(want))) / 2
    check(abs(got - want) <= tol, f"{tag}: {got!r} MB booked, {want!r} "
          f"moved (tolerance {tol!r})")
    return got, want, tol


def phase_s5_networked(device, card, launched, n_hosts=100_000,
                       n_vms=50_000, small=10_000):
    """Phase 12: the paper's largest datacenter staging every cloudlet's
    data over ``bench_network``'s topology, both task policies; then the
    same recipe at ``small`` hosts on the card and on the CPU."""
    import torch
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    tag = "s5-100k-net" if n_hosts == 100_000 else f"s5-{n_hosts}-net"
    simstep.launches = 0
    for policy in (0, 1):
        dc = s5_networked(n_hosts, n_vms, policy, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=1 << 16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want, tol = check_bytes(final, stats, f"{tag}-{policy}")
        print(f"[{tag}-{policy}] {n_hosts} hosts in 8 clusters, {n_vms} "
              f"VMs, {10 * n_vms} cloudlets of 50 MB in and 20 MB out: all "
              f"done, makespan {float(final.time)!r} s, {got!r} MB booked "
              f"against {want!r} (tolerance {tol!r}); wall {wall!r} s, "
              f"{run_line(stats)} ({card})")
    launched["s5-100k-net"] = simstep.launches
    outs = []
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        outs.append(run_stats(s5_networked(small, small // 2, 1, dev),
                              max_steps=1 << 16))
        outs[-1] += (time.perf_counter() - t0,)
    (gpu, gs, gw), (cpu, cs, cw) = outs
    check_bytes(gpu, gs, f"s5-{small}-net")
    err = agree(gpu, cpu, gs, cs, f"s5-{small}-net")
    print(f"[s5-{small}-net] card == CPU, time-shared, {small} hosts, "
          f"{small // 2} VMs: states, placements, {gs.n_events} events "
          f"exact, max float err {err:.3g}; card {gw!r} s, CPU {cw!r} s "
          f"({card})")


def _conformance_hosts(rng, n_hosts, device, pes=(1, 4)):
    """``tests/test_conformance.py``'s random hosts: power models mixing
    linear and SPECpower G4 curves."""
    import numpy as np
    from repro_torch.core import energy
    from repro_torch.core import state as S
    idle = rng.uniform(0.05, 0.2, n_hosts)
    g4 = energy.normalize_watts(energy.SPEC_G4_WATTS, device="cpu")[2]
    lin = energy.linear_curve(device="cpu")
    curves = np.where(rng.integers(0, 2, n_hosts)[:, None] == 1,
                      g4.numpy()[None], lin.numpy()[None])
    return S.make_hosts(rng.integers(*pes, n_hosts),
                        rng.choice([250.0, 500.0, 1000.0], n_hosts),
                        4096.0, 1000.0, 1e6, idle_w=idle,
                        peak_w=idle + rng.uniform(0.2, 0.8, n_hosts),
                        power_curve=curves, device=device)


def dynamic_scenario(seed, vm_policy, task_policy, device, n_hosts=4,
                     n_vms=5, per_vm=3):
    """``tests/test_conformance.py::make_dynamic_scenario`` (its recipe
    and numpy draws, copied): random hosts, VMs and cloudlets, a host
    failure and recovery, a VM destroy, a latent VM created by an event
    (a second failure on every fourth seed), and migration OFF /
    THRESHOLD / DRAIN by seed."""
    import numpy as np
    from repro_torch.core import state as S
    rng = np.random.default_rng(10_000 + seed)
    hosts = _conformance_hosts(rng, n_hosts, device)
    nv = n_vms + 1
    vms = S.make_vms(
        rng.integers(1, 3, nv), rng.choice([250.0, 500.0, 1000.0], nv),
        rng.choice([64.0, 128.0, 256.0], nv), 1.0, 10.0,
        submit_time=np.round(rng.uniform(0, 5, nv), 2).astype(np.float32),
        device=device)
    vms.state[n_vms] = S.VM_EMPTY
    owners = np.repeat(np.arange(nv, dtype=np.int32), per_vm)
    submit = np.sort(np.round(rng.uniform(0, 20, (nv, per_vm)), 2),
                     axis=1).reshape(-1).astype(np.float32)
    lengths = np.round(rng.uniform(500, 8000, nv * per_vm)).astype(
        np.float32)
    cl = S.make_cloudlets(owners, lengths, submit, device=device)
    fail_t = round(float(rng.uniform(5, 25)), 2)
    recover_t = round(fail_t + float(rng.uniform(5, 15)), 2)
    fail_host = int(rng.integers(0, n_hosts))
    destroy_t = round(float(rng.uniform(15, 35)), 2)
    destroy_vm = int(rng.integers(0, n_vms))
    create_t = round(float(rng.uniform(1, 10)), 2)
    times = [fail_t, recover_t, destroy_t, create_t]
    kinds = [S.EV_HOST_FAIL, S.EV_HOST_RECOVER, S.EV_VM_DESTROY,
             S.EV_VM_CREATE]
    targets = [fail_host, fail_host, destroy_vm, n_vms]
    if seed % 4 == 0:
        times.append(round(float(rng.uniform(10, 30)), 2))
        kinds.append(S.EV_HOST_FAIL)
        targets.append(int(rng.integers(0, n_hosts)))
    mig_policy = (S.MIG_OFF, S.MIG_THRESHOLD, S.MIG_DRAIN)[seed % 3]
    return S.make_datacenter(
        hosts, vms, cl, vm_policy=vm_policy, task_policy=task_policy,
        reserve_pes=bool(seed % 2),
        events=S.make_events(times, kinds, targets, device=device),
        mig_policy=mig_policy,
        mig_threshold=0.7 if mig_policy == S.MIG_THRESHOLD else 0.45,
        mig_energy_per_mb=0.001, device=device)


def networked_scenario(seed, vm_policy, task_policy, device, n_hosts=4,
                       n_vms=4, per_vm=3):
    """``tests/test_conformance.py::make_networked_scenario`` (its recipe
    and numpy draws, copied): a random two-tier topology over 1-3
    clusters, staged transfers with some of zero size, and on odd seeds
    a host failure and recovery with THRESHOLD or DRAIN migration."""
    import numpy as np
    from repro_torch.core import state as S
    rng = np.random.default_rng(20_000 + seed)
    hosts = _conformance_hosts(rng, n_hosts, device)
    net = S.make_topology(
        rng.integers(0, int(rng.integers(1, 4)), n_hosts),
        bw_intra=float(rng.choice([50.0, 100.0, 200.0])),
        bw_inter=float(rng.choice([20.0, 50.0, 100.0])),
        bw_wan=float(rng.choice([10.0, 25.0, 50.0])),
        lat_intra=round(float(rng.uniform(0.0, 0.1)), 2),
        lat_inter=round(float(rng.uniform(0.0, 0.2)), 2),
        lat_wan=round(float(rng.uniform(0.0, 0.5)), 2),
        energy_per_mb=0.001, device=device)
    vms = S.make_vms(
        rng.integers(1, 3, n_vms), rng.choice([250.0, 500.0, 1000.0], n_vms),
        rng.choice([64.0, 128.0], n_vms), 1.0, 10.0,
        submit_time=np.round(rng.uniform(0, 5, n_vms), 2).astype(np.float32),
        device=device)
    owners = np.repeat(np.arange(n_vms, dtype=np.int32), per_vm)
    submit = np.sort(np.round(rng.uniform(0, 20, (n_vms, per_vm)), 2),
                     axis=1).reshape(-1).astype(np.float32)
    lengths = np.round(rng.uniform(500, 8000, n_vms * per_vm)).astype(
        np.float32)
    nc = n_vms * per_vm
    file_mb = np.round(rng.uniform(0, 40, nc), 1).astype(np.float32)
    out_mb = np.round(rng.uniform(0, 20, nc), 1).astype(np.float32)
    file_mb[rng.uniform(size=nc) < 0.2] = 0.0
    out_mb[rng.uniform(size=nc) < 0.2] = 0.0
    cl = S.make_cloudlets(owners, lengths, submit, file_size=file_mb,
                          output_size=out_mb, device=device)
    kw = {}
    if seed % 2 == 1:
        fail_t = round(float(rng.uniform(5, 20)), 2)
        kw["events"] = S.make_events(
            [fail_t, round(fail_t + float(rng.uniform(5, 15)), 2)],
            [S.EV_HOST_FAIL, S.EV_HOST_RECOVER],
            [int(rng.integers(0, n_hosts))] * 2, device=device)
        kw["mig_policy"] = (S.MIG_THRESHOLD, S.MIG_DRAIN)[seed % 4 == 1]
        kw["mig_threshold"] = (0.7 if kw["mig_policy"] == S.MIG_THRESHOLD
                               else 0.45)
        kw["mig_energy_per_mb"] = 0.001
    return S.make_datacenter(hosts, vms, cl, vm_policy=vm_policy,
                             task_policy=task_policy,
                             reserve_pes=bool(seed % 2), net=net,
                             device=device, **kw)


def dyn_lane_scenarios(n_seeds, device):
    """``n_seeds`` small scenarios: dynamic on even seeds, networked on
    odd ones (half of those also dynamic)."""
    return [dynamic_scenario(s, 0, 0, device) if s % 2 == 0
            else networked_scenario(s, 0, 0, device) for s in range(n_seeds)]


def phase_dyn_lanes(device, card, launched, n_seeds=8):
    """Phase 13: ``n_seeds`` x the 2x2 grid of small dynamic and
    networked scenarios in one fused batch on the card: every lane
    equals its single run on the card bitwise, and the card agrees with
    the same batch on the CPU."""
    import dataclasses
    import torch
    from repro_torch.core import sweep
    from repro_torch.core.engine import batched_run_stats, run_stats
    from repro_torch.kernels.simstep import simstep

    vm_p, task_p = sweep.policy_grid(device="cpu")
    fused = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        batch = sweep.fuse_grid(sweep.stack_scenarios(
            dyn_lane_scenarios(n_seeds, dev)), vm_p.to(dev), task_p.to(dev))
        torch.cuda.synchronize()
        simstep.launches = 0
        t0 = time.perf_counter()
        out = batched_run_stats(batch, max_steps=4096)
        torch.cuda.synchronize()
        if where == "card":
            launched["dyn-lanes"] = simstep.launches
        fused[where] = (batch, *out, time.perf_counter() - t0)
    (batch, grid, gstats, wall), (_, cgrid, cstats, cwall) = (
        fused["card"], fused["cpu"])
    err = agree(grid, cgrid, gstats, cstats, "dyn-lanes")
    singles, lanes = 0.0, 4 * n_seeds
    for i in range(lanes):
        cell = lane(batch, i)
        t0 = time.perf_counter()
        single, _ = run_stats(cell, max_steps=4096)
        torch.cuda.synchronize()
        singles += time.perf_counter() - t0
        check(same_state(lane(grid, i), single),
              f"dyn-lanes: lane {i} != its single run")
    n_mig = int(grid.mig_count.sum())
    mb = float(grid.net_transferred_mb.sum())
    check(n_mig > 0 and mb > 0.0, "dyn-lanes: no migration or no transfer")
    print(f"[dyn-lanes] {lanes} lanes ({n_seeds} small dynamic and "
          f"networked scenarios x the 2x2 grid) in one batch: every lane == "
          f"its single run bitwise; card == CPU (states, placements, "
          f"{gstats.n_events} events, migrations exact; max float err "
          f"{err:.3g}); {n_mig} migrations, {mb!r} MB staged; batched wall "
          f"{wall!r} s ({launched['dyn-lanes']} simstep launches, "
          f"{run_line(gstats)}), the {lanes} single runs {singles!r} s, CPU "
          f"batch {cwall!r} s ({card})")


# ---------------------------------------------------------------------------
# Streamed arrivals (phase 14)
# ---------------------------------------------------------------------------
def stream_line(stats):
    """What a streamed run did, for the phase lines."""
    return (f"{run_line(stats)}, {stats.n_passes} admission passes")


def as_stream(dc, window, chunk):
    """A resident scenario's cloudlets as a stream into a window of
    ``window`` slots: (windowed state, stream, arrival order), where
    arrival ``sid`` is resident cloudlet ``order[sid]``."""
    import dataclasses
    import numpy as np
    from repro_torch.core import state as S
    cl = dc.cloudlets
    dev = dc.time.device
    submit = cl.submit_time.cpu().numpy()
    order = np.lexsort((np.arange(submit.shape[0]), submit))
    stream = S.make_stream(cl.vm, cl.length, cl.submit_time,
                           file_size=cl.file_size,
                           output_size=cl.output_size, chunk=chunk,
                           device=dev)
    win = dataclasses.replace(dc, cloudlets=S.make_window(window,
                                                          device=dev))
    return win, stream, order


def timed_stream(dc, stream, **kw):
    """``run_stream_stats`` with its wall time and simstep launches."""
    import torch
    from repro_torch.core.engine import run_stream_stats
    from repro_torch.kernels.simstep import simstep
    torch.cuda.synchronize()
    before = simstep.launches
    t0 = time.perf_counter()
    out = run_stream_stats(dc, stream, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = simstep.launches - before
    check(launched == out[3].n_steps > 0 or dc.time.device.type == "cpu",
          f"simstep launches {launched}, steps {out[3].n_steps}")
    return (*out, wall, launched)


def same_stream(a, b):
    """Two streamed runs' (state, StreamState, records) equal bitwise."""
    import torch
    return (same_state(a[0], b[0]) and same_state(a[1], b[1])
            and all(bool(torch.equal(x, y)) for x, y in zip(a[2], b[2])))


def same_chunking(a, b):
    """Two streamed runs of one trace in different chunk sizes: the state,
    the stats and the admission counters equal bitwise (the cursor, the
    backlog and the records follow the chunks)."""
    import torch
    return (same_state(a[0], b[0]) and same_state(a[1].stats, b[1].stats)
            and all(bool(torch.equal(getattr(a[1], f), getattr(b[1], f)))
                    for f in ("next_sid", "vm_rank", "slot_sid",
                              "peak_occupancy")))


def stream_agree(gpu, cpu, tag):
    """A streamed run on the card against the CPU: counts, reservoir ids,
    the window's states, VMs and ranks, peak occupancy, backlog and the
    records' integer fields exact; sums, times and joules within the
    oracle's tolerances.  Returns the largest float error."""
    import torch
    (g, gs, gr), (c, cs, cr) = gpu[:3], cpu[:3]
    for name in ("n_retired", "n_failed", "per_vm_done", "res_sid"):
        check(torch.equal(getattr(gs.stats, name).cpu(),
                          getattr(cs.stats, name)), f"{tag}: {name} differ")
    for name in ("peak_occupancy", "max_backlog", "slot_sid", "vm_rank"):
        check(torch.equal(getattr(gs, name).cpu(), getattr(cs, name)),
              f"{tag}: {name} differ")
    for name in ("state", "vm", "rank_in_vm"):
        check(torch.equal(getattr(g.cloudlets, name).cpu(),
                          getattr(c.cloudlets, name)),
              f"{tag}: cloudlets.{name} differ")
    for x, y in zip(gr[1:], cr[1:]):
        check(torch.equal(x.cpu(), y), f"{tag}: chunk records differ")
    err = 0.0
    for a, b, rel in ((gs.stats.sum_exec, cs.stats.sum_exec, True),
                      (gs.stats.sum_response, cs.stats.sum_response, True),
                      (gs.stats.makespan, cs.stats.makespan, False),
                      (g.time, c.time, False),
                      (g.hosts.energy_j, c.hosts.energy_j, True)):
        d = (a.cpu().double() - b.double()).abs()
        if rel:
            d = d / torch.clamp(b.double().abs(), min=1.0)
        err = max(err, float(d.max()))
    fin = cs.stats.res_finish < 1e29
    for a, b in ((gs.stats.res_start, cs.stats.res_start),
                 (gs.stats.res_finish, cs.stats.res_finish)):
        err = max(err, float((a.cpu()[fin].double()
                              - b[fin].double()).abs().max()))
    check(err <= 1e-3, f"{tag}: card and CPU differ by {err!r}")
    return err


def phase_stream_s5(device, card, launched, n_hosts=100_000,
                    n_vms=50_000, chunk=65_536):
    """Phase 14a: the paper's largest datacenter as a stream, with a
    reservoir of every arrival (stride 1), so each cloudlet's start and
    finish is read back.  Space-shared through a window of two waves
    (100,000 slots): the backlog holds up to four waves, yet each VM
    always has its next cloudlet in the window, so the resident closed
    forms hold: every cloudlet retired, exec exactly 1200 s, per-wave
    response 1200 + 600 w s, makespan 12,000 s, busy and idle host
    joules.  Time-shared through a window of all 500,000 slots (retired
    slots still recycle).  In both, every arrival's start and finish,
    the joules and the clock equal the resident run's bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats

    n_cl = 10 * n_vms
    for policy, window in ((S.SPACE_SHARED, 2 * n_vms),
                           (S.TIME_SHARED, n_cl)):
        tag = f"stream-s5-100k-{policy}"
        resident = section5(n_hosts, n_vms, policy, device)
        ref, _ = run_stats(resident, max_steps=8192)
        win, stream, order = as_stream(resident, window, chunk)
        torch.cuda.reset_peak_memory_stats()
        final, st, recs, stats, wall, n_launch = timed_stream(
            win, stream, reservoir=n_cl)
        launched[tag] = n_launch
        peak = torch.cuda.max_memory_allocated()
        sts = st.stats
        check(int(sts.n_retired) == n_cl and int(sts.n_failed) == 0,
              f"{tag}: {int(sts.n_retired)}/{n_cl} retired")
        check(float(sts.makespan) == 12000.0 == float(final.time),
              f"{tag}: makespan {float(sts.makespan)!r}")
        check(int(st.peak_occupancy) <= window, f"{tag}: occupancy")
        check(torch.equal(sts.res_sid.cpu(), torch.arange(
            n_cl, dtype=torch.int32)), f"{tag}: reservoir ids")
        slot = torch.from_numpy(order).to(device)
        check(torch.equal(sts.res_start, ref.cloudlets.start_time[slot])
              and torch.equal(sts.res_finish,
                              ref.cloudlets.finish_time[slot]),
              f"{tag}: start and finish times differ from the resident "
              f"run")
        check(torch.equal(final.hosts.energy_j, ref.hosts.energy_j)
              and torch.equal(final.time, ref.time),
              f"{tag}: joules or clock differ from the resident run")
        sub = resident.cloudlets.submit_time.cpu().double().numpy()[order]
        fin = sts.res_finish.cpu().double().numpy()
        wave = np.rint(sub / 600.0).astype(int)
        resp = [float((fin - sub)[wave == w].mean()) for w in range(10)]
        want = SPACE_RESP if policy == S.SPACE_SHARED else TIME_RESP
        r_err = max(abs(a - b) for a, b in zip(resp, want))
        check(r_err <= 1e-3, f"{tag}: response by wave {resp}")
        energy = final.hosts.energy_j.double().cpu().numpy()
        busy = np.zeros(n_hosts, bool)
        busy[final.vms.host.cpu().numpy()] = True
        e_busy = np.abs(energy[busy] / 2.4e6 - 1.0).max()
        e_idle = (np.abs(energy[~busy] / 1.2e6 - 1.0).max() if (~busy).any()
              else 0.0)                 # a park with every host busy
        check(e_busy <= 1e-5 and e_idle <= 1e-5,
              f"{tag}: energy off by {e_busy!r} / {e_idle!r}")
        what = ""
        if policy == S.SPACE_SHARED:
            check(float(sts.sum_exec) == 1200.0 * n_cl and bool(
                (sts.res_finish - sts.res_start == 1200.0).all()),
                f"{tag}: exec != 1200 s")
            check(int(st.max_backlog) > 0, f"{tag}: no backlog")
            what = "exec exactly 1200 s, "
        print(f"[{tag}] {n_hosts} hosts, {n_vms} VMs, {n_cl} arrivals in "
              f"chunks of {chunk} through a window of {window}: "
              f"{n_cl}/{n_cl} retired, max backlog {int(st.max_backlog)}, "
              f"peak occupancy {int(st.peak_occupancy)}; every start and "
              f"finish, the joules and the clock == the resident run "
              f"bitwise; {what}response by wave within {r_err:.3g} s of "
              f"the JAX answers, makespan 12000 s, energy rel err busy "
              f"{e_busy:.3g} idle {e_idle:.3g}; wall {wall!r} s, "
              f"{stream_line(stats)}, simstep launches {n_launch}, peak "
              f"allocated {peak} bytes ({card})")


def phase_stream_tight(device, card, launched, n_hosts=10_000, n_vms=5_000,
                       window=5_000):
    """Phase 14b: 10,000 hosts, 5,000 VMs, 50,000 wave cloudlets through a
    window of 5,000, both task policies: the card against the CPU, and
    chunk 1,024 against chunk 8,192 on the card, bitwise."""
    import torch
    from repro_torch.core import state as S

    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        tag = f"stream-tight-{policy}"
        runs = {}
        for where, dev, chunk in (("card", device, 1024),
                                  ("card-8192", device, 8192),
                                  ("cpu", "cpu", 1024)):
            win, stream, _ = as_stream(section5(n_hosts, n_vms, policy, dev),
                                       window, chunk)
            runs[where] = timed_stream(win, stream, reservoir=256)
        launched[tag] = runs["card"][5]
        check(same_chunking(runs["card"], runs["card-8192"]),
              f"{tag}: chunk 1024 != chunk 8192")
        err = stream_agree(runs["card"], runs["cpu"], tag)
        st = runs["card"][1]
        check(int(st.stats.n_retired) == 10 * n_vms,
              f"{tag}: {int(st.stats.n_retired)} retired")
        print(f"[{tag}] {n_hosts} hosts, {n_vms} VMs, {10 * n_vms} wave "
              f"arrivals through a window of {window}: all retired, max "
              f"backlog {int(st.max_backlog)}; chunk 1024 == chunk 8192 "
              f"bitwise on the card; card == CPU (counts, states, reservoir "
              f"ids, records exact; max float err {err:.3g}); card "
              f"{runs['card'][4]!r} s ({stream_line(runs['card'][3])}), "
              f"chunk 8192 {runs['card-8192'][4]!r} s, CPU "
              f"{runs['cpu'][4]!r} s ({card})")


def poisson_stream(n, device, n_vms=32, n_hosts=8, window=64, chunk=4096):
    """``benchmarks/bench_policies.py::_streaming_scenario`` (its recipe,
    copied): n arrivals over n/40 s to 32 VMs of 500 MIPS on 8 hosts of
    4 PEs, lengths 100-2000 MI, through a window of 64."""
    import numpy as np
    from repro_torch.core import state as S
    rng = np.random.default_rng(0)
    vm = rng.integers(0, n_vms, n).astype(np.int32)
    sub = np.sort(rng.uniform(0, n / 40.0, n)).astype(np.float32)
    length = rng.uniform(100.0, 2000.0, n).astype(np.float32)
    hosts = S.make_uniform_hosts(n_hosts, pes=4, mips=1000.0, ram=8192.0,
                                 bw=1000.0, storage=1e6, idle_w=100.0,
                                 peak_w=250.0, device=device)
    vms = S.make_vms([1] * n_vms, [500.0] * n_vms, [512.0] * n_vms,
                     [100.0] * n_vms, [1000.0] * n_vms, device=device)
    dc = S.make_datacenter(hosts, vms, S.make_window(window, device=device),
                           device=device)
    return dc, S.make_stream(vm, length, sub, chunk=chunk, device=device)


def phase_stream_poisson(device, card, launched, n=2000):
    """Phase 14c: ``bench_streaming``'s lane at n arrivals: leap on ==
    leap off bitwise on the card, the card against the CPU, and
    cloudlets per second for each."""
    runs = {}
    for where, dev, leap in (("card", device, True),
                             ("card-leap-off", device, False),
                             ("cpu", "cpu", True)):
        dc, stream = poisson_stream(n, dev)
        runs[where] = timed_stream(dc, stream, leap=leap,
                                   max_steps_per_chunk=4 * 4096)
    launched["stream-poisson"] = runs["card"][5]
    check(same_stream(runs["card"], runs["card-leap-off"]),
          "stream-poisson: leap on != leap off")
    err = stream_agree(runs["card"], runs["cpu"], "stream-poisson")
    st = runs["card"][1]
    check(int(st.stats.n_retired) == n, "stream-poisson: not all retired")
    rate = lambda r: n / r[4]
    print(f"[stream-poisson] {n} arrivals, 32 VMs on 8 hosts, a window of "
          f"64: all retired, max backlog {int(st.max_backlog)}; leap on == "
          f"leap off bitwise; card == CPU (max float err {err:.3g}); card "
          f"leap on {runs['card'][4]!r} s ({rate(runs['card'])!r} "
          f"cloudlets/s; {stream_line(runs['card'][3])}), leap off "
          f"{runs['card-leap-off'][4]!r} s "
          f"({rate(runs['card-leap-off'])!r} cloudlets/s), CPU "
          f"{runs['cpu'][4]!r} s ({rate(runs['cpu'])!r} cloudlets/s) "
          f"({card})")


def streamed_scenario(seed, device, n_hosts=3, n_vms=5):
    """``tests/test_conformance.py::make_streamed_scenario`` (its recipe
    and numpy draws, copied), policies (0, 0): a window of 4-12 slots
    under 40-80 arrivals; odd seeds add a host failure and recovery, a
    VM destroy, migration and a staged-transfer topology."""
    import numpy as np
    from repro_torch.core import state as S
    rng = np.random.default_rng(30_000 + seed)
    hosts = _conformance_hosts(rng, n_hosts, device, pes=(2, 5))
    vms = S.make_vms(
        rng.integers(1, 3, n_vms), rng.choice([250.0, 500.0, 1000.0], n_vms),
        64.0, 1.0, 10.0,
        submit_time=np.round(rng.uniform(0, 3, n_vms), 2).astype(np.float32),
        device=device)
    n_slots = int(rng.integers(4, 13))
    n = int(rng.integers(40, 81))
    vm_ids = rng.integers(0, n_vms, n).astype(np.int32)
    submit = np.sort(np.round(rng.uniform(0, 30, n), 2)).astype(np.float32)
    lengths = np.round(rng.uniform(300, 4000, n)).astype(np.float32)
    kw = {}
    file_mb = out_mb = 0.0
    if seed % 2 == 1:
        fail_t = round(float(rng.uniform(5, 15)), 2)
        destroy_t = round(float(rng.uniform(18, 28)), 2)
        kw["events"] = S.make_events(
            [fail_t, round(fail_t + float(rng.uniform(4, 10)), 2),
             destroy_t],
            [S.EV_HOST_FAIL, S.EV_HOST_RECOVER, S.EV_VM_DESTROY],
            [int(rng.integers(0, n_hosts))] * 2
            + [int(rng.integers(0, n_vms))], device=device)
        kw["mig_policy"] = (S.MIG_THRESHOLD, S.MIG_DRAIN)[seed % 4 == 1]
        kw["mig_threshold"] = (0.7 if kw["mig_policy"] == S.MIG_THRESHOLD
                               else 0.45)
        kw["mig_energy_per_mb"] = 0.001
        kw["net"] = S.make_topology(
            rng.integers(0, 2, n_hosts),
            bw_intra=float(rng.choice([50.0, 100.0])),
            bw_inter=float(rng.choice([20.0, 50.0])),
            bw_wan=float(rng.choice([10.0, 25.0])),
            lat_intra=round(float(rng.uniform(0.0, 0.1)), 2),
            lat_inter=round(float(rng.uniform(0.0, 0.2)), 2),
            lat_wan=round(float(rng.uniform(0.0, 0.4)), 2),
            energy_per_mb=0.001, device=device)
        file_mb = np.round(rng.uniform(0, 20, n), 1).astype(np.float32)
        out_mb = np.round(rng.uniform(0, 10, n), 1).astype(np.float32)
        file_mb[rng.uniform(size=n) < 0.2] = 0.0
        out_mb[rng.uniform(size=n) < 0.2] = 0.0
    dc = S.make_datacenter(hosts, vms, S.make_window(n_slots, device=device),
                           reserve_pes=bool(seed % 2), device=device, **kw)
    stream = S.make_stream(vm_ids, lengths, submit, file_size=file_mb,
                           output_size=out_mb, chunk=16, device=device)
    return dc, stream


def phase_stream_lanes(device, card, launched, n_seeds=4):
    """Phase 14d: ``n_seeds`` small streamed scenarios x the 2x2 grid in
    one ``run_stream_grid`` on the card: every lane equals its single
    run bit for bit."""
    import dataclasses
    import torch
    from repro_torch.core import sweep
    from repro_torch.core.engine import run_stream_stats
    from repro_torch.kernels.simstep import simstep

    pairs = [streamed_scenario(s, device) for s in range(n_seeds)]
    dcs = [p[0] for p in pairs]
    streams = [p[1] for p in pairs]
    batch = sweep.stack_scenarios(dcs)
    vm_p, task_p = sweep.policy_grid(device=device)
    torch.cuda.synchronize()
    simstep.launches = 0
    t0 = time.perf_counter()
    gdc, gst, grec = sweep.run_stream_grid(batch, streams, vm_p, task_p,
                                           reservoir=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched["stream-lanes"] = simstep.launches
    singles, events, failed = 0.0, 0, 0
    for p in range(4):
        for b in range(n_seeds):
            cell = dataclasses.replace(lane(batch, b),
                                       vm_policy=vm_p[p].clone(),
                                       task_policy=task_p[p].clone())
            t0 = time.perf_counter()
            out, st, rec, stats = run_stream_stats(cell, streams[b],
                                                   reservoir=32)
            torch.cuda.synchronize()
            singles += time.perf_counter() - t0
            events += stats.n_events
            failed += int(st.stats.n_failed)
            k = rec.time.shape[0]
            check(same_state(lane(gdc, p, b), out)
                  and same_state(lane(gst.stats, p, b), st.stats)
                  and all(bool(torch.equal(x[p, b, :k], y))
                          for x, y in zip(grec, rec)),
                  f"stream-lanes: lane {p},{b} != its single run")
    print(f"[stream-lanes] {4 * n_seeds} lanes ({n_seeds} small streamed "
          f"scenarios x the 2x2 grid) in one run_stream_grid: every lane == "
          f"its single run bitwise; {events} events, {failed} dead-VM or "
          f"failed arrivals; batched wall {wall!r} s "
          f"({launched['stream-lanes']} simstep launches), the "
          f"{4 * n_seeds} single runs {singles!r} s ({card})")


# ---------------------------------------------------------------------------
# Phases 15-18: closed-loop elasticity and the in-run metrics plane
# ---------------------------------------------------------------------------
# s5-100k-elastic's spot track ($ per alive VM-second from each start)
ELASTIC_SPOT = ([0.0, 3000.0, 6000.0, 9000.0], [0.02, 0.06, 0.03, 0.01])


def elastic_knobs(n_vms):
    """The autoscaler of ``s5-100k-elastic`` for ``n_vms`` slots (50,000
    at full width): the fleet between half and all of the slots, a
    quarter of them an action.  Busy over alive steps through 1, 3/4,
    2/3 and 1/2, so the watermarks sit off those quotients."""
    return dict(util_high=0.9, util_low=0.7, cooldown=300.0,
                min_fleet=n_vms // 2, max_fleet=n_vms,
                scale_step=n_vms // 4)


def s5_elastic(n_hosts, n_vms, policy, device):
    """The §5 datacenter with a latent half: slots 0..V/2-1 start
    VM_PENDING with §5's ten waves of 1.2M MI, slots V/2..V-1 start
    VM_EMPTY with ten waves of 0.6M MI (they drain first); the
    autoscaler of ``elastic_knobs`` and the spot track ``ELASTIC_SPOT``."""
    import dataclasses
    import numpy as np
    from repro_torch.core import broker as B
    from repro_torch.core import state as S
    half = n_vms // 2
    hosts = S.make_uniform_hosts(n_hosts, idle_w=100.0, peak_w=200.0,
                                 device=device)
    vms = B.build_fleet([B.VmSpec(count=n_vms, pes=1, mips=1000.0,
                                  ram=512.0, bw=10.0, size=1000.0)],
                        device=device)
    st = np.full(n_vms, S.VM_EMPTY, np.int32)
    st[:half] = S.VM_PENDING
    vms = dataclasses.replace(vms, state=torch_tensor(st, device))
    vm = np.repeat(np.arange(n_vms, dtype=np.int32), 10)
    submit = np.tile(np.arange(10, dtype=np.float32) * 600.0, n_vms)
    length = np.where(vm < half, 1_200_000.0, 600_000.0).astype(np.float32)
    scaler = S.make_autoscaler(**elastic_knobs(n_vms),
                               spot_t=ELASTIC_SPOT[0],
                               spot_price=ELASTIC_SPOT[1], device=device)
    return S.make_datacenter(hosts, vms,
                             S.make_cloudlets(vm, length, submit,
                                              device=device),
                             vm_policy=S.SPACE_SHARED, task_policy=policy,
                             reserve_pes=True, scaler=scaler, device=device)


def torch_tensor(a, device):
    import torch
    return torch.from_numpy(a).to(device)


def check_elastic_trace(dc, final, trace, tag):
    """The control contracts on a ``run_trace`` of an elastic lane: the
    fleet inside [min, max] on every record, actions (fleet changes)
    at least ``cooldown`` apart, both directions at least twice, and the
    spot spend equal to the f64 integral of price x fleet over the
    trace's intervals within 1e-4 relative.  Returns (ups, downs, spot
    spend, action times)."""
    import numpy as np
    from repro_torch.core import telemetry as T
    sc = dc.scaler
    t, fleet = T.fleet_timeline(trace)
    lo, hi = int(sc.min_fleet), int(sc.max_fleet)
    check(fleet.size > 0 and fleet.min() >= lo and fleet.max() <= hi,
          f"{tag}: fleet {fleet.min()}-{fleet.max()} outside [{lo}, {hi}]")
    fleet0 = int(((dc.vms.state == 1) | (dc.vms.state == 2)).sum())
    prev = np.concatenate([[fleet0], fleet[:-1]])
    acts = t[fleet != prev].astype(np.float64)
    gaps = np.diff(acts)
    check(gaps.size == 0 or gaps.min() >= float(sc.cooldown) - 1e-3,
          f"{tag}: actions at {acts.tolist()} closer than the cooldown")
    ups, downs = int(final.scaler.up_count), int(final.scaler.down_count)
    check(ups >= 2 * int(sc.scale_step) and downs >= 2 * int(sc.scale_step),
          f"{tag}: {ups} VMs up, {downs} down (want two actions each)")
    starts = np.concatenate([[0.0], t[:-1].astype(np.float64)])
    spot_t = sc.spot_t.double().cpu().numpy()
    spot_p = sc.spot_price.double().cpu().numpy()
    seg = np.clip(np.searchsorted(spot_t, starts, side="right") - 1, 0,
                  spot_t.size - 1)
    want = float(np.sum(spot_p[seg] * fleet.astype(np.float64)
                        * (t.astype(np.float64) - starts)))
    got = float(final.scaler.spot_cost)
    check(abs(got - want) <= 1e-4 * abs(want) and want > 0.0,
          f"{tag}: spot spend {got!r} against the integral {want!r}")
    done = int((final.cloudlets.state == CL_DONE).sum())
    check(done == final.cloudlets.state.shape[0],
          f"{tag}: {done}/{final.cloudlets.state.shape[0]} done")
    return ups, downs, got, acts


def elastic_agree(gpu, cpu, g_stats, c_stats, tag):
    """An elastic run on the card against the CPU: states, placements,
    event and scale counts exact; times, joules and spot spend within
    1e-5 relative.  Returns the largest relative error."""
    import torch
    check(g_stats.n_events == c_stats.n_events,
          f"{tag}: events {g_stats.n_events} (card) vs {c_stats.n_events}")
    for name, a, b in (("cloudlet states", gpu.cloudlets.state,
                        cpu.cloudlets.state),
                       ("VM states", gpu.vms.state, cpu.vms.state),
                       ("placements", gpu.vms.host, cpu.vms.host),
                       ("ups", gpu.scaler.up_count, cpu.scaler.up_count),
                       ("downs", gpu.scaler.down_count,
                        cpu.scaler.down_count)):
        check(torch.equal(a.cpu(), b), f"{tag}: {name} differ")
    err = 0.0
    for a, b in ((gpu.cloudlets.finish_time, cpu.cloudlets.finish_time),
                 (gpu.cloudlets.start_time, cpu.cloudlets.start_time),
                 (gpu.hosts.energy_j, cpu.hosts.energy_j),
                 (gpu.scaler.spot_cost, cpu.scaler.spot_cost)):
        d = (a.cpu().double() - b.double()).abs() / torch.clamp(
            b.double().abs(), min=1.0)
        err = max(err, float(d.max()))
    check(err <= 1e-5, f"{tag}: card and CPU differ by {err!r} (relative)")
    return err


def phase_s5_elastic(device, card, launched, n_hosts=100_000,
                     n_vms=50_000, n_trace=64):
    """Phase 15: ``s5-100k-elastic``, both task policies: the run to
    quiescence on the card (simstep's count read around it) and on the
    CPU, equal; then a ``run_trace`` on the card, held to the control
    contracts and the spot integral."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats, run_trace
    from repro_torch.kernels.simstep import simstep

    n_launch = 0
    for policy in (S.SPACE_SHARED, S.TIME_SHARED):
        tag = f"s5-100k-elastic-{policy}"
        dc = s5_elastic(n_hosts, n_vms, policy, device)
        torch.cuda.synchronize()
        before = simstep.launches
        t0 = time.perf_counter()
        final, stats = run_stats(dc, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch += simstep.launches - before
        t0 = time.perf_counter()
        cpu, c_stats = run_stats(s5_elastic(n_hosts, n_vms, policy, "cpu"),
                                 max_steps=8192)
        cpu_wall = time.perf_counter() - t0
        err = elastic_agree(final, cpu, stats, c_stats, tag)
        t0 = time.perf_counter()
        out, trace = run_trace(dc, num_steps=n_trace)
        torch.cuda.synchronize()
        trace_wall = time.perf_counter() - t0
        check(not bool(trace.active[-1]), f"{tag}: the trace did not end")
        check(same_state(out.cloudlets, final.cloudlets)
              and torch.equal(out.scaler.spot_cost, final.scaler.spot_cost),
              f"{tag}: run_trace != run")
        ups, downs, spot, acts = check_elastic_trace(dc, out, trace, tag)
        print(f"[{tag}] {n_hosts} hosts, {n_vms} slots (half latent), "
              f"{dc.cloudlets.vm.shape[0]} cloudlets: all done, "
              f"{ups} VMs up and {downs} down at t = {acts.tolist()}, "
              f"fleet in bounds, actions >= cooldown apart, spot "
              f"${spot:.2f} == the trace's integral; card == CPU (max rel "
              f"err {err:.3g}); card {wall!r} s ({run_line(stats)}, "
              f"{stats.n_scale} autoscaler boundaries), CPU {cpu_wall!r} "
              f"s, run_trace {trace_wall!r} s ({card})")
    launched["s5-100k-elastic"] = n_launch


def phase_s5_probed(device, card, launched, n_hosts=100_000,
                    n_vms=50_000):
    """Phase 16: ``s5-100k-probed``: §5 time-shared with a plane of 32
    buckets and 24 bins over the 12,000 s makespan, SLA factor 2.  Probes
    on against off (every other leaf bitwise), leap on against off (the
    plane too), the histogram's count, the buckets' span, per-host busy
    seconds against the closed form, and the SLA counters against the
    final responses in f64; then the wall a step, probes on and off."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import metrics as M
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    base = section5(n_hosts, n_vms, S.TIME_SHARED, device)
    dc = dataclasses.replace(base, metrics=M.make_metrics(
        n_hosts, horizon=12000.0, buckets=32, bins=24, sla_factor=2.0,
        device=device))
    runs = {}
    simstep.launches = 0
    for name, d, leap in (("probed", dc, True), ("probed-leap-off", dc,
                                                  False),
                          ("off", base, True)):
        if name == "off":
            launched["s5-100k-probed"] = simstep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = run_stats(d, max_steps=8192, leap=leap)
        torch.cuda.synchronize()
        runs[name] = (out, stats, time.perf_counter() - t0)
    on, off = runs["probed"][0], runs["off"][0]
    check(same_state(dataclasses.replace(on, metrics=base.metrics), off),
          "s5-100k-probed: the probes changed the run")
    check(same_state(on, runs["probed-leap-off"][0]),
          "s5-100k-probed: leap on != leap off with probes")
    m = on.metrics
    n_cl = on.cloudlets.state.shape[0]
    check(int(m.hist_response.sum()) == n_cl == int(m.hist_exec.sum()),
          f"s5-100k-probed: {int(m.hist_response.sum())} retirements")
    span = float(m.bucket_dt.double().sum())
    check(abs(span - 12000.0) <= 1e-3, f"s5-100k-probed: buckets span "
          f"{span!r} s")
    busy = np.zeros(n_hosts, bool)
    busy[on.vms.host.cpu().numpy()] = True
    want = np.where(busy, 12000.0, 0.0)
    b_err = float(np.abs(m.host_busy_s.double().cpu().numpy() - want).max())
    check(b_err <= 1e-3, f"s5-100k-probed: busy seconds off by {b_err!r}")
    cl = on.cloudlets
    f64 = lambda t: t.double().cpu().numpy()
    resp = f64(cl.finish_time) - f64(cl.submit_time)
    bound = 2.0 * f64(cl.length) / 1000.0
    breach = resp > bound
    first = f64(cl.finish_time)[breach].min()
    check(int(m.sla_breaches) == int(breach.sum())
          and float(m.first_breach_t) == first,
          f"s5-100k-probed: {int(m.sla_breaches)} breaches from "
          f"{float(m.first_breach_t)!r}, the responses give "
          f"{int(breach.sum())} from {first!r}")
    per = {k: v[2] / v[1].n_steps * 1e3 for k, v in runs.items()}
    print(f"[s5-100k-probed] §5 {n_hosts} hosts time-shared, 32 buckets, "
          f"24 bins: probes on == off on every other leaf, leap on == off "
          f"with the plane, {n_cl} retirements, buckets span {span!r} s, "
          f"busy seconds within {b_err:.3g} s of the closed form, "
          f"{int(m.sla_breaches)} SLA breaches from t = "
          f"{float(m.first_breach_t)!r} (as the responses give); probed "
          f"{runs['probed'][2]!r} s ({per['probed']:.3f} ms a step, "
          f"{run_line(runs['probed'][1])}), leap off "
          f"{runs['probed-leap-off'][2]!r} s, unprobed {runs['off'][2]!r} "
          f"s ({per['off']:.3f} ms a step) ({card})")


def headroom_scenario(seed, device, n_vms=24, per_slot=6, alive=4):
    """``benchmarks/bench_policies.py::bench_elasticity``'s headroom lane
    (its recipe and numpy draws, copied): 16 hosts of 4 PEs, 24 one-PE
    slots of which 4 start alive, 6 cloudlets a slot, a watermark
    autoscaler and a three-segment spot track."""
    import dataclasses
    import numpy as np
    from repro_torch.core import state as S
    rng = np.random.default_rng(seed)
    hosts = S.make_uniform_hosts(16, pes=4, mips=1000.0, ram=8192.0,
                                 bw=1000.0, storage=1e6, device=device)
    vms = S.make_vms([1] * n_vms, [1000.0] * n_vms, [512.0] * n_vms,
                     [100.0] * n_vms, [1000.0] * n_vms, device=device)
    st = np.full(n_vms, S.VM_EMPTY, np.int32)
    st[:alive] = S.VM_PENDING
    vms = dataclasses.replace(vms, state=torch_tensor(st, device))
    vm = np.repeat(np.arange(n_vms, dtype=np.int32), per_slot)
    sub = np.tile(np.sort(rng.uniform(0.0, 10.0, per_slot))
                  .astype(np.float32), n_vms)
    lens = rng.uniform(400.0, 1600.0, n_vms * per_slot).astype(np.float32)
    scaler = S.make_autoscaler(util_high=0.7, util_low=0.25, cooldown=2.0,
                               min_fleet=alive, max_fleet=n_vms,
                               scale_step=2, spot_t=[0.0, 60.0, 180.0],
                               spot_price=[0.05, 0.4, 0.08], device=device)
    return S.make_datacenter(hosts, vms, S.make_cloudlets(vm, lens, sub,
                                                          device=device),
                             vm_policy=S.SPACE_SHARED,
                             task_policy=S.SPACE_SHARED, scaler=scaler,
                             device=device)


def phase_policy_search(device, card, launched, n_seeds=8):
    """Phase 17: ``policy-search``: ``n_seeds`` headroom lanes x 12
    autoscaler points (``bench_elasticity``'s grid) in one
    ``run_policy_search`` on the card: every cell equals its single run
    bitwise; the batch on the CPU gives the same states and counts.
    Then ``run_elasticity_study`` with probes on, card against CPU on
    the counts and the Pareto mask."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import experiments as X
    from repro_torch.core import metrics as M
    from repro_torch.core import sweep
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    grids = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        batch = sweep.stack_scenarios([headroom_scenario(100 + s, dev)
                                       for s in range(n_seeds)])
        grid = sweep.policy_points(util_highs=(0.6, 0.75, 0.9),
                                   util_lows=(0.2, 0.35),
                                   cooldowns=(1.0, 4.0), device=dev)
        if where == "card":
            torch.cuda.synchronize()
            simstep.launches = 0
        t0 = time.perf_counter()
        final = sweep.run_policy_search(batch, grid, max_steps=4096)
        if where == "card":
            torch.cuda.synchronize()
            launched["policy-search"] = simstep.launches
        grids[where] = (batch, grid, final, time.perf_counter() - t0)
    batch, grid, final, wall = grids["card"]
    n_pol = grid.util_high.shape[0]
    check(n_pol == 12, f"policy-search: {n_pol} points")
    cpu = grids["cpu"][2]
    for name, a, b in (("states", final.cloudlets.state,
                        cpu.cloudlets.state),
                       ("VM states", final.vms.state, cpu.vms.state),
                       ("ups", final.scaler.up_count, cpu.scaler.up_count),
                       ("downs", final.scaler.down_count,
                        cpu.scaler.down_count)):
        check(torch.equal(a.cpu(), b), f"policy-search: card and CPU "
              f"{name} differ")
    singles, events = 0.0, 0
    for p in range(n_pol):
        for b in range(n_seeds):
            one = lane(batch, b)
            cell = dataclasses.replace(one, scaler=dataclasses.replace(
                one.scaler, util_high=grid.util_high[p].clone(),
                util_low=grid.util_low[p].clone(),
                cooldown=grid.cooldown[p].clone(),
                scale_step=grid.scale_step[p].clone(),
                price_sensitivity=grid.price_sensitivity[p].clone()))
            t0 = time.perf_counter()
            out, stats = run_stats(cell, max_steps=4096)
            torch.cuda.synchronize()
            singles += time.perf_counter() - t0
            events += stats.n_events
            check(same_state(lane(final, p, b), out),
                  f"policy-search: cell {p},{b} != its single run")
    ups = int(final.scaler.up_count.sum())
    downs = int(final.scaler.down_count.sum())
    check(ups > 0 and downs > 0, f"policy-search: {ups} up, {downs} down")
    studies = {}
    for where, (b_, g_, _, _) in grids.items():
        n_hosts = b_.hosts.num_pes.shape[1]
        plane = M.make_metrics(n_hosts, horizon=120.0, buckets=16, bins=24,
                               sla_factor=2.0, device=b_.time.device)
        probed = sweep.stack_scenarios([
            dataclasses.replace(lane(b_, i), metrics=plane)
            for i in range(n_seeds)])
        t0 = time.perf_counter()
        studies[where] = (X.run_elasticity_study(probed, g_,
                                                 max_steps=4096),
                          time.perf_counter() - t0)
    gs, cs = studies["card"][0], studies["cpu"][0]
    check(np.array_equal(gs.pareto, cs.pareto)
          and torch.equal(gs.sla.cpu(), cs.sla)
          and torch.equal(gs.static_sla.cpu(), cs.static_sla)
          and np.array_equal(gs.latency_p50, cs.latency_p50)
          and np.array_equal(gs.latency_p95, cs.latency_p95),
          "policy-search: the card's study != the CPU's")
    check(torch.equal(gs.final.cloudlets.state, final.cloudlets.state),
          "policy-search: probes changed the search")
    print(f"[policy-search] {n_seeds} headroom lanes x {n_pol} autoscaler "
          f"points = {n_pol * n_seeds} lanes in one run_policy_search: "
          f"every cell == its single run bitwise, card == CPU; {ups} VMs "
          f"up, {downs} down, {events} events; batched {wall!r} s "
          f"({launched['policy-search']} simstep launches), the "
          f"{n_pol * n_seeds} single runs {singles!r} s, CPU batch "
          f"{grids['cpu'][3]!r} s; elasticity study with probes: "
          f"{int(gs.pareto.sum())} Pareto points, SLA "
          f"{gs.sla.tolist()} (static {int(gs.static_sla)}), p95 "
          f"{gs.latency_p95.tolist()}, card {studies['card'][1]!r} s, "
          f"CPU {studies['cpu'][1]!r} s ({card})")


def elastic_streamed_scenario(seed, device):
    """``tests/test_conformance.py::make_elastic_streamed_scenario`` (its
    recipe and numpy draws, copied), policies (0, 0): the streamed
    recipe with two latent slots, arrivals over all seven, a watermark
    autoscaler and (even seeds) a spot track."""
    import dataclasses
    import numpy as np
    from repro_torch.core import state as S
    dc, stream = streamed_scenario(seed, device, n_vms=5)
    rng = np.random.default_rng(41_000 + seed)
    nv = 5 + 2
    vms = S.make_vms(
        rng.integers(1, 3, nv), rng.choice([250.0, 500.0, 1000.0], nv),
        64.0, 1.0, 10.0,
        submit_time=np.round(rng.uniform(0, 3, nv), 2).astype(np.float32),
        device=device)
    st = vms.state.cpu().numpy().copy()
    st[5:] = S.VM_EMPTY
    vms = dataclasses.replace(vms, state=torch_tensor(st, device))
    vm_ids = stream.vm.cpu().numpy().copy()
    live = vm_ids >= 0
    vm_ids[live] = np.asarray(rng.integers(0, nv, int(live.sum())),
                              np.int32)
    stream = dataclasses.replace(stream, vm=torch_tensor(vm_ids, device))
    sc_kw = {}
    if seed % 2 == 0:
        t1 = round(float(rng.uniform(4, 12)), 2)
        sc_kw["spot_t"] = [0.0, t1]
        sc_kw["spot_price"] = [round(float(p), 2)
                               for p in rng.uniform(0.01, 0.1, 2)]
    scaler = S.make_autoscaler(
        util_high=float(rng.choice([0.55, 0.72])),
        util_low=float(rng.choice([0.18, 0.28])),
        cooldown=round(float(rng.uniform(1, 3)), 2),
        min_fleet=1, max_fleet=nv,
        scale_step=int(rng.integers(1, 3)), device=device, **sc_kw)
    return dataclasses.replace(dc, vms=vms, scaler=scaler), stream


def phase_elastic_stream_lanes(device, card, launched, n_seeds=4,
                               n_probed=2000):
    """Phase 18: ``elastic-stream-lanes``: ``n_seeds`` elastic streamed
    scenarios x the 2x2 grid in one ``run_stream_grid``, and one probed
    streamed lane (``bench_metrics``' lane at ``n_probed`` arrivals,
    window 64): every lane == its single run bitwise, the card == the
    CPU, and the probed lane's chunk 256 == chunk 4,096 bitwise."""
    import dataclasses
    import torch
    from repro_torch.core import metrics as M
    from repro_torch.core import sweep
    from repro_torch.core.engine import run_stream_stats
    from repro_torch.kernels.simstep import simstep

    out = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        pairs = [elastic_streamed_scenario(s, dev) for s in range(n_seeds)]
        batch = sweep.stack_scenarios([p[0] for p in pairs])
        streams = [p[1] for p in pairs]
        vm_p, task_p = sweep.policy_grid(device=dev)
        if where == "card":
            torch.cuda.synchronize()
            simstep.launches = 0
        t0 = time.perf_counter()
        res = sweep.run_stream_grid(batch, streams, vm_p, task_p,
                                    reservoir=32)
        if where == "card":
            torch.cuda.synchronize()
            launched["elastic-stream-lanes"] = simstep.launches
        out[where] = (batch, streams, vm_p, task_p, res,
                      time.perf_counter() - t0)
    batch, streams, vm_p, task_p, (gdc, gst, grec), wall = out["card"]
    cdc, cst, _ = out["cpu"][4]
    for name, a, b in (("states", gdc.cloudlets.state, cdc.cloudlets.state),
                       ("VM states", gdc.vms.state, cdc.vms.state),
                       ("placements", gdc.vms.host, cdc.vms.host),
                       ("ups", gdc.scaler.up_count, cdc.scaler.up_count),
                       ("downs", gdc.scaler.down_count,
                        cdc.scaler.down_count),
                       ("retired", gst.stats.n_retired,
                        cst.stats.n_retired)):
        check(torch.equal(a.cpu(), b), f"elastic-stream-lanes: card and "
              f"CPU {name} differ")
    err = float((gdc.scaler.spot_cost.cpu().double()
                 - cdc.scaler.spot_cost.double()).abs().max())
    check(err <= 1e-4, f"elastic-stream-lanes: spot spend off by {err!r}")
    singles = 0.0
    for p in range(4):
        for b in range(n_seeds):
            cell = dataclasses.replace(lane(batch, b),
                                       vm_policy=vm_p[p].clone(),
                                       task_policy=task_p[p].clone())
            t0 = time.perf_counter()
            one, st, rec, _ = run_stream_stats(cell, streams[b],
                                               reservoir=32)
            torch.cuda.synchronize()
            singles += time.perf_counter() - t0
            k = rec.time.shape[0]
            check(same_state(lane(gdc, p, b), one)
                  and same_state(lane(gst.stats, p, b), st.stats)
                  and all(bool(torch.equal(x[p, b, :k], y))
                          for x, y in zip(grec, rec)),
                  f"elastic-stream-lanes: lane {p},{b} != its single run")
    actions = int(gdc.scaler.up_count.sum() + gdc.scaler.down_count.sum())
    check(actions > 0, "elastic-stream-lanes: the autoscaler never acted")
    # the probed streamed lane
    runs = {}
    before = simstep.launches
    for name, dev, chunk in (("card", device, 4096),
                             ("card-256", device, 256),
                             ("cpu", "cpu", 4096)):
        dc, stream = poisson_stream(n_probed, dev, chunk=chunk)
        dc = dataclasses.replace(dc, metrics=M.make_metrics(
            dc.hosts.num_pes.shape[0], horizon=n_probed / 40.0, buckets=32,
            bins=24, sla_factor=2.0, device=dev))
        runs[name] = timed_stream(dc, stream, max_steps_per_chunk=4 * 4096)
    launched["elastic-stream-lanes"] += simstep.launches - before
    check(same_chunking(runs["card"], runs["card-256"]),
          "elastic-stream-lanes: the probed lane depends on the chunk")
    perr = stream_agree(runs["card"], runs["cpu"], "probed stream")
    gm, cm = runs["card"][0].metrics, runs["cpu"][0].metrics
    for name in ("hist_response", "hist_exec", "hist_wait", "sla_breaches",
                 "peak_backlog"):
        check(torch.equal(getattr(gm, name).cpu(), getattr(cm, name)),
              f"probed stream: {name} differs between card and CPU")
    check(int(gm.hist_response.sum()) == n_probed,
          f"probed stream: {int(gm.hist_response.sum())} retirements")
    print(f"[elastic-stream-lanes] {4 * n_seeds} elastic streamed lanes "
          f"({n_seeds} scenarios x the 2x2 grid) in one run_stream_grid: "
          f"every lane == its single run bitwise, card == CPU, {actions} "
          f"scale actions; batched {wall!r} s, the {4 * n_seeds} single "
          f"runs {singles!r} s, CPU batch {out['cpu'][5]!r} s; probed "
          f"stream of {n_probed} arrivals through 64 slots: chunk 256 == "
          f"chunk 4096 bitwise, card == CPU (histograms exact, max float "
          f"err {perr:.3g}), {int(gm.sla_breaches)} SLA breaches; card "
          f"{runs['card'][4]!r} s ({stream_line(runs['card'][3])}), CPU "
          f"{runs['cpu'][4]!r} s ({card})")


# ---------------------------------------------------------------------------
# Federation studies and the lane dispatcher (phases 19-20)
# ---------------------------------------------------------------------------
# [intercloud-100k]: the paper's largest datacenter split into four §5
# host parks (hosts, $ per PE-s), and ten users of 5,000 §5 VMs each
PARKS = ((10_000, 0.01), (20_000, 0.02), (30_000, 0.03), (40_000, 0.05))
N_FLEETS, FLEET_VMS = 10, 5_000
ASSIGNMENT = [0, 0, 1, 1, 1, 1, 2, 2, 2, 2]   # FCFS greedy by PE capacity


def federation(device, scale=1):
    """``[intercloud-100k]``'s providers and fleets at 1/``scale`` of
    their size: §5 hosts (1 PE at 1000 MIPS, 1 GB, 2 TB, 100 W idle and
    200 W peak) and §5 VMs, each with ten waves of 1.2M MI 600 s apart."""
    from repro_torch.core import broker as B
    from repro_torch.core import experiments as E
    from repro_torch.core import state as S
    providers = [E.Provider(
        S.make_uniform_hosts(n // scale, idle_w=100.0, peak_w=200.0,
                             device=device),
        S.make_market(rate, 0.001, 1e-4, 0.002, device=device))
        for n, rate in PARKS]
    fleets = [E.UserFleet(
        (B.VmSpec(count=FLEET_VMS // scale, pes=1, mips=1000.0, ram=512.0,
                  bw=10.0, size=1000.0),),
        B.WaveSpec(waves=10, length_mi=1_200_000.0, period=600.0))
        for _ in range(N_FLEETS)]
    return providers, fleets


def cut(state, like):
    """``state``'s lane cut back to the entity counts of ``like``."""
    import dataclasses
    from repro_torch.core.state import map_tensors
    h = like.hosts.num_pes.shape[0]
    v = like.vms.req_pes.shape[0]
    c = like.cloudlets.vm.shape[0]
    return dataclasses.replace(
        state, hosts=map_tensors(lambda t: t[:h], state.hosts),
        vms=map_tensors(lambda t: t[:v], state.vms),
        cloudlets=map_tensors(lambda t: t[:c], state.cloudlets),
        net=dataclasses.replace(state.net, cluster=state.net.cluster[:h]),
        metrics=dataclasses.replace(
            state.metrics, host_busy_s=state.metrics.host_busy_s[:h]))


def same_rows(a, b):
    """Two registry tables or reports equal, column by column (a NaN
    equal to a NaN: the mean response of a provider with no work)."""
    import torch
    return all(x.dtype == y.dtype and bool(torch.allclose(
        x.cpu(), y.cpu(), rtol=0.0, atol=0.0, equal_nan=True))
        for x, y in zip(a, b))


def study_agree(gpu, cpu, tag):
    """A study on the card against the same study on the CPU: the
    assignment, registry rows, states and placements exact; times and
    joules within 1e-3."""
    import torch
    check(torch.equal(gpu.assignment.cpu(), cpu.assignment),
          f"{tag}: assignments differ")
    check(same_rows(gpu.table, cpu.table), f"{tag}: registry rows differ")
    for name, a, b in (
            ("cloudlet states", gpu.final.cloudlets.state,
             cpu.final.cloudlets.state),
            ("VM states", gpu.final.vms.state, cpu.final.vms.state),
            ("placements", gpu.final.vms.host, cpu.final.vms.host),
            ("completions", gpu.summary.n_done, cpu.summary.n_done)):
        check(torch.equal(a.cpu(), b), f"{tag}: {name} differ")
    err = max(float((a.cpu().double() - b.double()).abs().max())
              for a, b in ((gpu.final.cloudlets.finish_time,
                            cpu.final.cloudlets.finish_time),
                           (gpu.final.cloudlets.start_time,
                            cpu.final.cloudlets.start_time),
                           (gpu.final.hosts.energy_j,
                            cpu.final.hosts.energy_j)))
    check(err <= 1e-3, f"{tag}: card and CPU differ by {err!r}")
    return err


def phase_intercloud(device, card, launched, scale=1, small=100):
    """Phase 19: ``[intercloud-100k]``, an inter-cloud study over the
    paper's largest datacenter split four ways: 100,000 hosts, 50,000
    VMs and 500,000 cloudlets routed by the CIS and the broker, then
    ``run_study`` over the 2x2 grid (16 lanes padded to 40,000 hosts).
    The exact assignment, the registry's closed forms, the §5 closed
    forms in every cell, the idle provider inert, cells of provider 2 ==
    their single runs bitwise, and the card == the CPU at 1/``small``
    of the size (``scale`` shrinks the whole phase, for a rehearsal)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import cis
    from repro_torch.core import experiments as E
    from repro_torch.core import state as S
    from repro_torch.core import sweep
    from repro_torch.core.engine import run_stats
    from repro_torch.kernels.simstep import simstep

    providers, fleets = federation(device, scale)
    vm_p, task_p = sweep.policy_grid(device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dcs, assignment, table = E.build_study(providers, fleets, device=device)
    torch.cuda.synchronize()
    route_wall = time.perf_counter() - t0
    simstep.launches = 0
    t0 = time.perf_counter()
    study = E.run_study(providers, fleets, vm_p, task_p, max_steps=8192,
                        device=device)
    torch.cuda.synchronize()
    study_wall = time.perf_counter() - t0
    launched["intercloud"] = n_study = simstep.launches
    check(study.assignment.tolist() == ASSIGNMENT == assignment.tolist(),
          f"intercloud: assignment {study.assignment.tolist()}")
    # the registry: closed forms, and the CPU's rows bit for bit
    n_hosts = np.array([n // scale for n, _ in PARKS], np.float64)
    closed = dict(total_pes=n_hosts, max_mips_pe=np.full(4, 1000.0),
                  free_ram=1024.0 * n_hosts, free_storage=2e6 * n_hosts,
                  free_bw=1000.0 * n_hosts, free_pes=n_hosts,
                  cost_per_cpu_sec=np.array([r for _, r in PARKS]),
                  cost_per_mem=np.full(4, 0.001))
    for name, want in closed.items():
        got = getattr(study.table, name).cpu().numpy()
        want = want.astype(np.float32)
        ok = (np.allclose(got, want, rtol=1e-6, atol=0)
              if name == "free_storage" else np.array_equal(got, want))
        check(ok, f"intercloud: registry {name} {got} != {want}")
    cpu_rows = cis.stack([cis.register(S.make_datacenter(
        S.to_device(p.hosts, "cpu"), S.make_vms([1], 1000.0, 0.0, 0.0, 0.0,
                                                device="cpu"),
        S.make_cloudlets([0], 1.0, device="cpu"),
        rates=S.to_device(p.rates, "cpu"), device="cpu"))
        for p in providers])
    check(same_rows(study.table, cpu_rows),
          "intercloud: the card's registry rows != the CPU's")
    # every cell: §5's closed forms for its VM count; provider 3 inert
    n_vms = [FLEET_VMS // scale * ASSIGNMENT.count(d) for d in range(3)]
    n_cl = 10 * N_FLEETS * (FLEET_VMS // scale)
    for p, tp in enumerate(task_p.tolist()):
        for d in range(3):
            cell = cut(lane(study.final, p, d), dcs[d])
            check_section5(cell, None, tp, n_vms[d],
                           f"intercloud-{p}-dc{d}")
        idle = lane(study.final, p, 3)
        check(float(idle.time) == 0.0
              and int((idle.cloudlets.state == CL_DONE).sum()) == 0
              and float(idle.hosts.energy_j.abs().max()) == 0.0,
              f"intercloud: the idle provider stepped under policy {p}")
    check(study.fed_done.tolist() == [n_cl] * 4,
          f"intercloud: fed_done {study.fed_done.tolist()}")
    # provider 2's cells, each run alone
    singles = 0.0
    for p in range(4):
        one = dataclasses.replace(dcs[2], vm_policy=vm_p[p].clone(),
                                  task_policy=task_p[p].clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single, _ = run_stats(one, max_steps=8192)
        torch.cuda.synchronize()
        singles += time.perf_counter() - t0
        check(same_state(cut(lane(study.final, p, 2), single), single),
              f"intercloud: cell ({p}, dc2) != its single run")
    # card == CPU on the same federation at 1/100 scale
    runs, small_walls = {}, {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        prov, fl = federation(dev, scale=small)
        t0 = time.perf_counter()
        runs[where] = E.run_study(prov, fl, *sweep.policy_grid(device=dev),
                                  max_steps=8192, device=dev)
        torch.cuda.synchronize()
        small_walls[where] = time.perf_counter() - t0
    err = study_agree(runs["card"], runs["cpu"], f"intercloud-1/{small}")
    check(runs["cpu"].assignment.tolist() == ASSIGNMENT,
          f"intercloud-1/{small}: assignment")
    print(f"[intercloud-100k] 4 providers ({n_hosts.astype(int).tolist()} "
          f"§5 hosts at {[r for _, r in PARKS]} $ a PE-s), {N_FLEETS} users "
          f"of {FLEET_VMS // scale} VMs, {n_cl} cloudlets: assignment "
          f"{ASSIGNMENT} exact; registry rows at their closed forms and == "
          f"the CPU's; run_study over the 2x2 grid, 16 lanes padded to "
          f"{int(n_hosts[-1])} hosts, {max(n_vms)} VM slots and "
          f"{10 * max(n_vms)} cloudlet slots: every cell meets the §5 "
          f"closed forms, the idle provider inert, fed_done {n_cl} a "
          f"policy, provider 2's cells == their single runs bitwise; "
          f"routing (build_study) {route_wall!r} s, run_study "
          f"{study_wall!r} s ({n_study} simstep launches), provider 2's "
          f"four single runs {singles!r} s; at 1/{small} card == CPU (max "
          f"float err {err:.3g}), card {small_walls['card']!r} s, CPU "
          f"{small_walls['cpu']!r} s ({card})")


def phase_dispatch(device, card, launched, n_seeds=16, n_hosts=256,
                   n_dyn=8, small=100):
    """Phase 20: ``[dispatch]``, the lane dispatcher: the ``lanes-64``
    and ``dyn-lanes`` batches through ``run_sharded(partitioner=
    "dispatch")`` over ``[card]`` and ``[card, card]``, each ==
    ``run_batch`` bitwise; ``federated_run`` == ``vmap_federation``
    bitwise on the federation at 1/``small`` of its size."""
    import torch
    from repro_torch.core import experiments as E
    from repro_torch.core import federation as F
    from repro_torch.core import sweep
    from repro_torch.kernels.simstep import simstep

    vm_p, task_p = sweep.policy_grid(device=device)
    batches = (
        ("lanes-64", 1 << 20, [shared_hosts(s, n_hosts, device)
                               for s in range(n_seeds)]),
        ("dyn-lanes", 4096, dyn_lane_scenarios(n_dyn, device)))
    n_launch, lines = 0, []
    for tag, steps, dcs in batches:
        fused = sweep.fuse_grid(sweep.stack_scenarios(dcs), vm_p, task_p)
        walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = sweep.run_batch(fused, max_steps=steps)
        torch.cuda.synchronize()
        walls["run_batch"] = time.perf_counter() - t0
        for name, devs in (("[card]", [device]),
                           ("[card, card]", [device, device])):
            simstep.launches = 0
            t0 = time.perf_counter()
            out = sweep.run_sharded(fused, devices=devs, max_steps=steps,
                                    partitioner="dispatch")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            n_launch += simstep.launches
            check(same_state(out, ref),
                  f"dispatch: {tag} over {name} != run_batch")
        lines.append(f"{tag} ({fused.time.shape[0]} lanes, chunks of 4) "
                     f"run_batch {walls['run_batch']!r} s, dispatched over "
                     f"[card] {walls['[card]']!r} s and [card, card] "
                     f"{walls['[card, card]']!r} s")
    launched["dispatch"] = n_launch
    dcs, _, _ = E.build_study(*federation(device, scale=small),
                              device=device)
    stack = sweep.stack_scenarios(dcs)
    t0 = time.perf_counter()
    ref = F.vmap_federation(stack, max_steps=8192)
    torch.cuda.synchronize()
    vmap_wall = time.perf_counter() - t0
    simstep.launches = 0
    t0 = time.perf_counter()
    fed = F.federated_run(stack, devices=[device, device], max_steps=8192)
    torch.cuda.synchronize()
    fed_wall = time.perf_counter() - t0
    launched["federated"] = simstep.launches
    check(same_state(fed[0], ref[0]) and same_rows(fed[1], ref[1])
          and same_rows(fed[2], ref[2]),
          "dispatch: federated_run != vmap_federation")
    print(f"[dispatch] every spelling == run_batch bitwise: "
          f"{'; '.join(lines)}; {n_launch} simstep launches dispatched; "
          f"federated_run over [card, card] == vmap_federation bitwise on "
          f"the 1/{small} federation (4 datacenters): {fed_wall!r} s against "
          f"{vmap_wall!r} s ({card})")


def plan_ms(dc, reps=20):
    """Wall milliseconds of one host-plan rebuild of ``dc`` (its two host
    syncs included)."""
    import torch
    from repro_torch.core import scheduling
    batch = scheduling.lane_axis(dc)
    lanes = scheduling.lanes_of(batch)
    scheduling.host_plan(batch, lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        scheduling.host_plan(batch, lanes)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def pass_variants(n_hosts, n_vms, device):
    """The §5 scenario (time-shared, placed, empty transfers) as it is,
    under THRESHOLD migration at a threshold no host exceeds (the dynamic
    and migration passes run every step, nothing migrates), on an enabled
    topology with zero-size, zero-latency transfers (the network passes
    run, no transfer costs an event), with an enabled autoscaler that is
    never due and a one-segment spot track (the scaler check and the
    spot accrual run every step, no boundary is an event), and with a
    metrics plane of 32 buckets and 24 bins (the probes run every
    commit)."""
    import dataclasses
    import torch
    from repro_torch.core import metrics as M
    from repro_torch.core import state as S
    from repro_torch.core.provisioning import provision_pending

    dc = provision_pending(section5(n_hosts, n_vms, S.TIME_SHARED, device))
    cl = dc.cloudlets
    dc = dataclasses.replace(dc, cloudlets=dataclasses.replace(
        cl, file_size=torch.zeros_like(cl.file_size),
        output_size=torch.zeros_like(cl.output_size)))
    return {
        "static": dc,
        "migration": dataclasses.replace(
            dc, mig_policy=torch.tensor(S.MIG_THRESHOLD, dtype=torch.int32,
                                        device=device),
            mig_threshold=torch.tensor(1.0, device=device)),
        "network": dataclasses.replace(dc, net=S.make_topology(
            torch.zeros(n_hosts, dtype=torch.int32), device=device)),
        "elastic": dataclasses.replace(dc, scaler=S.make_autoscaler(
            util_high=2.0, util_low=-1.0, max_fleet=n_vms, spot_t=[0.0],
            spot_price=[0.02], device=device)),
        "probed": dataclasses.replace(dc, metrics=M.make_metrics(
            n_hosts, horizon=12000.0, buckets=32, bins=24, sla_factor=2.0,
            device=device)),
    }


def host_ops(dc):
    """Host-dispatched aten ops a full step of ``run_stats(dc)``: every
    op that reaches the dispatcher, counted by a dispatch mode, over the
    steps evaluated."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core.engine import run_stats

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        _, stats = run_stats(dc, max_steps=8192)
    return Count.n / stats.n_steps


def phase_pass_cost(device, card, n_hosts=100_000, n_vms=50_000):
    """Phase 19: what the migration, network, elastic, probe and
    streaming passes cost a full step at the §5 datacenter's size: each
    variant of ``pass_variants`` and the scenario streamed through a
    window of every slot must give the static run's events and finish
    times bit for bit; the line gives wall per evaluated step, host ops
    a step (counted on the CPU at 2,000 hosts), and the wall of a
    host-plan rebuild."""
    import torch
    from repro_torch.core.engine import run_stats
    from repro_torch.core.provisioning import provision_pending

    variants = pass_variants(n_hosts, n_vms, device)
    dc = variants["static"]
    ops = {name: host_ops(v)
           for name, v in pass_variants(2000, 1000, "cpu").items()}
    parts, ref = [], None
    for name, variant in variants.items():
        run_stats(variant, max_steps=8192)              # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, stats = run_stats(variant, max_steps=8192)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if ref is None:
            ref = (final, stats)
        check(stats.n_events == ref[1].n_events and torch.equal(
            final.cloudlets.finish_time, ref[0].cloudlets.finish_time),
            f"pass-cost: the {name} passes changed the run")
        parts.append(f"{name} {wall!r} s for {stats.n_steps} steps "
                     f"({wall / stats.n_steps * 1e3:.3f} ms a step, "
                     f"{ops[name]:.1f} host ops a step)")
    # streamed through a window of every slot: the admission pass, the
    # regrouped view and its padded index join every full step (every
    # arrival's finish read back from a reservoir of stride 1)
    from repro_torch.core.engine import run_stream_stats
    n_cl = dc.cloudlets.vm.shape[0]
    win, stream, order = as_stream(dc, n_cl, 65_536)
    run_stream_stats(win, stream, reservoir=n_cl)       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, st, _, stats = run_stream_stats(win, stream, reservoir=n_cl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slot = torch.from_numpy(order).to(device)
    check(stats.n_events == ref[1].n_events and torch.equal(
        st.stats.res_finish, ref[0].cloudlets.finish_time[slot])
        and torch.equal(final.hosts.energy_j, ref[0].hosts.energy_j),
        "pass-cost: the streamed run differs from the static one")
    parts.append(f"streamed through a window of all "
                 f"{dc.cloudlets.vm.shape[0]} slots {wall!r} s for "
                 f"{stats.n_steps} steps ({wall / stats.n_steps * 1e3:.3f} "
                 f"ms a step, {stats.n_passes} admission passes)")
    print(f"[pass-cost] §5 {n_hosts} hosts time-shared, {ref[1].n_events} "
          f"events, the same bits with each set of passes: "
          + "; ".join(parts) + f"; a host-plan rebuild {plan_ms(dc)!r} ms, "
          f"at migration-16x's size "
          f"{plan_ms(provision_pending(migration_scenario(device)))!r} ms "
          f"({card})")


def phase_profile(device, card):
    """Where a §5 run's device time goes: profiler traces of the
    time-shared runs at both scales (after the main path's counts are
    read).  Device busy share = kernel and copy time over wall time."""
    import torch
    from repro_torch.core import state as S
    from repro_torch.core.engine import run_stats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    for n_hosts, n_vms in ((10_000, 50), (100_000, 50_000)):
        dc = section5(n_hosts, n_vms, S.TIME_SHARED, device)
        run_stats(dc, max_steps=8192)           # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_stats(dc, max_steps=8192)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels and copies only: the CPU ops that launched them carry
        # the same device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        tag = f"[profile] s5 {n_hosts} hosts time-shared"
        if not events:
            print(f"{tag}: the profiler showed no device time: not measured")
            continue
        busy = sum(dev_us(e) for e in events) / 1e6
        top = sorted(events, key=dev_us, reverse=True)[:5]
        print(f"{tag}: wall {wall!r} s under the profiler, device busy "
              f"{busy!r} s ({busy / wall:.4f} of wall), "
              f"{sum(e.count for e in events)} device ops; top: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms "
                          f"x{e.count}" for e in top) + f" ({card})")
    # the fused 2x2 grid at 100,000 hosts: 4 lanes a launch
    from repro_torch.core import sweep
    batch = sweep.stack_scenarios([section5(100_000, 50_000, 0, device)])
    grid = sweep.policy_grid(device=device)
    sweep.run_grid(batch, *grid, max_steps=8192)          # warm
    profile_top(lambda: sweep.run_grid(batch, *grid, max_steps=8192),
                "s5 100000 hosts x policy_grid() in one run_grid", card)
    # the §5 step with the elastic and with the probe passes on
    # (pass-cost's variants): where their extra wall a step goes
    for name, dc in pass_variants(100_000, 50_000, device).items():
        if name in ("elastic", "probed"):
            run_stats(dc, max_steps=8192)                 # warm
            profile_top(lambda: run_stats(dc, max_steps=8192),
                        f"s5 100000 hosts time-shared, {name} passes",
                        card)


def tree_bytes(tree):
    """Bytes of every tensor in a nested dict/tuple."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def flash_inputs(gen, b, s, h, kh, hd, dtype, device, skv=None):
    import torch
    skv = s if skv is None else skv
    q = torch.randn((b, s, h, hd), generator=gen, device=device)
    k = torch.randn((b, skv, kh, hd), generator=gen, device=device)
    v = torch.randn((b, skv, kh, hd), generator=gen, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def scan_inputs(gen, b, s, di, n, device, zero_d=False, dt_scale=1.0):
    import torch
    import torch.nn.functional as F
    r = lambda *shape: torch.randn(shape, generator=gen, device=device)
    dt = F.softplus(r(b, s, di)) * dt_scale
    a = -torch.exp(r(di, n))
    d = torch.zeros(di, device=device) if zero_d else torch.ones(
        di, device=device)
    return dt, r(b, s, di), r(b, s, n), r(b, s, n), a, d


def phase_lm_kernels(device):
    """Phase 5a: flash attention and the selective scan against their
    plain versions on edge cases, then timed at the main path's shapes.
    Returns their records (without the main path's launch counts)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref, design,
                                                     flash_attention)
    from repro_torch.kernels.selective_scan import (selective_scan_cuda,
                                                    selective_scan_ref)

    gen = torch.Generator(device=device).manual_seed(0)
    # (B, Sq, H, KH, hd, window, Skv): ragged 96, GQA 4:1 and 2:1, window
    # 48, hd 16 (smoke configs), 32, 64, 80 and 128, Sq < Skv
    cases = [(2, 96, 2, 2, 64, None, None), (2, 256, 8, 2, 64, None, None),
             (2, 128, 4, 2, 128, 48, None), (1, 96, 8, 2, 32, None, None),
             (1, 200, 4, 2, 80, 48, None), (2, 160, 4, 4, 16, None, None),
             (1, 130, 4, 1, 128, None, None), (1, 64, 2, 2, 64, None, 128),
             (2, 100, 4, 2, 80, None, None), (1, 300, 2, 1, 32, 7, None)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = FLASH_TOL[name]
        for b, s, h, kh, hd, window, skv in cases:
            q, k, v = flash_inputs(gen, b, s, h, kh, hd, dtype, device, skv)
            got = flash_attention(q, k, v, causal=True, window=window)
            want = attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            worst[name] = max(worst[name],
                              float((got.float() - want.float()).abs().max()))
    print(f"[lm-kernels] flash_attention vs plain version: {len(cases)} "
          f"shapes x (f32, bf16), tol {FLASH_TOL}: max_abs_err {worst}")

    b, s, h, kh, hd = 4, PREFILL_LEN, 16, 8, 128          # qwen3-0.6b
    q, k, v = flash_inputs(gen, b, s, h, kh, hd, torch.bfloat16, device)
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL["bfloat16"],
                               rtol=FLASH_TOL["bfloat16"])
    main_err = float((got.float() - want.float()).abs().max())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    lib_err = float((lib.float() - want.float()).abs().max())
    ms = device_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=True),
                         reps=3, warmup=1)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
    flops = 4 * b * h * s * s * hd / 2
    moved = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms = max(flops / BF16_OPS_PER_S, moved / HBM_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / BF16_OPS_PER_S
                >= moved / HBM_BYTES_PER_S else "bytes")
    f32 = [t.float() for t in (q, k, v)]
    got = flash_attention(*f32, causal=True)
    want = attention_ref(*f32, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=FLASH_TOL["float32"],
                               rtol=FLASH_TOL["float32"])
    f32_err = float((got - want).abs().max())
    del got, want
    f32_ms = device_ms(lambda: flash_attention(*f32, causal=True), reps=5)
    kind = design(torch.bfloat16, hd)
    print(f"[lm-kernels] flash_attention [{b},{s},{h}/{kh},{hd}] f32 causal "
          f"on the {design(torch.float32, hd)} design: kernel {f32_ms!r} ms "
          f"(device, graph replay), max_abs_err vs plain {f32_err!r}")
    print(f"[lm-kernels] flash_attention [{b},{s},{h}/{kh},{hd}] bf16 "
          f"causal on the {kind} design: kernel {ms!r} ms (device, graph "
          f"replay), plain version "
          f"{plain_ms!r} ms, SDPA (yardstick) {library_ms!r} ms, bound "
          f"{bound_ms!r} ms ({flops:.4g} FLOP at bf16 peak, {bound_by}); "
          f"max_abs_err vs plain {main_err!r} (SDPA vs plain {lib_err!r})")
    flash = {"name": "flash_attention", "route": "cuda", "design": kind,
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/flash.py:71",
             "max_abs_err": max(max(worst.values()), main_err), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms,
             "f32_design": design(torch.float32, hd), "f32_ms": f32_ms,
             "f32_max_abs_err": f32_err}

    # (B, S, di, N, zero D, dt scale): S not a multiple of the 32-step
    # chunk, di not a multiple of the 32-channel block (nor of 4), N
    # 4/8/16, zero D, tiny dt, S = 1
    scases = [(2, 100, 96, 4, False, 1.0), (1, 257, 256, 8, False, 1.0),
              (2, 64, 128, 16, False, 1.0), (2, 130, 200, 16, True, 1.0),
              (1, 75, 64, 8, False, 1e-6), (3, 1, 32, 4, False, 1.0),
              (1, 45, 30, 16, False, 1.0)]
    sworst = 0.0
    for bb, ss, di, n, zero_d, dt_scale in scases:
        args = scan_inputs(gen, bb, ss, di, n, device, zero_d, dt_scale)
        got = selective_scan_cuda(*args)
        want = selective_scan_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=SCAN_TOL, rtol=SCAN_TOL)
        sworst = max(sworst, float((got - want).abs().max()))
    bb, ss, di, n = 2, PREFILL_LEN, 8192, 16                # falcon-mamba-7b
    args = scan_inputs(gen, bb, ss, di, n, device)
    got = selective_scan_cuda(*args)
    want = selective_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=SCAN_TOL, rtol=SCAN_TOL)
    sworst = max(sworst, float((got - want).abs().max()))
    print(f"[lm-kernels] selective_scan vs plain version: {len(scases) + 1} "
          f"shapes, tol {SCAN_TOL}: max_abs_err {sworst!r}")
    ms = device_ms(lambda: selective_scan_cuda(*args), reps=20)
    plain_ms = device_ms(lambda: selective_scan_ref(*args), reps=1,
                         warmup=1)
    moved = 4 * (3 * bb * ss * di + 2 * bb * ss * n + di * n + di)
    exps = bb * ss * di * n
    bound_ms = max(moved / HBM_BYTES_PER_S, exps / SFU_OPS_PER_S) * 1e3
    bound_by = ("bytes" if moved / HBM_BYTES_PER_S
                >= exps / SFU_OPS_PER_S else "operations")
    print(f"[lm-kernels] selective_scan [{bb},{ss},{di}] N={n} on the "
          f"{SCAN_DESIGN} design: kernel "
          f"{ms!r} ms (device, graph replay), plain version {plain_ms!r} ms,"
          f" bound {bound_ms!r} ms ({moved} bytes at 3.35 TB/s; {exps} exps"
          f" at {SFU_OPS_PER_S:.4g}/s SFU; {bound_by}), library call: none")
    # what sets the scan's time: the same length at fewer channels.  Below
    # a wave of blocks one channel's serial chain of steps sets it; at
    # falcon's width, the SMs' instruction issue
    by_width = {}
    for width in (1024, 2048, 4096):
        a = scan_inputs(gen, bb, ss, width, n, device)
        by_width[width] = device_ms(lambda: selective_scan_cuda(*a), reps=20)
    by_width[di] = ms
    print(f"[lm-kernels] selective_scan [{bb},{ss},di] N={n} by width: "
          + ", ".join(f"di={w} {t!r} ms" for w, t in by_width.items())
          + f" (device, graph replay; {bb * di // 32 * (n // 4) / 132:.4g} "
          f"warps per SM at di={di})")
    scan = {"name": "selective_scan", "route": "cuda",
            "design": SCAN_DESIGN,
            "source": "src/repro_torch/kernels/selective_scan/csrc/"
                      "selective_scan.cu",
            "replaces": "src/repro/kernels/selective_scan/scan.py:50",
            "max_abs_err": sworst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_by_width": by_width}
    return [flash, scan]


def phase_lm_agreement(device):
    """Phase 5b: smoke configs in f32, the same weights on the card and on
    the CPU: prefill logits and KV stacks within 1e-4, and a greedy serve
    run of 4 requests over 2 slots with the same tokens and slot state."""
    import numpy as np
    import torch
    from repro_torch import configs as CFG
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    for arch in ("qwen3-0.6b", "h2o-danube-1.8b", "falcon-mamba-7b"):
        cfg = CFG.get_smoke_config(arch)
        cpu = M.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
        gpu = tree_to(cpu, device)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 40)))
        (lc, kvc), (lg, kvg) = (M.prefill(p, cfg, toks.to(p["embed"].device))
                                for p in (cpu, gpu))
        err = float((lg.cpu() - lc).abs().max())
        kv_err = max([float((g.cpu() - c).abs().max())
                      for pg, pc in zip(kvg, kvc) for g, c in zip(pg, pc)],
                     default=0.0)
        check(err <= 1e-4 and kv_err <= 1e-4,
              f"{arch} smoke prefill: logits err {err}, kv err {kv_err}")
        runs = [serve(cfg, p, requests=4, slots=2, max_new=8, prompt_len=8)
                for p in (cpu, gpu)]
        sc, sg = (r.state for r in runs)
        for field in ("generated", "n_generated", "active", "position"):
            check(torch.equal(getattr(sg, field).cpu(), getattr(sc, field)),
                  f"{arch} smoke serve: {field} differs card vs CPU")
        check(runs[0].steps == runs[1].steps, f"{arch} smoke serve steps")
        print(f"[lm-small] {arch} smoke (f32): card == CPU, prefill logits "
              f"err {err!r}, kv err {kv_err!r}; greedy serve of 4 requests "
              f"on 2 slots: tokens, n_generated, active, position equal "
              f"({runs[1].steps} steps)")


def profile_top(fn, label, card):
    """Device busy share of ``fn`` under the profiler, and its top device
    ops.  Kernels and copies only: the CPU ops that launched them carry
    the same device time again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        print(f"[profile] {label}: the profiler showed no device time: "
              f"not measured")
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    print(f"[profile] {label}: wall {wall!r} s under the profiler, device "
          f"busy {busy!r} s ({busy / wall:.4f} of wall), "
          f"{sum(e.count for e in events)} device ops; top: "
          + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                      for e in top) + f" ({card})")


def phase_lm_main(device, card, launched):
    """Phase 5c: each model at full width and depth in bf16: prefill of
    ``batch`` x 2048 tokens through the kernels (counts set to 0 just
    before and read just after, added to ``launched``), then serving 16
    requests on 8 slots (prompt 32, max-new 32, greedy)."""
    import numpy as np
    import torch
    from repro_torch import configs as CFG
    from repro_torch.kernels.flash_attention import design, flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    for arch, batch in LM_CELLS:
        cfg = CFG.get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        params = M.init_params(cfg, gen, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.randint(2, cfg.vocab_size, (batch, PREFILL_LEN),
                               generator=gen, device=device)
        M.prefill(params, cfg, tokens)                # warm, not counted
        torch.cuda.synchronize()
        flash_attention.launches = selective_scan.launches = 0
        t0 = time.perf_counter()
        logits, kvs = M.prefill(params, cfg, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"flash_attention": flash_attention.launches,
                  "selective_scan": selective_scan.launches}
        want = {"flash_attention": cfg.num_layers if cfg.has_attention
                else 0,
                "selective_scan": cfg.num_layers if cfg.has_mamba else 0}
        check(counts == want, f"{arch} prefill launches {counts}, expected "
              f"{want}")
        # the C entry point routes by dtype: the bf16 prefill's launches
        # are the tensor-core kernel's
        kind = (design(getattr(torch, cfg.dtype), cfg.head_dim)
                if cfg.has_attention else None)
        check(kind in (None, "wgmma-bf16"), f"{arch} prefill runs flash on "
              f"{kind}, expected wgmma-bf16")
        for name, n in counts.items():
            launched[name] += n
        check(tuple(logits.shape) == (batch, 1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{arch} prefill logits {tuple(logits.shape)} not finite")
        print(f"[lm-prefill] {arch} bf16, {cfg.num_layers} layers, "
              f"{batch} x {PREFILL_LEN} tokens: wall {wall!r} s, "
              f"{batch * PREFILL_LEN / wall!r} prompt tokens/s; launches "
              f"{counts}, flash on {kind}; params "
              f"{tree_bytes(params)} bytes, KV "
              f"{tree_bytes(kvs)} bytes on the device, peak allocated "
              f"{torch.cuda.max_memory_allocated()} bytes; init "
              f"{init_s!r} s ({card})")
        del logits, kvs
        profile_top(lambda: M.prefill(params, cfg, tokens),
                    f"{arch} prefill {batch} x {PREFILL_LEN}", card)

        torch.cuda.reset_peak_memory_stats()
        report = serve(cfg, params, requests=16, slots=8, max_new=32,
                       prompt_len=32)
        lat = sorted(report.latencies)
        check(report.completed == 16, f"{arch} serve: {report.completed}/16")
        print(f"[lm-serve] {arch} bf16: 16 requests on 8 slots (prompt 32, "
              f"max-new 32, greedy) done in {report.steps} engine steps, "
              f"{report.seconds!r} s: {report.tok_per_s!r} tok/s, latency "
              f"mean {sum(lat) / len(lat)!r} s p99 "
              f"{float(np.percentile(lat, 99))!r} s, peak "
              f"allocated {torch.cuda.max_memory_allocated()} bytes "
              f"({card})")

        cache = M.init_cache(cfg, 8, 128, device=device)
        tok = torch.randint(2, cfg.vocab_size, (8, 1), generator=gen,
                            device=device)
        pos = torch.full((8,), 40, dtype=torch.int32, device=device)

        def decode8():
            for _ in range(8):
                M.decode_step(params, cfg, tok, cache, pos)
        decode8()
        profile_top(decode8, f"{arch} 8 decode steps, 8 slots", card)
        del params, cache


def phase_lm_prefill_vs_decode(device):
    """Phase 5d: at full width in f32, depth cut to 4 layers: the last
    token's logits of prefill over 64 tokens equal those of feeding the
    same tokens one by one through decode_step (top-1 equal, max|diff| /
    max|logit| <= 1e-3): tests/test_models.py's invariant on the card."""
    import dataclasses
    import torch
    from repro_torch import configs as CFG
    from repro_torch.models import model as M

    for arch, _ in LM_CELLS:
        cfg = dataclasses.replace(CFG.get_config(arch), num_layers=4,
                                  dtype="float32")
        gen = torch.Generator(device=device).manual_seed(3)
        params = M.init_params(cfg, gen, device=device)
        toks = torch.randint(2, cfg.vocab_size, (2, 64), generator=gen,
                             device=device)
        full, _ = M.prefill(params, cfg, toks)
        cache = M.init_cache(cfg, 2, 64, device=device)
        for t in range(64):
            pos = torch.full((2,), t, dtype=torch.int32, device=device)
            step, cache = M.decode_step(params, cfg, toks[:, t:t + 1], cache,
                                        pos)
        rel = float((full - step).abs().max() / full.abs().max())
        top1 = bool(torch.equal(full.argmax(-1), step.argmax(-1)))
        check(top1 and rel <= 1e-3, f"{arch} prefill vs decode: top-1 "
              f"equal {top1}, rel diff {rel}")
        print(f"[lm-decode] {arch} f32 full width, 4 of "
              f"{CFG.get_config(arch).num_layers} layers (cut), 64 tokens: "
              f"prefill == decode, top-1 equal, max|diff|/max|logit| "
              f"{rel!r}")
        del params, cache


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.simstep import simstep

    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[header] kernels built in {time.perf_counter() - t0!r} s: "
          f"{built}")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name):
            print(f"[header] {name}: {line}")
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    # the tensor-core kernel must neither spill nor have its wgmma
    # serialized by ptxas (which it does, e.g., for a call in the kernel);
    # read from the log saved beside the library, built now or before
    tc = [line for line in _build.ptxas_report("flash_attention")
          if "flash_wgmma_kernel" in line]
    serial = [line.strip() for line in
              _build.build_log("flash_attention").splitlines()
              if "wgmma" in line and "serializ" in line]
    for line in serial:
        print(f"[header] flash_attention: {line}")
    check(len(tc) == len(HEAD_DIMS) and not serial and all(
        " 0 bytes spill stores" in line for line in tc),
        f"the tensor-core flash kernel spills, is serialized or is "
        f"missing: {tc} {serial}")

    record = phase_kernels(device)
    phase_agreement(device)

    # the simulator's main paths: phases 3, 4 and 4b, then each of 6-9;
    # simstep's count is set to 0 just before each and read just after
    simstep.launches = 0
    phase_section5(device, card)
    phase_scale(device, card)
    phase_skewed(device, card)
    launched = {"section5": simstep.launches}
    phase_leap(device, card, launched)
    phase_grid(device, card, launched)
    phase_lanes(device, card, launched)
    phase_simulate(device, card, launched)
    phase_s5_dynamic(device, card, launched)
    phase_migration(device, card, launched)
    phase_s5_networked(device, card, launched)
    phase_dyn_lanes(device, card, launched)
    phase_stream_s5(device, card, launched)
    phase_stream_tight(device, card, launched)
    phase_stream_poisson(device, card, launched)
    phase_stream_lanes(device, card, launched)
    phase_s5_elastic(device, card, launched)
    phase_s5_probed(device, card, launched)
    phase_policy_search(device, card, launched)
    phase_elastic_stream_lanes(device, card, launched)
    phase_intercloud(device, card, launched)
    phase_dispatch(device, card, launched)
    phase_pass_cost(device, card)
    for path, n in launched.items():
        check(n > 0, f"simstep never launched on the {path} path")
    record["launches"] = sum(launched.values())
    record["launches_by_path"] = launched
    phase_profile(device, card)

    # the LM slice compares f32 results: no TF32 in products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_records = phase_lm_kernels(device)
    phase_lm_agreement(device)
    launched = {r["name"]: 0 for r in lm_records}
    phase_lm_main(device, card, launched)
    for r in lm_records:
        r["launches"] = launched[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never launched on the main "
              f"path")
    phase_lm_prefill_vs_decode(device)

    print(json.dumps({"kernels": [record, *lm_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
