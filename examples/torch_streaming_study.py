"""Streaming study on the PyTorch port: window sizing against a diurnal
arrival trace (``examples/streaming_study.py``'s configurations, run
through ``repro_torch``'s ``run_stream``).

  1. One diurnal day (a raised-cosine rate, Ogata-thinned) through a
     48-slot window: occupancy tracks the rate, the backlog stays small.
  2. The same trace through windows of 8 to 64 slots: small windows
     serialize the peak; past the fleet's concurrency the window stops
     mattering.
  3. A bursty MMPP trace through 24 slots: the peak, not the mean, sizes
     the window.

The generators draw on the host from NumPy seeds, so the traces are the
JAX study's exactly; each line ends with the JAX study's numbers
(``examples/streaming_study.py`` on the CPU, printed with the same
format) in brackets.  The counts agree; the mean responses of the
narrow windows agree to within 0.7%: over ~11,600 time-shared events
both engines' f32 clocks meet near-ties that they (and the f64 oracle)
order differently, so single finish times part by a few seconds after
the first ~1,300 arrivals.  The runs take the leap off: the port gives
the same bits either way, and its streamed steps are cheaper without
it (about 3 minutes on a CPU).

    PYTHONPATH=src python examples/torch_streaming_study.py [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
import argparse

from repro_torch.core import state as S
from repro_torch.core import telemetry, workloads
from repro_torch.core.engine import run_stream

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# what examples/streaming_study.py prints for the same traces
JAX_DAY = dict(arrivals=5864, retired=5864, failed=0, makespan=3607,
               peak=48, backlog=9)
JAX_SWEEP = {8: (5197, 977.8, 8, 128), 16: (3607, 266.0, 16, 128),
             24: (3607, 89.8, 24, 128), 32: (3607, 24.5, 32, 119),
             48: (3607, 10.2, 48, 9), 64: (3607, 10.2, 59, 0)}
JAX_BURST = dict(arrivals=4871, retired=4871, peak=24, backlog=128,
                 makespan=3601)


def fleet(n_vms=24, n_hosts=6, window=48):
    hosts = S.make_uniform_hosts(n_hosts, pes=4, mips=1000.0, ram=8192.0,
                                 idle_w=93.7, peak_w=135.0, device=dev)
    vms = S.make_vms([1] * n_vms, [1000.0] * n_vms, [512.0] * n_vms,
                     [100.0] * n_vms, [1000.0] * n_vms, device=dev)
    return S.make_datacenter(hosts, vms, S.make_window(window, device=dev),
                             vm_policy=S.SPACE_SHARED,
                             task_policy=S.TIME_SHARED, device=dev)


def bar(x, scale, width=40):
    return "#" * min(width, int(round(x / scale * width)))


# 1. one diurnal day through a 48-slot window
DAY = 3600.0                       # a compressed "day" (seconds)
stream = workloads.diurnal_stream(7, 24, base_rate=0.3, peak_rate=3.0,
                                  period=DAY, horizon=DAY,
                                  length_mi=(1_000.0, 9_000.0), chunk=128,
                                  device=dev)
n_total = int((stream.vm >= 0).sum())
out, st, recs = run_stream(fleet(), stream, leap=False)
tl = telemetry.stream_timeline(recs)
summ = telemetry.summarize_stream_trace(recs)
print(f"# diurnal day: {n_total} arrivals, base 0.3/s -> peak 3.0/s "
      f"[JAX {JAX_DAY['arrivals']}]")
print(f"# retired={int(st.stats.n_retired)} failed={int(st.stats.n_failed)}"
      f" makespan={float(st.stats.makespan):.0f}s"
      f" peak_occupancy={summ['peak_occupancy']}"
      f" max_backlog={summ['max_backlog']} [JAX retired="
      f"{JAX_DAY['retired']} failed={JAX_DAY['failed']} makespan="
      f"{JAX_DAY['makespan']}s peak_occupancy={JAX_DAY['peak']} "
      f"max_backlog={JAX_DAY['backlog']}]")
print("# occupancy per chunk (each row ~one chunk of 128 arrivals):")
for t, occ in zip(tl["time"], tl["occupancy"]):
    print(f"  t={t:6.0f}s  occ={occ:3d} {bar(occ, 48)}")

# 2. window sweep: how much concurrency does the peak need?
print("\n# window sweep (same trace):")
print("W,makespan_s,mean_response_s,peak_occupancy,max_backlog  [JAX]")
for w in (8, 16, 24, 32, 48, 64):
    _, st_w, recs_w = run_stream(fleet(window=w), stream, leap=False)
    s = telemetry.summarize_stream_trace(recs_w)
    n_done = max(int(st_w.stats.n_retired), 1)
    mk, resp, peak, backlog = JAX_SWEEP[w]
    print(f"{w},{float(st_w.stats.makespan):.0f},"
          f"{float(st_w.stats.sum_response) / n_done:.1f},"
          f"{s['peak_occupancy']},{s['max_backlog']}  "
          f"[{mk},{resp},{peak},{backlog}]")

# 3. bursty MMPP traffic: the peak, not the mean, sizes the window
burst = workloads.mmpp_stream(11, 24, rate_low=0.3, rate_high=6.0,
                              mean_dwell_low=400.0, mean_dwell_high=90.0,
                              horizon=DAY, length_mi=(1_000.0, 9_000.0),
                              chunk=128, device=dev)
n_burst = int((burst.vm >= 0).sum())
_, st_b, recs_b = run_stream(fleet(window=24), burst, leap=False)
s = telemetry.summarize_stream_trace(recs_b)
print(f"\n# mmpp bursts: {n_burst} arrivals, 0.3/s quiet vs 6.0/s bursts "
      f"[JAX {JAX_BURST['arrivals']}]")
print(f"# W=24: retired={int(st_b.stats.n_retired)}"
      f" peak_occupancy={s['peak_occupancy']}"
      f" max_backlog={s['max_backlog']}"
      f" makespan={float(st_b.stats.makespan):.0f}s [JAX retired="
      f"{JAX_BURST['retired']} peak_occupancy={JAX_BURST['peak']} "
      f"max_backlog={JAX_BURST['backlog']} makespan="
      f"{JAX_BURST['makespan']}s]")
