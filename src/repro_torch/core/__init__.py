"""The simulator core in PyTorch (``repro.core`` ported: the static,
dynamic, networked, streamed, elastic and probed paths, and federation).

  state.py         entity model (Datacenter/Host/VM/Cloudlet/Market)
  convert.py       leaf-by-leaf state conversion to and from other packages
  energy.py        host power models + exact event-timeline energy (J)
  metrics.py       the in-run metrics plane (bucketed timelines,
                   retirement histograms, SLA watermarks)
  segments.py      grouped-segment primitives (ranks/cumsums/mins per run)
  scheduling.py    two-level space/time-shared shares (Fig. 3 2x2)
  provisioning.py  VMProvisioner + admission (first/best/worst-fit, ...)
  engine.py        discrete-event engine: full steps, the event table,
                   the autoscaler and spot accrual, the probes, the
                   event-horizon leap, batched runs over lanes,
                   streamed runs (``run_stream``)
  streaming.py     admission and retirement of streamed windows
  workloads.py     arrival processes: generator-drawn resident blocks,
                   NumPy-seeded streams
  migration.py     live migration: THRESHOLD / DRAIN, delay, joules
  network.py       staged transfers as fair-shared flows, routed copies
  sweep.py         stacked scenario batches, fused policy grids, the
                   autoscaler policy search and the lane dispatcher
                   over a list of devices
  cis.py           Cloud Information Service: registry rows, matching
  federation.py    user routing over the registry, federated runs
  experiments.py   inter-cloud policy studies; elasticity studies: SLA
                   violations, Pareto fronts
  broker.py        DatacenterBroker builders, collection, VM destruction
  market.py        §3.3 cost model: quotes, bills, surge pricing, spot
  telemetry.py     NumPy reducers of run_trace's records and of the
                   metrics plane
"""
