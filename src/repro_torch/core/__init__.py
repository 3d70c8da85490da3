"""The simulator core in PyTorch (``repro.core`` ported: the static,
dynamic, networked and streamed paths).

  state.py         entity model (Datacenter/Host/VM/Cloudlet/Market)
  convert.py       leaf-by-leaf state conversion to and from other packages
  energy.py        host power models + exact event-timeline energy (J)
  metrics.py       the inert metrics plane a state carries
  segments.py      grouped-segment primitives (ranks/cumsums/mins per run)
  scheduling.py    two-level space/time-shared shares (Fig. 3 2x2)
  provisioning.py  VMProvisioner + admission (first/best/worst-fit, ...)
  engine.py        discrete-event engine: full steps, the event table,
                   the event-horizon leap, batched runs over lanes,
                   streamed runs (``run_stream``)
  streaming.py     admission and retirement of streamed windows
  workloads.py     NumPy-seeded streamed arrival processes
  migration.py     live migration: THRESHOLD / DRAIN, delay, joules
  network.py       staged transfers as fair-shared flows, routed copies
  sweep.py         stacked scenario batches and fused policy grids
  broker.py        DatacenterBroker builders, collection, VM destruction
  market.py        §3.3 cost model: quotes, bills, surge pricing
  telemetry.py     NumPy reducers of run_trace's records
"""
