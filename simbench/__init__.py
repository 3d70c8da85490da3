"""The benchmark of the PyTorch port's simulator (``repro_torch``).

``python3 simbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA
card and prints one JSON line.  Everything a cell needs is found by
name: its configuration in ``configs/``, its traffic mix in
``traffic/``, its limits in ``workloads/``, the driver of the
configuration's kind in ``drivers/``, and one reader a metric in
``metrics/``.  The plain reference that decides ``correct`` lives in
``reference/`` and imports nothing of the program.
"""
