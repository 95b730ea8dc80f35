"""Benchmark of the PyTorch + CUDA package ``repro_torch`` on one H100.

One command runs one cell once (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``) and prints one JSON line.
Everything that belongs to a cell is found by name:

  * ``BENCHMARK.json`` (the repository root): the cells, their
    configuration and traffic, and the metrics each reports;
  * ``portbench/configs/<config>.json``: the sizes, precision and codec;
  * ``portbench/traffic/<traffic>.json``: the traffic mix, which names the
    runner (``portbench/runners/<runner>.py``) that runs it;
  * ``portbench/limits/<cell>.json``: the limit of each number that
    decides ``correct``;
  * ``portbench/metrics/<metric>.py``: one reader per per-layer metric.

The yardstick lives here and never in the program: the peaks
(``peaks.py``), the operation and byte counts (``counts.py``), the
reduction of a profiler trace (``traceread.py``), the batch order
(``batches.py``), the comparison (``check.py``) and the plain reference
(``reference/``), which imports nothing of the program.
"""
