"""The paper's tables and figures computed by the port
(``benchmarks/paper_tables.py``'s counterpart, inside the package), the
roofline over the dry run's records (``roofline.py``, ``report.py``),
which time nothing, and the load generator over the slot loops with its
trajectory of ``BENCH_<n>.json`` documents (``loadgen.py``,
``trajectory.py``)."""
