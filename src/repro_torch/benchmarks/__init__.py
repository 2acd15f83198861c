"""The paper's tables and figures computed by the port
(``benchmarks/paper_tables.py``'s counterpart, inside the package), and
the roofline over the dry run's records (``roofline.py``, ``report.py``),
which time nothing."""
