"""The paper's tables and figures computed by the port
(``benchmarks/paper_tables.py``'s counterpart, inside the package)."""
