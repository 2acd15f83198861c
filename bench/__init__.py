"""The benchmark of ``repro_torch``: the RSNN slot loop on one NVIDIA H100.

``bench/run.py`` runs one cell of ``BENCHMARK.json`` (a configuration
under a traffic mix) and prints one JSON result line.  Everything that
belongs to one configuration, one traffic mix or one per-layer metric is a
file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py``.  ``reference/`` holds
the yardstick that no later change to the program moves: the seeded
weights and features, the plain RSNN reference, the comparison that
decides ``correct``, and the kernel byte and operation counts.
"""
