"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``bench/run.py`` runs one cell of ``BENCHMARK.json`` (a configuration
under a traffic mix) and prints one JSON result line.  Everything that
belongs to one model family, one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:
``families/<family>.py`` (named in the configuration's file),
``configs/<config>.json``, ``traffic/<mix>.json``, ``cells/<cell>.json``
(the check's limits) and ``metrics/<metric>.py``.  ``reference/`` holds
the RSNN family's yardstick that no later change to the program moves:
the seeded weights and features, the plain RSNN reference, the
comparison that decides ``correct``, and the kernel byte and operation
counts.
"""
