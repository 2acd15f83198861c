"""Runtime support of the train loop: preemption, heartbeat and straggler
detection (``fault_tolerance.py``), and elastic meshes and resharding
(``elastic.py``)."""
