"""Fault-tolerance runtime: preemption handling, heartbeat watchdog,
straggler detection, elastic remesh.

On a real multi-pod fleet these hooks connect to the cluster manager
(preemption notice -> checkpoint-and-exit; missing heartbeat -> restart the
slice; persistent straggler -> cordon the host and elastic-resume on the
survivors). All mechanisms are implemented and unit-tested here; the
cluster-manager RPCs are the only stubs.

The reference's ``runtime/fault_tolerance.py``: pure Python and numpy,
without the reference's unused JAX import, and with the heartbeat
written atomically.  The elastic remesh (``runtime/elastic.py``) is mesh
code and not ported.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag the train loop polls; the loop then
    checkpoints and exits cleanly (checkpoint-on-preempt)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                pass  # non-main thread (tests)

    def _on_signal(self, signum, frame):
        self._flag.set()

    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:  # for tests / manual drain
        self._flag.set()


class Heartbeat:
    """Writes a heartbeat file every interval; a cluster watchdog (or the
    included `stale` check) treats a stale heartbeat as a hung/dead host."""

    def __init__(self, path: str | Path, interval_s: float = 10.0):
        self.path = Path(path)
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        tmp = self.path.with_name(self.path.name + ".tmp")
        while not self._stop.is_set():
            # written aside and renamed: a reader never sees the file
            # truncated and not yet written, which would read as stale
            tmp.write_text(str(time.time()))
            os.replace(tmp, self.path)
            self._stop.wait(self.interval)

    def stale(self, timeout_s: float | None = None) -> bool:
        timeout = timeout_s or 3 * self.interval
        try:
            return time.time() - float(self.path.read_text()) > timeout
        except (FileNotFoundError, ValueError):
            return True

    def stop(self):
        self._stop.set()
        self._thread.join()


class StragglerMonitor:
    """Tracks step durations; flags steps slower than `threshold` x the
    running median. On a fleet the flagged host would be cordoned and the
    job elastically resumed; here the detection + report are real, the
    cordon RPC is the stub."""

    def __init__(self, window: int = 64, threshold: float = 3.0):
        self.durations: deque = deque(maxlen=window)
        self.threshold = threshold
        self.flags: list[tuple[int, float, float]] = []

    def record(self, step: int, duration_s: float) -> bool:
        is_straggler = False
        if len(self.durations) >= 8:
            med = float(np.median(self.durations))
            if duration_s > self.threshold * med:
                self.flags.append((step, duration_s, med))
                is_straggler = True
        self.durations.append(duration_s)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.durations)) if self.durations else 0.0
