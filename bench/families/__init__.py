"""Model families: what a run does that depends on the kind of model.

A configuration's file names its family (``"family": "rsnn"``), and the
harness loads ``bench/families/<family>.py`` by that name, so a new
family is a new file.  The harness keeps what every family shares: the
cell's files, the card and the host, the window's length, the device
trace and the host spans, the memory peak, freeing the program before the
check, the per-layer readers and the result line.  A family module gives
four functions:

- ``build(cfg, mix, seed, device, timeline) -> setup``: checks the mix's
  keys it uses, draws the weights and inputs from the seed and builds the
  program, marking each part of set-up with ``timeline.phase(name)``.
  ``setup.program`` holds the system under test; the harness drops it
  once the window has closed and the memory peak is read.
- ``serve(setup, window, spans, timeline) -> served``: warms the program
  up (set-up too), calls ``window.settle()`` once set-up is done, then
  serves the mix for ``window.seconds``, calling ``window.open(t0, t1)``
  as the window opens (``t0`` on ``time.monotonic``) and
  ``window.close()`` as it closes, with ``spans`` (``devtrace.Spans``)
  around the calls into the program.  The window (``harness.Window``)
  starts and marks the device trace, waits for the card and freezes
  set-up's objects out of the collector's way; the harness refuses a run
  whose ``serve`` skipped one of its steps, and stops the trace once
  ``serve`` returns.  ``served.e2e`` holds the window's end-to-end values
  by metric name (all but ``setup_s``, which the harness takes from the
  window's opening), ``served.attempted`` the requests the window counts
  and ``served.failed`` those of them that got no answer.
- ``check(setup, served, limits, device) -> (checks, correct, failed)``:
  the window's answers against the family's plain reference, with the
  program's state freed: each number compared beside its limit from the
  cell's file (``{name: {"value", "limit"}}``), whether the run is
  correct, and the answers that were missing or wrong.
- ``context(setup, served) -> dict``: what the per-layer readers
  (``bench/metrics/<name>.py``) of the family's cells receive; the
  harness adds ``trace``, the device trace.
"""

from __future__ import annotations

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(name: str):
    """The family module ``bench/families/<name>.py``."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"family {name!r} is not a module name")
    return importlib.import_module(f"{__name__}.{name}")
