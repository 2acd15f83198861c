"""Slot-based continuous-batching bookkeeping.

``serving/stream.py``'s ``StreamLoop`` packs a queue of variable-length
audio streams into a fixed batch of ``batch_slots`` rows and refills a
finished slot from the queue without stopping the batch.
``SlotScheduler`` owns the submit queue, the slot -> request table with
per-slot progress cursors, refill, and the finished list; what a step
means and where the batch lives stay with the subclass, which hooks
``_on_slot_filled`` for data placement.  Plain Python and numpy: the
reference's scheduler, unchanged, so refill order is identical.
"""

from __future__ import annotations

import collections
from typing import Any

import numpy as np


class SlotScheduler:
    """Queue/slot/finished bookkeeping for continuous batching.

    Requests are any objects with a ``done`` attribute; they enter via
    ``_enqueue``, occupy a slot from ``_refill`` until ``_finish_slot``,
    and end in ``finished`` in completion order.
    """

    def __init__(self, batch_slots: int):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        self.slots = batch_slots
        # deque, not list: refill pops from the head once per freed slot, and
        # a load generator keeps thousands of streams queued — list.pop(0)
        # is O(queue) per pop (quadratic over a backlog), popleft() is O(1)
        self.queue: collections.deque[Any] = collections.deque()
        self.finished: list[Any] = []
        self.slot_req: list[Any | None] = [None] * batch_slots
        self.slot_pos = [0] * batch_slots
        self._next_sid = 0

    def _new_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    def _refill(self) -> None:
        """Fill every empty slot from the queue (FIFO), resetting its cursor
        and giving the subclass a chance to place the request's data."""
        for i in range(self.slots):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[i] = req
                self.slot_pos[i] = 0
                self._on_slot_filled(i, req)

    def _on_slot_filled(self, i: int, req: Any) -> None:
        """Hook: a request was just placed into slot ``i`` (e.g. reset the
        slot's recurrent state, pin its frames on device)."""

    def _finish_slot(self, i: int) -> Any:
        """Mark slot ``i``'s request done, move it to ``finished``, and free
        the slot for refill."""
        req = self.slot_req[i]
        req.done = True
        self.finished.append(req)
        self.slot_req[i] = None
        return req

    def active_mask(self) -> np.ndarray:
        """(slots,) bool: which slots currently hold a request."""
        return np.array([r is not None for r in self.slot_req], bool)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)
