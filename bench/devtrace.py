"""The device trace of a ``--trace 1`` run, and the host's spans beside it.

``torch.profiler`` records the card's activity (kernels, memory copies and
fills) over the traced window; CPU operators are not recorded, so the
host's cost of tracing stays small.  The harness records its own spans on
the host (``Spans``) around the calls it makes into the program, on the
same clock as the profiler's timestamps (``time.time_ns``), so an idle gap
on the card can be named by what the host was doing through it.
"""

from __future__ import annotations

import time

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """The harness's host spans: (name, start_ns, end_ns)."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple[str, int, int]] = []

    def add(self, name: str, start_ns: int) -> None:
        if self.on:
            self.items.append((name, start_ns, time.time_ns()))


def _kind(event) -> str | None:
    """The device activity of a profiler event, or None for host events."""
    if event.device_type() != torch.autograd.DeviceType.CUDA:
        return None
    kind = event.activity_type() if hasattr(event, "activity_type") else None
    if kind is None:
        name = event.name()
        kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return kind if kind in DEVICE_KINDS else None


class DeviceTrace:
    """The profiler around one window: ``start`` it during set-up (its
    first start takes seconds), mark the window with ``open`` and
    ``close``, then ``stop``, after which ``ops`` holds every device
    operation that overlaps the window as (name, start_ns, end_ns)."""

    def __init__(self):
        self.ops: list[tuple[str, int, int]] = []
        self.t0 = self.t1 = 0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def open(self) -> None:
        self.t0 = time.time_ns()

    def close(self) -> None:
        self.t1 = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            if _kind(e) is not None and e.end_ns() > self.t0 \
                    and e.start_ns() < self.t1:
                self.ops.append((e.name(), e.start_ns(), e.end_ns()))
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        out: list[list[int]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def time_s(self, substring: str) -> tuple[float, int]:
        """(seconds, count) of the operations whose name holds
        ``substring``."""
        hit = [(e - s) for name, s, e in self.ops if substring in name]
        return sum(hit) / 1e9, len(hit)

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each named by the host span that covered most
        of it (``none`` where the harness had no span open)."""
        by_name: dict[str, float] = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0] + [t for iv in busy for t in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            cover: dict[str, int] = {}
            for name, a, b in spans.items:
                overlap = min(b, e) - max(a, s)
                if overlap > 0:
                    cover[name] = cover.get(name, 0) + overlap
            label = max(cover, key=cover.get) if cover else "none"
            named.append([label, (e - s) / 1e9])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
