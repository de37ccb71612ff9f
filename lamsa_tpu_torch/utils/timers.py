"""The port's span and counter recorder.

Every pipeline stage opened with ``GLOBAL.stage(name)`` records a span:

  name      the stage's name
  batch     the batch id of the thread that opened it (``batch``), or None
  parent    the id of the span it was opened inside, on the same thread
  thread    the name of that thread
  start_ns / end_ns   integer ns of ``time.time_ns()``

``time.time_ns()`` is the clock torch.profiler stamps its host events
with, so spans and a profiler's device trace share one timeline. Spans
go into a buffer of at most SPAN_LIMIT; once it is full, later spans
are not kept, but still add to the sums. Beside the spans the recorder
keeps, per name, the seconds and calls of the stages (summed from the
same stamps), the counters of ``count``, and the device seconds of
``add_device`` (measured with CUDA events by the caller). Updates take
a lock: DP collects and ``-t N`` finalize run on threads of their own.

``stage`` is looked up on the instance, so a caller may shadow it there
with a one-argument function that wraps the class's (a profiler range
around each stage).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict

SPAN_LIMIT = 65_536

_now = time.time_ns


class StageStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._wall_ns = defaultdict(int)
        self.calls = defaultdict(int)
        self.counters = defaultdict(int)
        self.device_s = defaultdict(float)
        self._spans: list[tuple] = []

    @property
    def wall(self) -> dict:
        """Seconds per stage name."""
        return {k: v / 1e9 for k, v in self._wall_ns.items()}

    def _stack(self) -> list:
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack = []
        return loc.stack

    def current_batch(self):
        """The calling thread's batch id (None outside a batch)."""
        return getattr(self._local, "batch", None)

    @contextlib.contextmanager
    def batch(self, batch_id):
        """Spans the calling thread opens inside carry ``batch_id``."""
        prev = self.current_batch()
        self._local.batch = batch_id
        try:
            yield
        finally:
            self._local.batch = prev

    @contextlib.contextmanager
    def stage(self, name: str):
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = _now()
        try:
            yield
        finally:
            t1 = _now()
            stack.pop()
            span = (sid, name, self.current_batch(), parent,
                    threading.current_thread().name, t0, t1)
            with self._lock:
                self._wall_ns[name] += t1 - t0
                self.calls[name] += 1
                if len(self._spans) < SPAN_LIMIT:
                    self._spans.append(span)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def add_device(self, name: str, seconds: float):
        """Add device seconds under ``name`` (``device_s`` of the
        snapshot)."""
        with self._lock:
            self.device_s[name] += seconds

    def reset(self):
        with self._lock:
            self._wall_ns.clear()
            self.calls.clear()
            self.counters.clear()
            self.device_s.clear()
            self._spans.clear()

    def snapshot(self, spans: bool = True) -> dict:
        """Sums, counters and device seconds, and with ``spans`` the
        buffer's spans as dicts, in the order they closed."""
        with self._lock:
            snap = {
                "wall_s": dict(sorted(((k, v / 1e9)
                                       for k, v in self._wall_ns.items()),
                                      key=lambda kv: -kv[1])),
                "calls": dict(self.calls),
                "counters": dict(self.counters),
                "device_s": dict(self.device_s),
            }
            kept = list(self._spans) if spans else None
        if spans:
            snap["spans"] = [
                {"id": s[0], "name": s[1], "batch": s[2], "parent": s[3],
                 "thread": s[4], "start_ns": s[5], "end_ns": s[6]}
                for s in kept]
        return snap

    def report(self) -> str:
        wall = self.wall
        total = sum(wall.values())
        lines = []
        for k, v in sorted(wall.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<28s} {v:8.3f}s {100*v/max(total,1e-9):5.1f}%"
                         f"  x{self.calls[k]}")
        for k, v in sorted(self.counters.items()):
            lines.append(f"  {k:<28s} {v}")
        return "\n".join(lines)


GLOBAL = StageStats()
