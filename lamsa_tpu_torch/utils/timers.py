# Copy of lamsa_tpu/utils/timers.py; only its import lines differ.
"""Per-stage observability.

The reference had only stderr progress printfs (SURVEY.md section 5);
here every pipeline stage is timed and counted so reads/s, Gcells/s and
stage breakdowns are first-class outputs (cells/s is a scored metric,
BASELINE.json:2). Zero-dependency, ~zero overhead when disabled.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class StageStats:
    def __init__(self):
        self.wall = defaultdict(float)
        self.calls = defaultdict(int)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wall[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def reset(self):
        self.wall.clear()
        self.calls.clear()
        self.counters.clear()

    def snapshot(self) -> dict:
        return {
            "wall_s": dict(sorted(self.wall.items(),
                                  key=lambda kv: -kv[1])),
            "calls": dict(self.calls),
            "counters": dict(self.counters),
        }

    def report(self) -> str:
        total = sum(self.wall.values())
        lines = []
        for k, v in sorted(self.wall.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<28s} {v:8.3f}s {100*v/max(total,1e-9):5.1f}%"
                         f"  x{self.calls[k]}")
        for k, v in sorted(self.counters.items()):
            lines.append(f"  {k:<28s} {v}")
        return "\n".join(lines)

    def jsonl(self) -> str:
        return json.dumps(self.snapshot())


GLOBAL = StageStats()
