"""The readers of the port's own spans and counters on a small canned
snapshot: the synchronized chain stage, the card's busy share inside
it, its spread over batches, the DP chunks' stream time and the
transfer counters. Each returns its value by hand, and nothing where
the snapshot lacks what it reads (a program without those spans)."""

import pytest

from benchmark import device, run
from conftest import BENCH

MS = 1_000_000


def span(name, batch, start_ms, end_ms):
    return {"id": 0, "name": name, "batch": batch, "parent": None,
            "thread": "MainThread", "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS)}


# four batches of 100 reads; chain_hits per batch: 40, 44, 50 and
# 60 ms (batch 3 in two spans), so 0.40, 0.44, 0.50, 0.60 ms a read
SPANS = [span("chain_hits", 0, 0, 40), span("dp_batch", 0, 40, 45),
         span("chain_hits", 1, 100, 144),
         span("chain_hits", 2, 200, 250),
         span("chain_hits", 3, 300, 330), span("chain_hits", 3, 400, 430)]
SNAP = {"wall_s": {"chain_hits": 0.194, "seed_chain_device": 0.25},
        "calls": {},
        "counters": {"h2d_bytes": 3 * 1024 * 400,
                     "d2h_bytes": 10 * 1024 * 400, "d2h_copies": 12},
        "device_s": {"dp_512x128": 0.004, "dp_1024x256": 0.006,
                     "other": 9.0},
        "spans": SPANS}
# device busy: [10, 20] and [15, 30] (one union of 20 ms) in batch 0's
# chain span, [140, 150] straddling batch 1's end (4 ms inside), and
# [42, 44] inside dp_batch only
DEVICE = [(10 * MS, 20 * MS, "a"), (15 * MS, 30 * MS, "b"),
          (140 * MS, 150 * MS, "c"), (42 * MS, 44 * MS, "d")]
CTX = {"stats": SNAP, "reads": 400, "device_spans": DEVICE,
       "window_ns": (0, 500 * MS), "device": device}


def read(name, ctx=CTX):
    return run.load_module(BENCH / "metrics" / f"{name}.py", name).read(ctx)


@pytest.mark.parametrize("name,want", [
    ("chaining.loop_ms_per_read", 1e3 * 0.194 / 400),
    # 20 + 4 ms busy of the chain spans' 40 + 44 + 50 + 60 = 194 ms
    ("chaining.device_busy_pct", 100 * 24 / 194),
    # statistics.quantiles([0.40, 0.44, 0.50, 0.60], n=4) is
    # (0.41, 0.47, 0.575)
    ("chaining.batch_spread_pct", 100 * (0.575 - 0.41) / 0.47),
    ("dp.device_ms_per_read", 1e3 * 0.010 / 400),
    ("transfers.h2d_kib_per_read", 3.0),
    ("transfers.d2h_kib_per_read", 10.0),
])
def test_span_reader_arithmetic(name, want):
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("name,key", [
    ("chaining.loop_ms_per_read", "wall_s"),
    ("chaining.device_busy_pct", "spans"),
    ("chaining.batch_spread_pct", "spans"),
    ("dp.device_ms_per_read", "device_s"),
    ("transfers.h2d_kib_per_read", "counters"),
    ("transfers.d2h_kib_per_read", "counters"),
])
def test_span_reader_without_its_key_returns_nothing(name, key):
    """The parent program's snapshot has no spans and no device_s, and
    no transfer counters; an empty wall_s has no chain_hits."""
    stats = {k: v for k, v in SNAP.items() if k != key}
    if key in ("wall_s", "counters"):
        stats[key] = {}
    assert read(name, dict(CTX, stats=stats)) is None


def test_busy_share_without_a_device_trace_returns_nothing():
    assert read("chaining.device_busy_pct",
                dict(CTX, device_spans=[])) is None


def test_spread_needs_two_batches():
    one = dict(SNAP, spans=SPANS[:2])
    assert read("chaining.batch_spread_pct", dict(CTX, stats=one)) is None
