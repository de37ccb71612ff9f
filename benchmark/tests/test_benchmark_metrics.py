"""The per-layer readers and the trace arithmetic on a canned STATS
snapshot and a canned list of device spans."""

import pytest

from benchmark import device, run
from conftest import BENCH

SNAP = {"wall_s": {"seed_chain_device": 6.0, "seed_hits": 1.0,
                   "chain_hits": 4.5, "skeleton_host": 0.5,
                   "dp_batch": 0.8, "finalize_host": 0.4},
        "calls": {},
        "counters": {"dp_cells_512x128": 3_000_000,
                     "dp_cells_1024x256": 1_000_000, "dp_instances": 40,
                     "reads": 1000}}
MS = 1_000_000
SPANS = [(0, 2 * MS, "void (anonymous namespace)::kernel<128>(int const*)"),
         (1 * MS, 3 * MS, "void at::native::vectorized_elementwise_kernel"
                          "<4, at::native::where>(int, T)"),
         (5 * MS, 6 * MS, "void (anonymous namespace)::kernel<64>(int)"),
         (8 * MS, 9 * MS, "traceback_row_kernel(int const*)")]
CTX = {"stats": SNAP, "reads": 1000, "device_spans": SPANS,
       "window_ns": (0, 10 * MS), "device": device,
       "untraced_reads": 3072, "untraced_s": 12.0}


def read(name, ctx=CTX):
    return run.load_module(BENCH / "metrics" / f"{name}.py", name).read(ctx)


@pytest.mark.parametrize("name,want", [
    ("entry.reads_per_s", 256.0),
    ("seeding.ms_per_read", 1.0),
    ("chaining.ms_per_read", 5.0),
    ("skeleton.ms_per_read", 0.5),
    ("dp.ms_per_read", 0.8),
    ("finalize.ms_per_read", 0.4),
    ("dp.cells_per_read", 4000.0),
    # 4e6 cells x 12 ops / 16.7e12 ops/s = 2.874 us over the fills' 3 ms
    ("kernels.dp_fill_roofline_pct",
     100 * 12 * 4e6 / (132 * 64 * 1.98e9) / 3e-3),
    # busy: [0, 3] + [5, 6] + [8, 9] ms = 5 of 10 ms
    ("device.idle_pct", 50.0),
])
def test_reader_arithmetic(name, want):
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", [p.stem for p in
                                  (BENCH / "metrics").glob("*.py")])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = {"stats": {"wall_s": {}, "calls": {}, "counters": {}},
             "reads": 0, "device_spans": [], "window_ns": (0, 0),
             "device": device}
    assert read(name, empty) is None


def test_fill_kernels_are_told_from_torchs_and_the_walkers():
    mod = run.load_module(BENCH / "metrics"
                          / "kernels.dp_fill_roofline_pct.py", "k")
    assert mod.FILL.search(SPANS[0][2]) and mod.FILL.search(SPANS[2][2])
    assert not mod.FILL.search(SPANS[1][2])
    assert not mod.FILL.search(SPANS[3][2])
    assert not mod.FILL.search("void at::native::reduce_kernel<512, 1>(R)")


def test_bound_is_the_larger_of_ops_and_bytes():
    assert device.fill_bound_s(10**9) == pytest.approx(
        12e9 / device.INT32_OPS_PER_S)
    assert device.INT32_OPS_PER_S == pytest.approx(16.72704e12)


def test_idle_gaps_by_the_innermost_stage():
    spans = [(0, 10, "a"), (20, 30, "b"), (50, 60, "c")]
    gaps = device.idle_gaps(spans, 0, 100)
    assert gaps == [(10, 20), (30, 50), (60, 100)]
    stages = [("outer", 0, 100), ("inner", 25, 55)]
    got = dict(device.gaps_by_stage(gaps, stages))
    assert got == {"outer": pytest.approx(50e-9),
                   "inner": pytest.approx(20e-9)}
    assert device.gaps_by_stage([(0, 10)], []) == [("no stage", 1e-8)]
    assert device.busy_s(spans) == pytest.approx(30e-9)


def test_top_ops_sums_by_name():
    got = device.top_ops([(0, 10, "x"), (20, 25, "y"), (30, 40, "x")], 1)
    assert got == [("x", pytest.approx(20e-9))]
