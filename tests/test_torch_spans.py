"""The port's span and counter recorder (lamsa_tpu_torch/utils/timers.py)
and the spans and counters the pipeline puts into it: span fields,
batch ids across threads, exact sums under load, the bounded buffer,
the clock shared with torch.profiler, the benchmark's stage shadow, the
FM seeding parts' spans and counters, and on the card the synchronized
chain stage, DP and FM device seconds and the transfer counters. The file imports no JAX; its ``cuda`` test runs on
the card with

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""

import sys
import threading

import numpy as np
import pytest
import torch

from lamsa_tpu_torch.utils import timers
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
from lamsa_tpu_torch.utils.timers import SPAN_LIMIT, StageStats

torch.set_num_threads(1)


def _by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_span_fields():
    """Each span carries its name, its thread's batch id, the span it
    was opened inside (on its own thread) and its thread's name, with
    integer ns stamps; sums and spans agree."""
    st = StageStats()
    with st.stage("outer"):
        with st.batch(7):
            with st.stage("inner"):
                pass
        with st.stage("after"):
            pass

    def worker():
        with st.batch(9), st.stage("on_thread"):
            pass
    t = threading.Thread(target=worker, name="span-worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()

    snap = st.snapshot()
    assert set(snap) == {"wall_s", "calls", "counters", "device_s", "spans"}
    sp = {s["name"]: s for s in snap["spans"]}
    assert set(sp) == {"outer", "inner", "after", "on_thread"}
    outer = sp["outer"]
    assert outer["parent"] is None and outer["batch"] is None
    assert sp["inner"]["parent"] == outer["id"] and sp["inner"]["batch"] == 7
    assert sp["after"]["parent"] == outer["id"] and sp["after"]["batch"] \
        is None                                  # the batch was restored
    on = sp["on_thread"]
    assert (on["parent"], on["batch"], on["thread"]) == \
        (None, 9, "span-worker")
    assert outer["thread"] == threading.current_thread().name
    for s in snap["spans"]:
        assert isinstance(s["start_ns"], int) and s["end_ns"] >= s["start_ns"]
        assert snap["wall_s"][s["name"]] == (s["end_ns"] - s["start_ns"]) / 1e9
        assert snap["calls"][s["name"]] == 1
    assert outer["start_ns"] <= sp["inner"]["start_ns"] \
        <= sp["inner"]["end_ns"] <= outer["end_ns"]
    assert "spans" not in st.snapshot(spans=False)


def test_exact_sums_under_load(monkeypatch):
    """8 threads x 10,000 stages and counts, with a short switch
    interval: a lost update would leave a sum short. Each thread's clock
    is its own and ticks 500 ns a read, so every span lasts 500 ns."""
    st = StageStats()
    clock = threading.local()

    def now():
        clock.t = getattr(clock, "t", 0) + 500
        return clock.t
    monkeypatch.setattr(timers, "_now", now)
    n_threads, n = 8, 10_000

    def worker():
        for _ in range(n):
            with st.stage("s"):
                st.count("c")
            st.count("bytes", 3)
            st.add_device("d", 0.5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = st.snapshot(spans=False)
    total = n_threads * n
    assert snap["calls"] == {"s": total}
    assert snap["wall_s"] == {"s": total * 500 / 1e9}
    assert snap["counters"] == {"c": total, "bytes": 3 * total}
    assert snap["device_s"] == {"d": 0.5 * total}


def test_the_buffer_stops_at_its_bound_and_reset_empties_it():
    st = StageStats()
    for _ in range(SPAN_LIMIT + 10):
        with st.stage("x"):
            pass
    st.count("c")
    st.add_device("d", 1.0)
    snap = st.snapshot()
    assert len(snap["spans"]) == SPAN_LIMIT
    assert snap["calls"]["x"] == SPAN_LIMIT + 10       # sums go on
    ids = [s["id"] for s in snap["spans"]]
    assert ids == sorted(ids) and len(set(ids)) == SPAN_LIMIT
    st.reset()
    assert st.snapshot() == {"wall_s": {}, "calls": {}, "counters": {},
                             "device_s": {}, "spans": []}
    with st.stage("y"):
        pass
    assert [s["name"] for s in st.snapshot()["spans"]] == ["y"]


def test_spans_share_the_profilers_clock():
    """A span and a torch.profiler range opened together start within
    1 ms of each other, and the span lies inside its range: spans and a
    trace's events are on one clock. A process's first profiler session
    stamps its first range up to about 1 ms late, so one session is
    opened and closed before the measured one."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("stage:throwaway"):
            torch.ones(64).sum()
    st = StageStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with record_function(f"stage:clock{i}"), st.stage(f"clock{i}"):
                torch.ones(64).sum()
    rng = {e.name()[6:]: (e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("stage:clock")}
    spans = {s["name"]: (s["start_ns"], s["end_ns"])
             for s in st.snapshot()["spans"]}
    assert set(rng) == set(spans) == {f"clock{i}" for i in range(5)}
    for name, (t0, t1) in spans.items():
        r0, r1 = rng[name]
        assert abs(t0 - r0) < 1_000_000, (name, t0 - r0)
        assert r0 <= t0 <= t1 <= r1, (name, t0 - r0, r1 - t1)


def test_the_benchmarks_stage_shadow_still_wraps_the_stages():
    """benchmark/run.py StageTrace replaces ``stage`` on the instance
    with a one-argument function: each stage opens its profiler range
    and still records its span; on exit the class's method is back."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.run import StageTrace
    st = StageStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with StageTrace(st):
            with st.stage("shadowed"), st.stage("inner"):
                pass
    assert "stage" not in vars(st)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"stage:shadowed", "stage:inner"} <= names
    sp = _by_name(st.snapshot())
    assert sp["inner"][0]["parent"] == sp["shadowed"][0]["id"]


@pytest.fixture(scope="module")
def tiny_world():
    """A 60 kb genome and 12 reads of 1-2.5 kb, a fifth of them split."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference
    rng = np.random.default_rng(20261018)
    genome = sim.random_genome(rng, 60_000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    reads = sim.simulate_reads(rng, genome, 12, read_len=(1000, 2500),
                               sv_fraction=0.2)
    cfg = AlignConfig(scores=ScoreParams(match=1, mismatch=3, gap_open=2,
                                         gap_ext=1), seed_step=10)
    return ref, KmerIndex.build(codes, 13), cfg, reads


def test_batch_ids_across_threads(tiny_world):
    """Two align_batch calls carry two batch ids on every span they
    open; the DP collects, on the dp-collect pool's threads, carry the
    id of their own batch and lie inside its dp_batch span. On the CPU
    no copy is counted and no device second is added."""
    from lamsa_tpu_torch.pipeline.aln import Aligner
    ref, idx, cfg, reads = tiny_world
    aligner = Aligner(ref, idx, cfg, device="cpu")
    STATS.reset()
    aligner.align_batch(reads[:6])
    aligner.align_batch(reads[6:])
    snap = STATS.snapshot()
    spans = snap["spans"]
    ids = sorted({s["batch"] for s in spans})
    assert len(ids) == 2 and None not in ids
    by = _by_name(snap)
    for name in ("seed_chain_device", "seed_hits", "chain_hits",
                 "skeleton_host", "dp_batch", "finalize_host"):
        assert {s["batch"] for s in by[name]} == set(ids), name
    collects = [s for s in spans if s["name"].startswith("dp_collect_")]
    assert collects
    assert all(s["thread"].startswith("dp-collect") for s in collects)
    assert {s["batch"] for s in collects} == set(ids)
    dp = {s["batch"]: s for s in by["dp_batch"]}
    for s in collects:
        d = dp[s["batch"]]
        assert d["start_ns"] <= s["start_ns"] <= s["end_ns"] <= d["end_ns"]
    # chain_hits sits inside seed_hits' parent, seed_chain_device
    scd = {s["id"] for s in by["seed_chain_device"]}
    assert all(s["parent"] in scd for s in by["chain_hits"])
    assert not {"h2d_bytes", "d2h_bytes", "d2h_copies"} & set(
        snap["counters"])
    assert snap["device_s"] == {}
    assert snap["counters"]["reads"] == 12


@pytest.fixture(scope="module")
def fm_world():
    """An 80 kb genome in the FM index and 6 reads of 1.5-3 kb at 24%
    error, noisy enough that the adaptive re-seed runs with the 1-edit
    variant tracks."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams
    from lamsa_tpu_torch.index.fmindex import FmIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference
    rng = np.random.default_rng(20261019)
    genome = sim.random_genome(rng, 80_000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    reads = sim.simulate_reads(rng, genome, 6, read_len=(1500, 3000),
                               sub=0.08, ins=0.08, dele=0.08)
    cfg = AlignConfig(scores=ScoreParams(match=1, mismatch=3, gap_open=5,
                                         gap_ext=2), seed_step=10)
    return ref, FmIndex.build(codes), cfg, reads


def test_fm_spans_nest_under_seed_hits_and_count(fm_world, monkeypatch):
    """On the FM backend every seed_hits stage holds one fm_search and
    one fm_resolve span, and the re-seed's one fm_1edit span; the
    counters count the rows resolved (the valid hits seed_hits_fm
    returns) and the variant tracks searched (window x track x strand).
    On the CPU no device second is added."""
    from lamsa_tpu_torch.pipeline import aln, seeding
    ref, idx, cfg, reads = fm_world
    rows, tracks = [], []
    real = aln.seed_hits_fm

    def spy(rc, lens, grid, st, **kw):
        hits = real(rc, lens, grid, st, **kw)
        rows.append(int(hits["valid"].sum()))
        if kw["sub1_cands"]:
            T = len(seeding.fmops.edit1_tracks(kw["sub1_k"],
                                               kw["sub1_kinds"])[0])
            tracks.append(2 * rc.shape[0] * grid.shape[0] * T)
        return hits
    monkeypatch.setattr(aln, "seed_hits_fm", spy)
    aligner = aln.Aligner(ref, idx, cfg, device="cpu")
    assert aligner.seed_backend == "fm"
    STATS.reset()
    aligner.align_batch(reads)
    snap = STATS.snapshot()
    by = _by_name(snap)
    seeds = {s["id"]: s for s in by["seed_hits"]}
    assert tracks, "the re-seed did not run"
    assert len(by["fm_search"]) == len(by["fm_resolve"]) == len(seeds)
    assert len(by["fm_1edit"]) == len(tracks)
    for name in ("fm_search", "fm_1edit", "fm_resolve"):
        for s in by[name]:
            p = seeds[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            assert s["batch"] == p["batch"] is not None
    for p in seeds.values():            # search, then variants, then resolve
        kids = sorted((s["start_ns"], s["name"]) for s in snap["spans"]
                      if s["parent"] == p["id"])
        assert [n for _t, n in kids][0] == "fm_search"
        assert [n for _t, n in kids][-1] == "fm_resolve"
    c = snap["counters"]
    assert c["fm_rows_resolved"] == sum(rows) > 0
    assert c["fm_1edit_tracks"] == sum(tracks) > 0
    assert snap["device_s"] == {}


def test_kmer_seeding_opens_no_fm_span(tiny_world):
    from lamsa_tpu_torch.pipeline.aln import Aligner
    ref, idx, cfg, reads = tiny_world
    STATS.reset()
    Aligner(ref, idx, cfg, device="cpu").align_batch(reads[:4])
    snap = STATS.snapshot()
    assert not {s["name"] for s in snap["spans"]} & {
        "fm_search", "fm_1edit", "fm_resolve"}
    assert not {"fm_rows_resolved", "fm_1edit_tracks", "anchor_subs"} & \
        set(snap["counters"])


@pytest.mark.cuda
def test_fm_device_seconds_on_the_card(fm_world):
    """On the card each FM part adds its stream time, from CUDA events
    read after seed_hits' synchronize, under its own name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lamsa_tpu_torch.pipeline.aln import Aligner
    ref, idx, cfg, reads = fm_world
    aligner = Aligner(ref, idx, cfg, device="cuda")
    aligner.align_batch(reads[:2])                      # warm
    STATS.reset()
    aligner.align_batch(reads)
    snap = STATS.snapshot()
    dev = snap["device_s"]
    assert {"fm_search", "fm_1edit", "fm_resolve"} <= set(dev)
    assert all(dev[k] > 0 for k in ("fm_search", "fm_1edit", "fm_resolve"))
    assert snap["calls"]["fm_search"] == snap["calls"]["seed_hits"]
    # each part's stream time lies within its seed_hits stages' wall
    assert dev["fm_search"] + dev["fm_1edit"] + dev["fm_resolve"] <= \
        snap["wall_s"]["seed_hits"]


@pytest.mark.cuda
def test_chain_stage_device_seconds_and_transfers_on_the_card(
        tiny_world, monkeypatch):
    """On the card: the chain_hits stage waits for the chain loop's
    kernels (a ~25 ms spin queued after the loop has to fall inside it),
    every DP chunk adds its stream time to device_s, and the transfer
    counters count the uploads and at least the chain planes' copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lamsa_tpu_torch.pipeline import aln
    from lamsa_tpu_torch.pipeline.aln import Aligner
    ref, idx, cfg, reads = tiny_world
    aligner = Aligner(ref, idx, cfg, device="cuda")
    aligner.align_batch(reads[:2])                      # warm
    real = aln.chain_hits

    def slow_chain(*a, **k):
        out = real(*a, **k)
        torch.cuda._sleep(50_000_000)                   # ~25 ms at 1.98 GHz
        return out
    monkeypatch.setattr(aln, "chain_hits", slow_chain)
    STATS.reset()
    aligner.align_batch(reads)
    torch.cuda.synchronize()
    snap = STATS.snapshot()
    chains = _by_name(snap)["chain_hits"]
    assert chains and all(s["end_ns"] - s["start_ns"] >= 20_000_000
                          for s in chains)
    dev = snap["device_s"]
    assert dev and all(k.startswith("dp_") and v > 0 for k, v in dev.items())
    assert set(dev) == {k.replace("dp_cells_", "dp_")
                        for k in snap["counters"]
                        if k.startswith("dp_cells_")}
    c = snap["counters"]
    planes = 3 * len(reads) * cfg.max_hits_per_read * 4
    assert c["d2h_bytes"] >= planes and c["d2h_copies"] >= 2
    assert c["h2d_bytes"] > sum(len(r.seq) for r in reads) // 2
