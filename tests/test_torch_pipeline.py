"""The port's ``align_reads`` on the CPU.

``align_reads`` runs its batches one at a time, in order, on the
caller's thread, and a read's records do not depend on how the run is
cut into batches. Records at batch sizes 1, 5 and 24 equal the JAX
package's ``align_reads(..., batch_size=8, pipeline=2)`` byte for byte
on tests/test_e2e.py's pipelined world (24 reads of 300-800 bp), as do
those of an FM-index world and of a three-entry CPU mesh at two batch
sizes each. A batch's exception reaches the caller and no later batch
starts; closing the generator early returns; every batch runs on the
caller's thread, starting where its batch size puts it. Several
batchers on threads of their own share the in-flight byte budget: it
bounds their chunks together and cannot deadlock, even below one
chunk's size."""

import threading
import time

import numpy as np
import pytest
import torch

from lamsa_tpu import sim
from lamsa_tpu.index.fmindex import FmIndex
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.pipeline.aln import align_reads as jax_align_reads
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.pipeline import extend
from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
from tests.test_e2e import CFG, make_ref

torch.set_num_threads(1)


def _sam(out, fmt=format_sam_record):
    return [fmt(r) for recs in out for r in recs]


def _per_read(out, fmt=format_sam_record):
    return [[fmt(r) for r in recs] for recs in out]


@pytest.fixture(scope="module")
def e2e_world():
    """tests/test_e2e.py's world and its pipelined test's reads: the
    module fixture draws the genome from rng 42, and the reads come next
    from the same generator."""
    rng = np.random.default_rng(42)
    genome, ref, idx = make_ref(rng, 100000)
    reads = sim.simulate_reads(rng, genome, 24, read_len=(300, 800),
                               sub=0.02, ins=0.03, dele=0.03,
                               sv_fraction=0.2, name_prefix="pipe")
    want = _per_read(jax_align_reads(ref, idx, reads, CFG, batch_size=8,
                                     pipeline=2), jax_format)
    return ref, idx, reads, want


@pytest.mark.parametrize("batch_size", [1, 5, 24])
def test_batch_sizes_equal_jax(e2e_world, batch_size):
    ref, idx, reads, want = e2e_world
    pref, pidx, pcfg = port_world(ref, idx, CFG)
    got = _per_read(align_reads(pref, pidx, reads, pcfg,
                                batch_size=batch_size, device="cpu"))
    assert len(got) == len(reads)
    assert got == want


@pytest.mark.parametrize("batch_size", [3, 24])
def test_batch_sizes_equal_jax_on_fm_world(batch_size):
    rng = np.random.default_rng(31)
    genome, ref, _ = make_ref(rng, 60000)
    idx = FmIndex.build(ref.codes, sa_rate=4)
    reads = sim.simulate_reads(rng, genome, 12, read_len=(400, 1000),
                               sv_fraction=0.3, name_prefix="fmp")
    want = _sam(jax_align_reads(ref, idx, reads, CFG, batch_size=3,
                                pipeline=2), jax_format)
    pref, pidx, pcfg = port_world(ref, idx, CFG)
    aligner = Aligner(pref, pidx, pcfg, device="cpu")
    assert _sam(align_reads(pref, pidx, reads, pcfg, batch_size=batch_size,
                            aligner=aligner)) == want


@pytest.mark.parametrize("batch_size", [3, 24])
def test_batch_sizes_equal_jax_over_three_cpu_entries(e2e_world, batch_size):
    """The first 9 reads in batches of 3, or in one batch, each batch
    split over the entries."""
    ref, idx, reads, want = e2e_world
    aligner = Aligner(*port_world(ref, idx, CFG), mesh=["cpu"] * 3)
    got = _per_read(align_reads(None, None, reads[:9],
                                batch_size=batch_size, aligner=aligner))
    assert got == want[:9]


def _counting_aligner(e2e_world, fail_at=None, delay=0.0):
    """A CPU Aligner whose align_batch records the batches it started
    (and their threads) and raises in batch ``fail_at``."""
    ref, idx, _reads, _ = e2e_world
    aligner = Aligner(*port_world(ref, idx, CFG), device="cpu")
    started, threads = [], []
    inner = aligner.align_batch

    def align_batch(batch):
        k = len(started)
        started.append(k)
        threads.append(threading.current_thread())
        time.sleep(delay)
        if k == fail_at:
            raise ValueError(f"batch {k} failed")
        return inner(batch)

    aligner.align_batch = align_batch
    return aligner, started, threads


def _within(fn, seconds=120):
    """Run fn on a thread; fail if it has not returned in time."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:          # handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "align_reads did not return"
    return box


def test_batch_exception_reaches_caller(e2e_world):
    _, _, reads, _ = e2e_world
    aligner, started, _ = _counting_aligner(e2e_world, fail_at=1,
                                            delay=0.05)
    # 12 batches of 2
    box = _within(lambda: list(align_reads(None, None, reads, batch_size=2,
                                           aligner=aligner)))
    assert isinstance(box.get("error"), ValueError)
    assert "batch 1 failed" in str(box["error"])
    assert started == [0, 1]            # none after the failure


def test_close_after_first_batch_returns(e2e_world):
    _, _, reads, want = e2e_world
    aligner, started, _ = _counting_aligner(e2e_world, delay=0.05)

    def first_then_close():
        gen = align_reads(None, None, reads, batch_size=2, aligner=aligner)
        first = [next(gen) for _ in range(2)]
        gen.close()
        return first

    box = _within(first_then_close)
    assert "error" not in box
    assert _per_read(box["value"]) == want[:2]
    assert started == [0]


@pytest.mark.parametrize("batch_size,starts",
                         [(8, [0, 1, 2]), (12, [0, 1]), (24, [0])])
def test_batches_run_in_order_on_the_callers_thread(e2e_world, batch_size,
                                                    starts):
    _, _, reads, want = e2e_world
    aligner, started, threads = _counting_aligner(e2e_world)
    got = _per_read(align_reads(None, None, reads, batch_size=batch_size,
                                aligner=aligner))
    assert got == want
    assert started == starts
    assert set(threads) == {threading.current_thread()}


class _WatchedLimiter(extend._InflightLimiter):
    """The in-flight limiter, recording the most bytes and chunks it let
    out at once."""

    def __init__(self):
        super().__init__()
        self.peak = self.chunks = self.peak_chunks = 0

    def acquire(self, nbytes, budget):
        super().acquire(nbytes, budget)
        with self._cond:
            self.chunks += 1
            self.peak = max(self.peak, self._out)
            self.peak_chunks = max(self.peak_chunks, self.chunks)

    def release(self, nbytes):
        with self._cond:
            self.chunks -= 1
        super().release(nbytes)


def _batcher_run(seed, budget):
    """One DpBatcher over random codes with chunks in three buckets;
    returns its results."""
    from lamsa_tpu_torch.ops.wire import pack_codes_words
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 4, 30000).astype(np.uint8)
    refc = rng.integers(0, 4, 40000).astype(np.uint8)
    b = extend.DpBatcher(
        ScoreParams(), device_sources=tuple(
            torch.from_numpy(pack_codes_words(a)) for a in (flat, refc)),
        host_sources=(flat, refc), inflight_budget=budget)
    K = 24
    m = rng.integers(20, 300, K)
    n = np.maximum(m + rng.integers(-20, 20, K), 1)
    h0 = b.add_globals_bulk(m, n, rng.integers(0, 29000, K), 1, 0,
                            rng.integers(0, 39000, K))
    hs = [b.add_extend_desc(int(x), int(x) + 40, 5,
                            (int(rng.integers(600, 29000)), -1, 1),
                            (int(rng.integers(0, 39000)), 1))
          for x in rng.integers(10, 200, 8)]
    b.run()
    return [(r.score, r.cigar.tobytes(), r.q_used, r.t_used)
            for r in map(b.result, list(range(h0, h0 + K)) + hs)]


@pytest.mark.parametrize("budget_chunks", [0, 2])
def test_inflight_budget_shared_by_batchers(monkeypatch, budget_chunks):
    """Three batchers run at once against one budget: two of the largest
    chunk estimates, or 1 byte (every chunk alone). Each finishes with
    the results of a run by itself, and the bytes out never pass the
    budget (one chunk is always let out)."""
    seeds = (3, 4, 5)
    alone = {s: _batcher_run(s, None) for s in seeds}
    big = max(extend._chunk_inflight_bytes(M, W, a)
              for M, W in extend.BUCKETS for a in (False, True))
    budget = budget_chunks * big or 1
    lim = _WatchedLimiter()
    monkeypatch.setattr(extend, "_LIMITER", lim)
    real = extend.collect_group

    def slow_collect(*a, **k):          # keep chunks out for a while
        time.sleep(0.02)
        return real(*a, **k)

    monkeypatch.setattr(extend, "collect_group", slow_collect)
    got = {}

    def run_all():
        ts = [threading.Thread(
            target=lambda s=s: got.__setitem__(s, _batcher_run(s, budget)))
            for s in seeds]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    _within(run_all)
    assert got == alone
    assert lim._out == 0
    assert lim.peak <= max(budget, big)
    # with room for two, chunks of different batchers were out together
    assert lim.peak_chunks == (2 if budget_chunks else 1) or \
        (budget_chunks and lim.peak_chunks > 2)
