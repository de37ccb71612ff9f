"""Gap filling and end extension: the DP batcher.

Counterpart of ``lamsa_tpu/pipeline/extend.py``. Every gap and end
instance of a batch is enqueued as a device-gather descriptor, bucketed
into static (M, W) shapes with the same first-fit rules (the bucket
picks the band, so SAM stays identical), and run in chunks of at most
``CHUNK_BY_M`` instances through ``ops/dp_chain.py``. As in the JAX
package with ``ADIAG_ENABLED = True``, each bucket's global gap fills
go in all-global chunks to the antidiagonal pair (``dp_tb_adiag_gather``)
and its extensions to the row pair (``dp_tb_gather``), on every device.
Each chunk's compact wire is decoded natively on a small collect pool
(adiag chunks with topdown events); instances whose device event list
overflowed are recomputed on the host with ``native.banded_sw_tb``.

The batcher runs over entries (parallel/mesh.py); one device is a mesh
of one entry. Each chunk's instances are split into contiguous ranges,
one per entry (``row_blocks``; one entry takes the whole chunk), and
each range launches unpadded (eager torch has no compile signatures to
keep closed) on its entry's device and sources. With one entry a CUDA
range runs on the current stream; with several, each entry's range runs
on a stream of its own that first waits for the uploads. An event
recorded after each CUDA range is what its collect waits on: the
collect thread's own current stream is not the one that launched the
range, and nothing else orders its copy after the kernels. A second
event, recorded before the range's first launch, gives the collect its
stream time (``device_s`` ``dp_{M}x{W}`` of utils/timers.py).

The content API (``add_global`` / ``add_extend``, the JAX package's
signatures) takes the query and target codes themselves: they are
staged into a flat query and a flat target source of the batcher's own,
uploaded once at ``run``, and enqueued as descriptors into them, so
they ride the same chunks and kernels as the descriptor path.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

import numpy as np
import torch

from lamsa_tpu_torch.io.sam import OP_D, OP_I, OP_M, cigar_pairs
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
from lamsa_tpu_torch.utils.transfer import to_device
from lamsa_tpu_torch.ops.dp_chain import dp_tb_adiag_gather, dp_tb_gather
from lamsa_tpu_torch.ops.wire import a_pad, collect_group, global_lo, \
    pack_codes_words, pack_desc
from lamsa_tpu_torch.parallel.mesh import distinct, make_mesh, \
    row_blocks

# (max query length, band width) buckets; instances pick the first
# bucket that fits (lamsa_tpu/pipeline/extend.py BUCKETS).
BUCKETS = ((128, 128), (128, 256), (256, 128), (256, 256), (512, 128),
           (512, 256), (1024, 256), (2048, 256), (5120, 256))

# Largest bucket query length: enqueuers must split anything longer.
MAX_BUCKET_M = max(M for M, _ in BUCKETS)

# minimum band slack (per side) around the worst-case drift for a
# W=128 global instance
_MIN_SLACK = 24

# Largest chunk per bucket (bounds the direction storage of one launch
# to ~256 MB).
CHUNK_BY_M = {(128, 128): 4096, (128, 256): 4096, (256, 128): 4096,
              (256, 256): 2048, (512, 128): 2048, (512, 256): 1024,
              (1024, 256): 512, (2048, 256): 256, (5120, 256): 128}

# Extra target bases given to end extensions beyond the query length;
# must stay below min(W)//2 - 8 so the band reaches the last DP row.
EXT_MARGIN = 48

# Route global gap fills to the antidiagonal pair at both band widths
# (lamsa_tpu/pipeline/extend.py ADIAG_ENABLED); extensions stay on the
# row pair. Tests flip this off to pin the row engine for globals.
ADIAG_ENABLED = True


def _adiag_bucket(M: int, W: int) -> bool:
    return ADIAG_ENABLED and W in (128, 256)


_EMPTY_CIGAR = np.empty(0, np.uint32)


def _run(op: int, ln: int) -> np.ndarray:
    return np.array([(ln << 4) | op], np.uint32)


# ------------------------------------------------------ chunk scheduling
#
# As in the JAX package: each launched chunk's collect (device->host
# copy + native compact decode + rare host recompute) runs on a small
# shared thread pool, and dispatch blocks while the estimated device
# workspace of chunks in flight would exceed the Aligner's budget.
# Deadlock-free, also with several batchers on threads of their own:
# waiters are dispatchers, releasers are collectors of
# already-launched chunks, a collect waits only on its own chunk's event
# and never on the budget, and a chunk is always admitted when nothing
# is out. The budget bounds the bytes of all batchers' chunks together.

_COLLECT_WORKERS = 4


def _chunk_inflight_bytes(M: int, W: int, adiag: bool = False) -> int:
    """Estimated device workspace held by a chunk between launch and
    collect: the direction storage dominates (1 byte/cell: B*M*W for the
    row dirs32, B*A*V for the antidiagonal dirs32a, A = a_pad(M, W),
    V = W/2), plus window and state intermediates."""
    B = CHUNK_BY_M[(M, W)]
    cells = a_pad(M, W) * (W // 2) if adiag else M * W
    return B * cells + (32 << 20)


class _InflightLimiter:
    def __init__(self):
        self._cond = threading.Condition()
        self._out = 0

    def acquire(self, nbytes: int, budget: int):
        with self._cond:
            while self._out > 0 and self._out + nbytes > budget:
                self._cond.wait()
            self._out += nbytes

    def release(self, nbytes: int):
        with self._cond:
            self._out -= nbytes
            self._cond.notify_all()


_LIMITER = _InflightLimiter()
_POOL = None
_POOL_LOCK = threading.Lock()


def _collect_pool():
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = concurrent.futures.ThreadPoolExecutor(
                    _COLLECT_WORKERS, thread_name_prefix="dp-collect")
    return _POOL


def _timing_event(dev):
    """A timing event recorded on dev's current stream (None off CUDA,
    where a chunk has run when its call returns): one before a chunk's
    first launch, one after its last, which its collect waits on."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


@dataclasses.dataclass
class DpResult:
    score: int
    cigar: np.ndarray           # packed uint32 runs ((len << 4) | op)
    q_used: int                 # query chars consumed
    t_used: int                 # target chars consumed


class DpBatcher:
    """Collect global/extend DP instances as device-gather descriptors,
    run them bucketed, hand back per-instance results by handle.

    device_sources — (flat_read_words, ref_words): the batch's packed
    read codes and the reference, resident on the device the chunks run
    on; with a mesh, one such pair per entry. host_sources — the same
    codes as host arrays (flat_read_codes, ref_codes), for the rare host
    recompute. Both are needed by the descriptor enqueues only. mesh —
    device entries the instances of each chunk are split over (None: one
    device). device — where the content API's chunks run when there are
    no device_sources (else on theirs)."""

    def __init__(self, scores, device_sources=None, host_sources=None,
                 min_band: int = 0, inflight_budget: int | None = None,
                 mesh=None, device="cuda"):
        self.scores = scores
        # one form for every batcher: the entries each chunk is split
        # over (one device is a mesh of one entry) and, with device
        # sources, one (flat_read_words, ref_words) pair per entry
        if mesh is not None:
            self.entries = make_mesh(mesh)
            self.entry_sources = device_sources
        else:
            self.entry_sources = None if device_sources is None \
                else [device_sources]
            self.entries = (torch.device(device) if device_sources is None
                            else device_sources[0].device,)
        self.host_sources = host_sources
        self.streams = {}       # entry -> its CUDA stream (several entries)
        # the batch id of the thread that made the batcher, which its
        # collects carry on the collect pool's threads
        self.batch_id = STATS.current_batch()
        # device bytes chunks may hold between launch and collect
        # (None = unlimited); shared across concurrent batchers
        self.inflight_budget = inflight_budget
        # min_band: the CLI -w knob — instances route only to buckets
        # with W >= min_band (config.AlignConfig.band_width)
        self.buckets = tuple(b for b in BUCKETS if b[1] >= min_band) \
            or BUCKETS[-1:]
        self._results: list[DpResult | None] = []
        # descriptor instances, stored columnar
        self._bulk: list[dict] = []       # record batches of np columns
        self._scal: dict | None = None    # per-column lists (scalar adds)
        # the content API's staged codes, and their sources once run()
        # has uploaded them
        self._staged: tuple[list, list] = ([], [])
        self._staged_len = [0, 0]
        self._content = None

    # ------------------------------------------------------------ enqueue

    # src: 0 = the batcher's sources, 1 = the staged contents
    _COLS = ("idx", "m", "n", "qb", "qs", "qc", "tb", "ts", "glob",
             "bonus", "minw", "src")

    def _trivial(self, h0, m, n, kind):
        """Resolve zero-length instances immediately. Returns bool[K]
        mask of trivia."""
        triv = (m == 0) | (n == 0)
        if triv.any():
            gapo, gape = self.scores.gap_open, self.scores.gap_ext
            for i in np.flatnonzero(triv):
                mi, ni = int(m[i]), int(n[i])
                if kind == "extend" or (mi == 0 and ni == 0):
                    self._results[h0 + i] = DpResult(0, _EMPTY_CIGAR, 0, 0)
                elif mi == 0:
                    self._results[h0 + i] = DpResult(
                        -(gapo + ni * gape), _run(OP_D, ni), 0, ni)
                else:
                    self._results[h0 + i] = DpResult(
                        -(gapo + mi * gape), _run(OP_I, mi), mi, 0)
        return triv

    def add_globals_bulk(self, m, n, q_base, q_step, q_comp,
                         t_base, minw=None) -> int:
        """Vectorized enqueue of K global gap instances described by
        device-gather descriptors (see ops/dp_chain.py dp_tb_gather).
        minw: optional per-instance minimum band width. Returns the
        first handle; instance i gets handle first + i."""
        h0 = len(self._results)
        K = len(m)
        self._results.extend([None] * K)
        m = np.asarray(m, np.int64)
        n = np.asarray(n, np.int64)
        keep = ~self._trivial(h0, m, n, "global")
        if keep.any():
            ki = np.flatnonzero(keep)
            self._bulk.append({
                "idx": h0 + ki,
                "m": m[ki], "n": n[ki],
                "qb": np.asarray(q_base, np.int64)[ki],
                "qs": np.broadcast_to(np.asarray(q_step, np.int64),
                                      (K,))[ki],
                "qc": np.broadcast_to(np.asarray(q_comp, np.int64),
                                      (K,))[ki],
                "tb": np.asarray(t_base, np.int64)[ki],
                "ts": np.ones(len(ki), np.int64),
                "glob": np.ones(len(ki), bool),
                "bonus": np.zeros(len(ki), np.int64),
                "minw": (np.zeros(len(ki), np.int64) if minw is None
                         else np.asarray(minw, np.int64)[ki]),
                "src": np.zeros(len(ki), np.int64),
            })
        return h0

    def _add_one(self, kind, m, n, qd, td, bonus=0, minw=0, src=0) -> int:
        """Enqueue one instance from scalar columns; returns its handle."""
        h0 = len(self._results)
        self._results.append(None)
        if self._trivial(h0, np.array([m]), np.array([n]), kind)[0]:
            return h0
        if self._scal is None:
            self._scal = {c: [] for c in self._COLS}
        for col, v in zip(self._COLS, (h0, m, n, *qd, *td, kind == "global",
                                       bonus, minw, src)):
            self._scal[col].append(v)
        return h0

    def add_global_desc(self, m: int, n: int, qd, td) -> int:
        """Enqueue one global gap fill: qd = (q_base, q_step, q_comp) and
        td = (t_base, t_step) device-gather descriptors. Returns its
        handle."""
        return self._add_one("global", m, n, qd, td)

    def add_extend_desc(self, m: int, n: int, to_end_bonus: int, qd,
                        td) -> int:
        """Enqueue one end extension: qd = (q_base, q_step, q_comp) and
        td = (t_base, t_step) device-gather descriptors. Returns its
        handle."""
        return self._add_one("extend", m, n, qd, td, bonus=to_end_bonus)

    def _add_content(self, kind, q, t, qd, td, **kw) -> int:
        """Enqueue q vs t: as the descriptors (qd, td) into the batcher's
        sources where both are given and it has device sources, else as
        descriptors into the staged contents."""
        if qd is not None and td is not None \
                and self.entry_sources is not None:
            return self._add_one(kind, len(q), len(t), qd, td, **kw)
        offs = list(self._staged_len)
        if len(q) and len(t):       # zero-length instances resolve at once
            for side, codes in enumerate((q, t)):
                self._staged[side].append(np.asarray(codes, np.uint8))
                self._staged_len[side] += len(codes)
        return self._add_one(kind, len(q), len(t), (offs[0], 1, 0),
                             (offs[1], 1), src=1, **kw)

    def add_global(self, q: np.ndarray, t: np.ndarray, qd=None, td=None,
                   minw: int = 0) -> int:
        """Global alignment of q vs t (both fully consumed); minw is the
        least band width the instance may route to. Returns its handle
        (lamsa_tpu/pipeline/extend.py DpBatcher.add_global)."""
        return self._add_content("global", q, t, qd, td, minw=minw)

    def add_extend(self, q: np.ndarray, t: np.ndarray, to_end_bonus: int,
                   qd=None, td=None) -> int:
        """Extension from (0, 0) into q / t with the soft-clip decision:
        all of q is consumed iff the to-end score >= best - to_end_bonus.
        Returns its handle (lamsa_tpu/pipeline/extend.py
        DpBatcher.add_extend)."""
        return self._add_content("extend", q, t, qd, td, bonus=to_end_bonus)

    def _upload_staged(self):
        """Pack the staged contents into code words on the devices the
        chunks run on, once per distinct device of the entries."""
        host = tuple(np.concatenate(parts) if parts
                     else np.zeros(0, np.uint8) for parts in self._staged)
        words = [torch.from_numpy(pack_codes_words(h)) for h in host]
        per = {d: tuple(to_device(w, d) for w in words)
               for d in distinct(self.entries)}
        self._content = ([per[d] for d in self.entries], host)
        self._staged = ([], [])
        self._staged_len = [0, 0]

    def _sources(self, src):
        """(per-entry device sources, host sources) of source set src."""
        return (self.entry_sources, self.host_sources) if src == 0 \
            else self._content

    def _materialize(self, c, i):
        """q/t content of columnar instance i (host recompute path)."""
        flat, refc = self._sources(int(c["src"][i]))[1]
        m, n = int(c["m"][i]), int(c["n"][i])
        y = int(c["qb"][i]) + int(c["qs"][i]) * np.arange(m)
        q = flat[y].astype(np.uint8)
        if int(c["qc"][i]):
            q = np.where(q < 4, 3 - q, q).astype(np.uint8)
        x = int(c["tb"][i]) + int(c["ts"][i]) * np.arange(n)
        t = np.asarray(refc[x], np.uint8)
        return q, t

    # ---------------------------------------------------------------- run

    def _merged_cols(self) -> dict | None:
        """Concatenate the columnar record batches (+ scalar adds) into
        one dict of np arrays; clears the stores."""
        batches = list(self._bulk)
        if self._scal is not None:
            batches.append({k: np.asarray(v, np.int64)
                            for k, v in self._scal.items()})
        self._bulk = []
        self._scal = None
        if not batches:
            return None
        return {k: np.concatenate([b[k] for b in batches])
                for k in self._COLS}

    def _launch(self, dispatch, M, W, adiag, futs):
        """Launch one chunk under the in-flight budget and hand its
        collect to the decode pool."""
        # each entry holds its range
        est = _chunk_inflight_bytes(M, W, adiag) // len(self.entries)
        bud = self.inflight_budget
        if bud:
            _LIMITER.acquire(est, bud)
        try:
            lch = dispatch()
        except BaseException:
            if bud:
                _LIMITER.release(est)
            raise
        futs.append(_collect_pool().submit(
            self._collect_one, lch, est if bud else 0))

    def _collect_one(self, lch, rel_bytes):
        try:
            with STATS.batch(self.batch_id):
                self._collect(*lch)
        finally:
            if rel_bytes:
                _LIMITER.release(rel_bytes)

    def run(self) -> None:
        futs = []
        if self._staged_len != [0, 0]:
            self._upload_staged()
        c = self._merged_cols()
        if c is not None:
            m, n, glob = c["m"], c["n"], c["glob"]
            need = np.abs(n - m) + 1
            bid = np.full(len(m), -1, np.int64)
            for bi, (M, W) in enumerate(self.buckets):
                fit_g = (m <= M) & (need <= W - 16) \
                    & ((W - need) // 2 >= _MIN_SLACK) & (W >= c["minw"])
                fit_e = (m <= M) & (n - m <= W // 2 - 8) \
                    & ((W == 256) | (m <= 256))
                fit = np.where(glob, fit_g, fit_e)
                bid = np.where((bid < 0) & fit, bi, bid)
            nofit = np.flatnonzero(bid < 0)
            if len(nofit):                      # pathological fallback
                STATS.count("dp_no_bucket_fallback", len(nofit))
            for i in nofit:
                mi, ni = int(m[i]), int(n[i])
                s = -(2 * self.scores.gap_open
                      + (mi + ni) * self.scores.gap_ext)
                self._results[int(c["idx"][i])] = DpResult(
                    s, np.concatenate([_run(OP_I, mi), _run(OP_D, ni)]),
                    mi, ni)
            for bi, (M, W) in enumerate(self.buckets):
                sel = np.flatnonzero(bid == bi)
                if len(sel) == 0:
                    continue
                sel = sel[np.argsort(-m[sel], kind="stable")]
                # globals ride all-global antidiagonal chunks; glob is
                # int64 0/1 once scalar adds were merged in
                if _adiag_bucket(M, W):
                    gsel = glob[sel].astype(bool)
                    parts = [(sel[gsel], True), (sel[~gsel], False)]
                else:
                    parts = [(sel, False)]
                # a chunk reads one source set
                parts = [(p[c["src"][p] == s], adiag) for p, adiag in parts
                         for s in (0, 1)]
                chunk = CHUNK_BY_M[(M, W)]
                for psel, adiag in parts:
                    for c0 in range(0, len(psel), chunk):
                        sl = {k: v[psel[c0:c0 + chunk]]
                              for k, v in c.items()}
                        self._launch(
                            lambda sl=sl, M=M, W=W, adiag=adiag:
                            self._dispatch_cols(sl, M, W, adiag),
                            M, W, adiag, futs)
        for f in futs:          # all collects ran on the decode pool;
            f.result()          # propagate any worker exception

    def _dispatch_cols(self, sl, M, W, adiag=False):
        """Pack a descriptor slice into the (K, 4) wire and launch the
        chunk on the antidiagonal pair (adiag: all instances global) or
        the row pair (no wait), in contiguous ranges, one per entry: each
        range's wire is copied to its entry's device and launched there
        on its sources. Returns the slice and the launched parts
        [(lo, hi, wire, start event, done event)], the events None off
        CUDA."""
        K = len(sl["m"])
        with STATS.stage(f"dp_build_{M}x{W}"):
            sl = dict(sl)
            sl["lo"] = np.where(sl["glob"], global_lo(sl["m"], sl["n"], W),
                                -(W // 2)).astype(np.int64)
            desc = pack_desc(sl["qb"], sl["qs"], sl["qc"], sl["tb"],
                             sl["ts"], sl["m"], sl["n"], sl["lo"],
                             sl["glob"], sl["bonus"])
        STATS.count(f"dp_cells_{M}x{W}", int(sl["m"].sum()) * W)
        STATS.count("dp_instances", K)
        STATS.count(f"dp_instances_{M}x{W}", K)
        if adiag:
            STATS.count("dp_adiag_instances", K)
        dev_src = self._sources(int(sl["src"][0]))[0]
        parts = []
        with STATS.stage(f"dp_dispatch_{M}x{W}"):
            for e, (dev, (a, b)) in enumerate(zip(
                    self.entries, row_blocks(K, len(self.entries)))):
                if a == b:
                    continue
                STATS.count(f"dp_instances_entry{e}", b - a)
                flat_dev, ref_dev = dev_src[e]
                desc_dev = to_device(torch.from_numpy(desc[a:b]), dev)
                if dev.type != "cuda":
                    parts.append((a, b, self._chunk(
                        flat_dev, ref_dev, desc_dev, M, W, adiag), None,
                        None))
                    continue
                with torch.cuda.device(dev):
                    s = self._entry_stream(e, dev)
                    with torch.cuda.stream(s):      # None: current stream
                        start = _timing_event(dev)
                        wire = self._chunk(flat_dev, ref_dev, desc_dev, M,
                                           W, adiag)
                        done = _timing_event(dev)
                    if s is not None:
                        for t in (flat_dev, ref_dev, desc_dev):
                            t.record_stream(s)
                parts.append((a, b, wire, start, done))
        return sl, M, W, parts, adiag

    def _entry_stream(self, e, dev):
        """The stream entry e's CUDA range runs on: None (dev's current
        stream) when the batcher has one entry; else a stream of the
        entry's own, which first waits on dev's current stream, where
        the range's inputs were uploaded."""
        if len(self.entries) == 1:
            return None
        if e not in self.streams:
            self.streams[e] = torch.cuda.Stream(dev)
        s = self.streams[e]
        s.wait_stream(torch.cuda.current_stream(dev))
        return s

    def _chunk(self, flat_dev, ref_dev, desc_dev, M, W, adiag):
        if adiag:
            return dp_tb_adiag_gather(flat_dev, ref_dev, desc_dev, M=M, W=W,
                                      scores=self.scores)
        return dp_tb_gather(flat_dev, ref_dev, desc_dev, M=M, W=W,
                            scores=self.scores, zdrop=self.scores.zdrop)

    def _collect(self, sl, M, W, parts, topdown=False):
        from lamsa_tpu_torch import native
        res = self._results
        for a, b, wire, start, done in parts:
            if done is not None:
                done.synchronize()
                # the chunk's stream time, from before its first launch
                # to after its last
                STATS.add_device(f"dp_{M}x{W}",
                                 start.elapsed_time(done) / 1e3)
            elif wire.device.type == "cuda":
                raise RuntimeError("a CUDA chunk reached the collect "
                                   "without the event of its stream")
            with STATS.stage(f"dp_collect_{M}x{W}"):
                cigars, score, si, sd = collect_group(wire, M, topdown)
            K = b - a
            lo = sl["lo"][a:b]
            idxs = sl["idx"][a:b].tolist()
            los = lo.tolist()
            i_l = si[:K].tolist()
            j_l = (si[:K] + lo + sd[:K]).tolist()
            sc_l = score[:K].tolist()
            for x in range(K):
                cig = cigars[x]
                if cig is None:
                    # compact event budget overflowed on device (rare:
                    # > E deletions in one gap) — recompute this instance
                    # bit-identically on the host
                    q, t = self._materialize(sl, a + x)
                    cig = native.banded_sw_tb(q, t, self.scores, los[x],
                                              los[x] + W - 1, i_l[x], j_l[x])
                res[idxs[x]] = DpResult(sc_l[x], cig, i_l[x], j_l[x])

    def result(self, idx: int) -> DpResult:
        r = self._results[idx]
        assert r is not None, "DpBatcher.run() not called or instance lost"
        return r


def compute_nm(q: np.ndarray, t: np.ndarray, cigar) -> int:
    """Edit distance (NM tag) from a stitched CIGAR: mismatches inside
    M runs plus inserted/deleted bases (lamsa_tpu/pipeline/extend.py
    compute_nm, vectorized over the runs)."""
    runs = np.asarray(cigar, np.uint32)
    ops = (runs & 0xF).astype(np.int64)
    lens = (runs >> 4).astype(np.int64)
    q_adv = np.where(ops == OP_D, 0, lens)       # I, M and clips use q
    t_adv = np.where((ops == OP_M) | (ops == OP_D), lens, 0)
    q0 = np.cumsum(q_adv) - q_adv
    t0 = np.cumsum(t_adv) - t_adv
    nm = int(lens[(ops == OP_I) | (ops == OP_D)].sum())
    mm = ops == OP_M
    ln = lens[mm]
    if ln.sum() == 0:
        return nm
    # element x of M run r sits at q0[r] + x / t0[r] + x
    run_start = np.cumsum(ln) - ln
    off = np.arange(int(ln.sum())) - np.repeat(run_start, ln)
    qi = np.repeat(q0[mm], ln) + off
    ti = np.repeat(t0[mm], ln) + off
    qs, ts = q[qi], t[ti]
    return nm + int(np.sum((qs != ts) | (qs >= 4) | (ts >= 4)))


def md_tag(q: np.ndarray, t: np.ndarray, cigar) -> str:
    """SAM MD:Z tag from the clip-less CIGAR and aligned code windows
    (q = query window, t = reference window). Matches samtools calmd
    semantics: match-run lengths, mismatch ref bases, ^-prefixed
    deletion runs; insertions are invisible to MD."""
    from lamsa_tpu_torch.io.fasta import BASES
    out = []
    run = 0
    i = j = 0
    for op, ln in cigar_pairs(cigar):
        if op == OP_M:
            qs, ts = q[i:i + ln], t[j:j + ln]
            mismatch = (qs != ts) | (qs >= 4) | (ts >= 4)
            for x in range(ln):
                if mismatch[x]:
                    out.append(str(run))
                    run = 0
                    out.append(BASES[int(ts[x])])
                else:
                    run += 1
            i += ln
            j += ln
        elif op == OP_I:
            i += ln
        elif op == OP_D:
            out.append(str(run))
            run = 0
            out.append("^" + "".join(BASES[int(c)] for c in t[j:j + ln]))
            j += ln
        else:
            i += ln
    out.append(str(run))
    return "".join(out)
