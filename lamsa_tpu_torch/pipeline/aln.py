"""End-to-end alignment pipeline on PyTorch (k-mer and FM index backends).

Counterpart of ``lamsa_tpu/pipeline/aln.py``. Batches of reads flow
through

  device:  flat read upload (4-bit words), read-matrix gather, seeding
           from the k-mer table or the FM index (pipeline/seeding.py,
           ops/fm.py), chaining (ops/chain.py)
  host:    skeleton assembly + SV classification
           (pipeline/skeleton.py, a copy of the JAX package's)
  device:  bucketed banded DP + traceback (pipeline/extend.py ->
           ops/dp_chain.py: the row DP and row traceback kernels)
  host:    native compact decode, CIGAR stitching, MAPQ,
           primary/supplementary selection, SA:Z linking, SAM records

Every tensor lives on the Aligner's explicit ``device``, or on the
entries of its ``mesh`` (parallel/mesh.py): the index and reference
once per distinct device, each read-length group's rows and each DP
chunk's instances split into contiguous blocks, one per entry, results
joined in input order. On ``cuda`` the DP stages launch the
hand-written kernels; on ``cpu`` the same code runs their plain torch
versions. Nothing moves to another device on failure. The host methods
(skeleton, part enqueue, finalize, MAPQ) are copies of the JAX
package's: its module imports jax, so it cannot be imported here.

Every host wait of a batch is on the stream its caller runs it on, or
on an event recorded there, never on the whole device; the tensors that
every batch reads (the resident state, the qpos grids) are complete
before any stream can see them. So ``align_batch`` gives the same
records on whichever stream, and from whichever thread, it is called.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os

import numpy as np
import torch

from lamsa_tpu_torch.config import AlignConfig
from lamsa_tpu_torch.index.fmindex import FmIndex
from lamsa_tpu_torch.index.kmer import KmerIndex, auto_kmer
from lamsa_tpu_torch.io.fasta import encode_seq
from lamsa_tpu_torch.io.refpack import PackedReference
from lamsa_tpu_torch.io.sam import (FLAG_REVERSE, FLAG_SECONDARY,
                                    FLAG_SUPPLEMENTARY, OP_D, OP_I, OP_M,
                                    OP_S, SamRecord, cigar_ref_len,
                                    merge_runs, unmapped_record)
from lamsa_tpu_torch.ops.chain import chain_hits
from lamsa_tpu_torch.ops.fm import edit1_tracks
from lamsa_tpu_torch.ops.wire import gather_packed_run, pack_codes_words, \
    to_i32
from lamsa_tpu_torch.parallel.mesh import distinct, make_mesh, \
    norm_device, row_blocks
from lamsa_tpu_torch.pipeline.extend import (_MIN_SLACK, EXT_MARGIN,
                                             MAX_BUCKET_M, DpBatcher,
                                             compute_nm, md_tag)
from lamsa_tpu_torch.pipeline.seeding import (make_qpos_grid, seed_hits,
                                              seed_hits_fm)
from lamsa_tpu_torch.pipeline.skeleton import (anchors_to_blocks,
                                               build_skeleton)
from lamsa_tpu_torch.pipeline.state import device_state
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
from lamsa_tpu_torch.utils.transfer import to_device, to_host

_EXT_CAP = 2048          # longest end extension attempted (rest soft-clips)

# Hit packing uses 19 bits for qpos; longer reads are reported unmapped
# with a warning.
MAX_READ_LEN = 1 << 19

# Reverse-complement table for SAM SEQ strings; anything outside ACGTN
# maps to N
_RC_TRANS = {i: ord("N") for i in range(256)}
_RC_TRANS.update(str.maketrans("ACGTN", "TGCAN"))

# invalid-lane sentinel for the merge-rechain sort key
# ((strand << 51) | (qpos << 32) | rpos fits 52 bits)
_MERGE_INV = np.int64(1) << 62
# element budget for one adaptive-retry seeding sub-batch
_RETRY_BUDGET_ELEMS = 16_000_000
# plane 1's valid bit (_pack_hits_chain)
_VALID_BIT = 20


def _hit_valid(plane1: np.ndarray) -> np.ndarray:
    """The valid flags of a host copy of _pack_hits_chain's plane 1."""
    return ((plane1 >> _VALID_BIT) & 1).astype(bool)


def _pack_hits_chain(hits, *, weight, lookback, max_dist, diag_slack):
    """Chain the hits and pack hit + chain arrays into 3 int32 planes
    (the host decode in Aligner._seed_and_chain reads this layout):
      plane 0: rpos bit-pattern
      plane 1: qpos (19 bits) | strand << 19 | valid << 20
      plane 2: f (19 bits) | (pred+1) << 19"""
    with STATS.stage("chain_hits"):
        f, pred = chain_hits(hits["qpos"], hits["rpos"], hits["strand"],
                             hits["valid"], weight=weight, lookback=lookback,
                             max_dist=max_dist, diag_slack=diag_slack)
        if f.device.type == "cuda":
            # the stage holds the loop's enqueue and its drain; only the
            # batch's stream is waited on
            torch.cuda.current_stream(f.device).synchronize()
    return torch.stack([
        to_i32(hits["rpos"]),
        to_i32(hits["qpos"] | (hits["strand"] << 19)
               | (hits["valid"].to(torch.int64) << _VALID_BIT)),
        to_i32(f | ((pred + 1) << 19)),
    ])


def gather_rc(flatp, offs, lens, *, L):
    """(B, L) padded read-code matrix gathered on the device from the
    batch's packed flat code words: read b = codes[offs[b]:offs[b] +
    lens[b]], padded with 4."""
    i = torch.arange(L, device=flatp.device)[None, :]
    g = gather_packed_run(flatp, offs, torch.ones_like(offs), L)
    return torch.where(i < lens[:, None], g, 4)


def _trim_boundary_indels(merged, pos, qs_cov, qe_cov):
    """Canonicalize a stitched clip-less CIGAR's boundaries: alignments
    must start and end with M. Boundary I runs become soft clip (the
    covered query span shrinks); boundary D runs are dropped, a leading
    one advancing pos. Returns (runs, pos, qs_cov, qe_cov), runs=None if
    nothing alignable remains."""
    a, b = 0, len(merged)
    while a < b:
        op, ln = int(merged[a]) & 0xF, int(merged[a]) >> 4
        if op == OP_I:
            qs_cov += ln
        elif op == OP_D:
            pos += ln
        else:
            break
        a += 1
    while b > a:
        op, ln = int(merged[b - 1]) & 0xF, int(merged[b - 1]) >> 4
        if op == OP_I:
            qe_cov -= ln
        elif op != OP_D:
            break
        b -= 1
    if a == 0 and b == len(merged):
        return merged, pos, qs_cov, qe_cov
    out = merged[a:b]
    if not ((out & 0xF) == OP_M).any():
        return None, pos, qs_cov, qe_cov
    return out, pos, qs_cov, qe_cov


def _revcomp_codes(codes: np.ndarray) -> np.ndarray:
    from lamsa_tpu_torch import native
    return native.revcomp4(codes)


@dataclasses.dataclass
class _PendingPart:
    part: object
    blocks: np.ndarray
    gap_handles: list          # DP handles between blocks (or ("M", len))
    left_handle: int | None
    right_handle: int | None
    o_lo: int
    o_hi: int
    secondary: bool = False


class Aligner:
    """Aligner over a PackedReference and a KmerIndex (small and medium
    genomes) or an FmIndex (whole genomes) on one explicit torch device
    ("cuda" runs the kernels, "cpu" their plain versions). The native
    host library is required (compact decode, overflow recompute).

    mesh: optional device entries for read-level data parallelism
    (parallel/mesh.py make_mesh; they replace ``device`` and may repeat
    a device). SAM is byte-identical to the one-device run."""

    def __init__(self, ref: PackedReference, index: KmerIndex | FmIndex,
                 config: AlignConfig | None = None, device="cuda",
                 mesh=None):
        from lamsa_tpu_torch import native
        self.mesh = make_mesh(mesh) if mesh is not None else None
        self.entries = self.mesh or (norm_device(device),)
        self.device = self.entries[0]
        for dev in distinct(self.entries):
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {dev} requested but "
                                   f"torch.cuda.is_available() is False")
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {dev}")
        if not native.available():
            raise RuntimeError("the native host library "
                               "(lamsa_tpu_torch/native) is required and "
                               "did not build")
        if not isinstance(index, (KmerIndex, FmIndex)):
            # an index of the JAX package would pass neither test and be
            # seeded as the wrong kind: refuse it rather than guess
            raise TypeError(
                f"index must be a lamsa_tpu_torch.index KmerIndex or "
                f"FmIndex, not {type(index).__module__}."
                f"{type(index).__name__}")
        self.ref = ref
        self.index = index
        self.config = config or AlignConfig()
        if isinstance(index, FmIndex):
            self.seed_backend = "fm"
            # the FM index is k-agnostic: the backward-search piece
            # length grows with the genome (a random 13-mer occurs ~46x
            # in 3.1 Gb; 16 restores ~1 expected random hit)
            self.k = max(self.config.kmer, auto_kmer(ref.total_len))
        else:
            self.seed_backend = "kmer"
            self.k = index.k
        # index and reference tensors, once per distinct device; the
        # host waits for their upload here, so a batch's stream can
        # never read them before it has landed
        self._states = {dev: device_state(ref, index, dev)
                        for dev in distinct(self.entries)}
        for dev in self._states:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        self._state = self._states[self.device]
        self._grids = {}
        self._batch_ids = itertools.count()
        self._inflight_budget = self._compute_inflight_budget() \
            if self.device.type == "cuda" else None

    def _compute_inflight_budget(self) -> int:
        """Device-byte budget for in-flight DP chunk workspace: a
        fraction of device memory minus the resident index/ref tensors,
        on the tightest of the cards the entries run on.
        LAMSA_INFLIGHT_BUDGET (bytes) overrides it;
        LAMSA_INFLIGHT_FRACTION sets the fraction (default 0.6), as in
        the JAX package."""
        env = os.environ.get("LAMSA_INFLIGHT_BUDGET")
        if env:
            return int(float(env))
        cards = [d for d in self._states if d.type == "cuda"] \
            or [self.device]
        room = min(torch.cuda.mem_get_info(d)[1]
                   - sum(t.nbytes for t in self._states[d].values())
                   for d in cards)
        frac = float(os.environ.get("LAMSA_INFLIGHT_FRACTION", "0.6"))
        return max(int(max(room, 0) * frac), 256 << 20)

    # ------------------------------------------------------------- batching

    def _bucket_len(self, n: int) -> int:
        for b in self.config.read_len_buckets:
            if n <= b:
                return b
        return int(2 ** math.ceil(math.log2(n)))

    def align_batch(self, reads) -> list[list[SamRecord]]:
        """Align a list of FastxRecords; returns SAM records per read,
        in input order. The batch takes the Aligner's next batch id,
        which every stage it opens carries (utils/timers.py)."""
        with STATS.batch(next(self._batch_ids)):
            return self._align_batch(reads)

    def _align_batch(self, reads) -> list[list[SamRecord]]:
        cfg = self.config
        out: list[list[SamRecord] | None] = [None] * len(reads)
        codes = [np.frombuffer(encode_seq(r.seq), np.uint8) for r in reads]

        groups: dict[int, list[int]] = {}
        for i, c in enumerate(codes):
            if len(c) > MAX_READ_LEN:
                import warnings
                warnings.warn(
                    f"read {reads[i].name!r} is {len(c)} bp, beyond the "
                    f"{MAX_READ_LEN} bp qpos-packing limit; reported "
                    f"unmapped", stacklevel=2)
                out[i] = [unmapped_record(reads[i].name, reads[i].seq,
                                          reads[i].qual)]
                codes[i] = np.empty(0, np.uint8)   # keep flat pack small
                continue
            groups.setdefault(self._bucket_len(max(len(c), cfg.kmer + 1)),
                              []).append(i)

        # flat forward read codes, resident on the device for the batch
        # as 4-bit packed int32 words: the seeding read matrix and every
        # DP window are gathered from it
        total = sum(len(c) for c in codes)
        flat = np.full(max(total, 8), 4, np.uint8)
        flat_offs = np.zeros(len(codes) + 1, np.int64)
        pos = 0
        for i, c in enumerate(codes):
            flat_offs[i] = pos
            flat[pos:pos + len(c)] = c
            pos += len(c)
        flat_offs[-1] = pos
        words = torch.from_numpy(pack_codes_words(flat))
        flat_devs = {dev: to_device(words, dev) for dev in self._states}

        sources = [(flat_devs[dev], self._states[dev]["ref_words"])
                   for dev in self.entries]
        batcher = DpBatcher(cfg.scores, device_sources=sources,
                            host_sources=(flat, self.ref.codes),
                            min_band=cfg.band_width,
                            inflight_budget=self._inflight_budget,
                            mesh=self.entries)
        pending: list[tuple[int, list[_PendingPart], object]] = []

        for L, idxs in sorted(groups.items()):
            with STATS.stage("seed_chain_device"):
                hit_arrays = self._seed_and_chain(codes, idxs, L, flat_devs,
                                                  flat_offs)
            with STATS.stage("skeleton_host"):
                for gi, ri in enumerate(idxs):
                    sk = self._build_skeleton(hit_arrays, gi, len(codes[ri]))
                    parts = self._enqueue_parts(sk, codes[ri], batcher,
                                                int(flat_offs[ri]))
                    pending.append((ri, parts, sk))

        with STATS.stage("dp_batch"):
            batcher.run()

        with STATS.stage("finalize_host"):
            if cfg.threads > 1:
                import concurrent.futures as cf
                with cf.ThreadPoolExecutor(cfg.threads) as pool:
                    futs = {
                        ri: pool.submit(self._finalize_read, reads[ri],
                                        codes[ri], parts, sk, batcher)
                        for ri, parts, sk in pending}
                    for ri, fut in futs.items():
                        out[ri] = fut.result()
            else:
                for ri, parts, sk in pending:
                    out[ri] = self._finalize_read(reads[ri], codes[ri],
                                                  parts, sk, batcher)
        STATS.count("reads", len(reads))
        return out

    # -------------------------------------------------------- device stages

    def _seed_chain_rows(self, rows, offs, lens_h, L, step, common,
                         flat_devs, sub1=False):
        """Seed + chain the group rows ``rows`` with their rows split into
        contiguous blocks, one per entry: each block's (B, L) read matrix
        is gathered on its entry's device from the batch's flat code
        words. Returns the packed (3, len(rows), H) planes in row
        order."""
        parts = []
        for dev, (a, b) in zip(self.entries,
                               row_blocks(len(rows), len(self.entries))):
            if a == b:
                continue
            r = rows[a:b]
            lens = to_device(torch.from_numpy(lens_h[r]), dev)
            rc = gather_rc(flat_devs[dev],
                           to_device(torch.from_numpy(offs[r]), dev),
                           lens, L=L)
            parts.append(self._seed_chain_packed(
                rc, lens, self._grid(L, step, dev), common, dev, sub1))
        return np.concatenate(parts, axis=1)

    def _seed_chain_packed(self, rc, lens, grid, common, dev, sub1=False):
        """Seed + chain one block on device ``dev``; returns the packed
        (3, B, H) int32 planes (_pack_hits_chain) as a host array.
        sub1 adds the FM backend's 1-edit variant tracks (the adaptive
        re-seed only)."""
        cfg = self.config
        st = self._states[dev]
        kw = dict(k=common["k"], cands_per_seed=common["cands_per_seed"],
                  max_hits=common["max_hits"])
        fm = self.seed_backend == "fm"
        events = [] if fm and dev.type == "cuda" else None
        with STATS.stage("seed_hits"):
            if not fm:
                hits = seed_hits(rc, lens, grid, st["keys"], st["starts"],
                                 st["counts"], st["positions"], **kw)
            else:
                quota = cfg.max_hits_per_read // 32 \
                    if self._quota_on() else 0
                hits = seed_hits_fm(
                    rc, lens, grid, st, sa_rate=self.index.sa_rate,
                    seg_quota=quota,
                    sub1_cands=cfg.seed_1edit_cands if sub1 else 0,
                    sub1_k=self._sub1_k() if sub1 else 0,
                    sub1_kinds=cfg.seed_1edit_kinds, events=events, **kw)
            if dev.type == "cuda":
                # the stage's seconds are the device's, not the enqueue's;
                # only this batch's stream is waited on
                torch.cuda.current_stream(dev).synchronize()
        for name, start, end in events or ():
            STATS.add_device(name, start.elapsed_time(end) / 1e3)
        packed = to_host(_pack_hits_chain(
            hits, weight=common["weight"], lookback=common["lookback"],
            max_dist=common["max_dist"], diag_slack=common["diag_slack"]))
        if fm:
            # the valid hits: each a candidate SA row that seed_hits_fm
            # resolved to a position (resolve_rows walks the invalid
            # lanes too, masked, so its time follows max_hits instead)
            STATS.count("fm_rows_resolved",
                        int(np.count_nonzero(_hit_valid(packed[1]))))
        return packed

    def _seed_and_chain(self, codes, idxs, L, flat_devs, flat_offs):
        """Device seeding+chaining for one read-length bucket: the (B, L)
        read matrix is gathered from the batch's flat code words, and
        all hit arrays come back in one packed transfer per entry."""
        cfg = self.config
        offs = np.array([flat_offs[ri] for ri in idxs], np.int64)
        lens_h = np.array([min(len(codes[ri]), L) for ri in idxs], np.int64)
        common = dict(k=self.k, cands_per_seed=cfg.max_cands_per_seed,
                      max_hits=cfg.max_hits_per_read, weight=self.k,
                      lookback=cfg.chain_lookback,
                      max_dist=cfg.chain_max_dist,
                      diag_slack=cfg.chain_diag_slack)

        packed = self._seed_chain_rows(np.arange(len(idxs)), offs, lens_h,
                                       L, cfg.seed_step, common, flat_devs)
        # Adaptive densification: reads whose BEST chain carries fewer
        # than adaptive_seed_min_anchors anchors' worth of score (length-
        # scaled), or that leave a long stretch of clean seed windows
        # without any hit, are re-seeded on a half-step grid and the two
        # hit sets are union-merged (lamsa_tpu/pipeline/aln.py
        # _seed_and_chain has the measurements behind both triggers).
        amin = cfg.adaptive_seed_min_anchors
        if amin and cfg.seed_step >= 4:
            valid = _hit_valid(packed[1])
            fbest = np.where(valid, packed[2] & 0x7FFFF, 0).max(axis=1)
            sparse = (fbest < self._amin_eff(lens_h) * self.k) \
                & (lens_h >= self.k + cfg.seed_step * amin)
            gw = cfg.adaptive_seed_gap_windows
            if gw:
                # coverage trigger, counted in N-free seed windows and
                # gated on the hit budget not being saturated
                nv = valid.sum(axis=1)
                big = np.int64(1) << 30
                qp = packed[1] & 0x7FFFF
                st_ = (packed[1] >> 19) & 1
                coord = np.where(st_ == 1, lens_h[:, None] - qp - self.k,
                                 qp).astype(np.int64)
                c = np.sort(np.where(valid, coord, big), axis=1)
                grid_h = make_qpos_grid(L, self.k, cfg.seed_step)
                budget_ok = nv < int(0.9 * packed.shape[2])
                for b in np.flatnonzero(budget_ok & ~sparse
                                        & (lens_h > 0)):
                    ri = idxs[b]
                    cb = codes[ri]
                    amb = np.cumsum(
                        np.concatenate([[0], (cb >= 4).astype(np.int64)]))
                    g = grid_h[grid_h + self.k <= len(cb)]
                    vp = g[amb[g + self.k] == amb[g]]   # N-free windows
                    hits = c[b][c[b] < big]
                    edges = np.concatenate([[-1], hits,
                                            [len(cb) - self.k + 1]])
                    lo_i = np.searchsorted(vp, edges[:-1], side="right")
                    hi_i = np.searchsorted(vp, edges[1:], side="left")
                    if (hi_i - lo_i).max(initial=0) >= gw:
                        sparse[b] = True
            if sparse.any():
                STATS.count("seed_densified_reads", int(sparse.sum()))
                # only the sparse reads re-seed, in sub-batches capped by
                # an element budget (bounds the retry's device footprint);
                # on the FM backend the retry adds the 1-edit variant
                # tracks, whose key/row arrays the budget counts too. The
                # sub-batches are formed as on one device and only then
                # split over the mesh's entries.
                sel = np.flatnonzero(sparse)
                step_d = max(2, cfg.seed_step // 2)
                sub1 = self.seed_backend == "fm"
                cap = self._retry_cap(
                    len(make_qpos_grid(L, self.k, step_d)))
                packed = packed.copy()
                for c0 in range(0, len(sel), cap):
                    chunk = sel[c0:c0 + cap]
                    dense = self._seed_chain_rows(chunk, offs, lens_h, L,
                                                  step_d, common, flat_devs,
                                                  sub1=sub1)
                    # union-merge: the retry only ADDS evidence
                    packed[:, chunk] = self._merge_rechain(
                        packed[:, chunk], dense, common)
        return {
            "rpos": packed[0].view(np.uint32).astype(np.int64),
            "qpos": packed[1] & 0x7FFFF,
            "strand": (packed[1] >> 19) & 1,
            "valid": _hit_valid(packed[1]),
            "f": packed[2] & 0x7FFFF,
            "pred": (packed[2] >> 19) - 1,
        }

    def _merge_rechain(self, p0, p1, common):
        """Union of two packed seed+chain results (3, n, H): decode both
        hit sets, merge + dedup per read, drop diagonal-band singletons
        and pairs (fewer than 3 same-strand hits within +-1 band of
        width diag_slack), re-chain on the device. Output rows keep the
        (strand, qpos, rpos) order chaining requires; overflow past H is
        truncated after dedup."""
        n, H = p0.shape[1], p0.shape[2]
        if n == 0:
            return p0

        def dec(p):
            q = (p[1] & 0x7FFFF).astype(np.int64)
            r = p[0].view(np.uint32).astype(np.int64)
            s = ((p[1] >> 19) & 1).astype(np.int64)
            v = _hit_valid(p[1])
            return np.where(v, (s << 51) | (q << 32) | r, _MERGE_INV)

        key = np.sort(np.concatenate([dec(p0), dec(p1)], axis=1), axis=1)
        dup = np.concatenate([np.zeros((n, 1), bool),
                              key[:, 1:] == key[:, :-1]], axis=1)
        key = np.where(dup, _MERGE_INV, key)
        slack = max(int(common["diag_slack"]), 1)
        valid = key < _MERGE_INV
        qpos_a = (key >> 32) & 0x7FFFF
        diag = (key & 0xFFFFFFFF) - qpos_a
        band = np.where(valid, (key >> 51 << 40) + diag // slack, -1)
        for i in range(n):
            b = band[i][valid[i]]
            if len(b) == 0:
                continue
            ub, cnt = np.unique(b, return_counts=True)
            cmap = dict(zip(ub.tolist(), cnt.tolist()))
            votes = np.fromiter(
                (cmap.get(x, 0) + cmap.get(x - 1, 0) + cmap.get(x + 1, 0)
                 for x in b.tolist()), np.int64, len(b))
            kill = np.flatnonzero(valid[i])[votes < 3]
            key[i, kill] = _MERGE_INV
        key = np.sort(key, axis=1)[:, :H]
        valid = key < _MERGE_INV
        planes = {"qpos": np.where(valid, (key >> 32) & 0x7FFFF, 0),
                  "rpos": np.where(valid, key & 0xFFFFFFFF, 0),
                  "strand": np.where(valid, key >> 51, 0), "valid": valid}
        parts = []                  # re-chained in row blocks per entry
        for dev, (a, b) in zip(self.entries,
                               row_blocks(n, len(self.entries))):
            if a == b:
                continue
            hits = {name: to_device(torch.from_numpy(v[a:b]), dev)
                    for name, v in planes.items()}
            parts.append(to_host(_pack_hits_chain(
                hits, weight=common["weight"], lookback=common["lookback"],
                max_dist=common["max_dist"],
                diag_slack=common["diag_slack"])))
        return np.concatenate(parts, axis=1)

    def _retry_cap(self, n_windows: int) -> int:
        """Reads per adaptive re-seed sub-batch: the largest power of two
        (at least 8) whose candidate arrays, 2 strands x n_windows x the
        candidates per window (plus the 1-edit tracks' on the FM
        backend), stay within _RETRY_BUDGET_ELEMS."""
        cfg = self.config
        per_read = n_windows * 2 * cfg.max_cands_per_seed
        if self.seed_backend == "fm" and cfg.seed_1edit_cands:
            T = len(edit1_tracks(self._sub1_k(), cfg.seed_1edit_kinds)[0])
            per_read += n_windows * 2 * T * cfg.seed_1edit_cands
        return 1 << max(3, (_RETRY_BUDGET_ELEMS
                            // max(per_read, 1)).bit_length() - 1)

    def _quota_on(self) -> bool:
        """Whole-genome hit budgeting (seed_hits_fm seg_quota =
        max_hits_per_read // 32): the FM backend above 1 Gb, where a
        random k-mer still hits ~0.7x per strand and would flood
        max_hits on long reads."""
        return self.seed_backend == "fm" \
            and self.ref.total_len > 1_000_000_000

    def _amin_eff(self, lens_h):
        """Anchors' worth of best-chain score below which a read
        re-seeds: adaptive_seed_min_anchors, scaled up with read length
        (len // 256) unless the seg quota is on, where quota sampling
        caps a healthy read's best chain below a scaled bar
        (lamsa_tpu/pipeline/aln.py _seed_and_chain has the
        measurement)."""
        amin = self.config.adaptive_seed_min_anchors
        return amin if self._quota_on() else np.maximum(amin, lens_h // 256)

    def _sub1_k(self) -> int:
        """Piece length for the 1-edit variant tracks: smallest k1 >= k
        whose ~8*k1 variant patterns expect < 0.15 random hits per
        window, so variant noise cannot flood max_hits (15 at 1 Mb, 18
        at 64 Mb, 21 at GRCh38 scale)."""
        t = max(int(self.ref.total_len), 1)
        k1 = self.k
        while 8 * k1 * t / (4 ** k1) > 0.15 and k1 < 24:
            k1 += 1
        return k1

    def _grid(self, L, step, dev):
        """qpos sample grid per (bucket length, step), cached on each
        device; an entry is published only after its upload completed,
        since a batch on another stream may read it next."""
        key = (L, step, dev)
        if key not in self._grids:
            grid = to_device(torch.from_numpy(
                make_qpos_grid(L, self.k, step).astype(np.int64)), dev)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            self._grids[key] = grid
        return self._grids[key]

    def _build_skeleton(self, h, gi, read_len):
        return build_skeleton(
            h["f"][gi], h["pred"][gi], h["qpos"][gi], h["rpos"][gi],
            h["strand"][gi], h["valid"][gi], k=self.k,
            read_len=read_len, ref=self.ref, config=self.config)

    # ------------------------------------------------------- part alignment

    @staticmethod
    def _qdesc(off, L, strand, w0, m, rev):
        """Device-gather descriptor for an oriented-read window:
        element y of the window = flat[q_base + q_step * y],
        complemented when strand == 1. w0 = window start in ORIENTED
        read coordinates, m = window length, rev = emitted reversed
        (left extensions)."""
        first_y = w0 + m - 1 if rev else w0
        first = off + (first_y if strand == 0 else L - 1 - first_y)
        step = -1 if (strand ^ rev) else 1
        return (int(first), step, int(strand))

    # Gap coalescing (lamsa_tpu/pipeline/aln.py _GROUP_SPAN note):
    # consecutive (gap, block) units are coalesced into ONE global DP
    # while the q-span stays under _GROUP_SPAN and the block-end
    # diagonal range under _GROUP_DRIFT (which keeps the W=128 band
    # sound); wider groups fall back to per-unit instances.
    _GROUP_SPAN = 448
    _GROUP_DRIFT = 56

    @staticmethod
    def _group_blocks(qe_b, re_b):
        """Group boundaries over block-end coords: returns (bnds, rng);
        group k spans end(block bnds[k]) -> end(block bnds[k+1]) and
        rng[k] is the group's block-end diagonal range (0 for per-unit
        fallback groups)."""
        n = len(qe_b)
        if n <= 1:
            return np.zeros(1, np.int64), np.zeros(0, np.int64)
        grp = (qe_b - qe_b[0]) // Aligner._GROUP_SPAN
        # last block index of each quantum, always including block n-1
        last = np.flatnonzero(np.concatenate(
            [grp[1:] != grp[:-1], np.ones(1, bool)]))
        d = (re_b - qe_b) - (re_b[0] - qe_b[0])
        bnds = [0]
        rng = []
        for e in last:
            s = bnds[-1]
            if e <= s:
                continue
            seg = d[s:e + 1]
            r = int(seg.max() - seg.min())
            if r > Aligner._GROUP_DRIFT:
                bnds.extend(range(s + 1, e + 1))   # per-unit fallback
                rng.extend([0] * (e - s))
            else:
                bnds.append(int(e))
                rng.append(r)
        return np.asarray(bnds, np.int64), np.asarray(rng, np.int64)

    def _enqueue_parts(self, sk, read_codes, batcher,
                       flat_off: int) -> list[_PendingPart]:
        cfg = self.config
        L = len(read_codes)
        pend = []
        n_parts = len(sk.parts)
        part_list = list(sk.parts) + list(sk.secondaries)
        for pi, part in enumerate(part_list):
            is_secondary = pi >= n_parts
            blocks = anchors_to_blocks(part.anchors, self.k)
            if len(blocks) == 0:
                continue

            # read-space neighbor bounds -> oriented coords
            # (secondaries extend freely within the read)
            read_lo = sk.parts[pi - 1].read_end \
                if 0 < pi < n_parts else 0
            read_hi = sk.parts[pi + 1].read_start \
                if pi < n_parts - 1 else L
            read_lo = min(read_lo, part.read_start)
            read_hi = max(read_hi, part.read_end)
            if part.strand == 0:
                o_lo, o_hi = read_lo, read_hi
            else:
                o_lo, o_hi = L - read_hi, L - read_lo

            q0, r0 = int(blocks[0][0]), int(blocks[0][1])
            ls = max(int(o_lo), q0 - _EXT_CAP)
            qe = int(blocks[-1][0] + blocks[-1][2])
            re_ = int(blocks[-1][1] + blocks[-1][2])
            rs2 = min(int(o_hi), qe + _EXT_CAP)
            tlen_l = min(q0 - ls + EXT_MARGIN, r0)
            tlen_r = min(rs2 - qe + EXT_MARGIN, self.ref.total_len - re_)

            # coalesced spans: group k = end(block bnds[k]) ->
            # end(block bnds[k+1]), one global DP each
            qe_b = blocks[:, 0] + blocks[:, 2]
            re_b = blocks[:, 1] + blocks[:, 2]
            bnds, rng = self._group_blocks(qe_b, re_b)
            s_, e_ = bnds[:-1], bnds[1:]
            qa_ = qe_b[s_]
            ra_ = re_b[s_]
            mlen = qe_b[e_] - qa_
            nlen = re_b[e_] - ra_
            # band routing: a group whose interior diagonal range does
            # not leave _MIN_SLACK drift margin inside the W=128 band
            # rides W=256
            need = np.abs(nlen - mlen) + 1
            minw = np.where((128 - need) // 2 < rng + _MIN_SLACK,
                            256, 0)
            # a unit whose q-gap + trailing anchor exceeds the largest
            # bucket M: emit the gap alone and the anchor as an explicit
            # M run, scored base by base in finalize
            anchors_after = None
            over = mlen > MAX_BUCKET_M
            if over.any():
                STATS.count("dp_oversize_unit_split", int(over.sum()))
                anchors_after = np.where(over, blocks[e_, 2], 0)
                mlen = np.where(over, blocks[e_, 0] - qa_, mlen)
                nlen = np.where(over, blocks[e_, 1] - ra_, nlen)

            def _with_anchors(h0):
                handles = list(range(h0, h0 + len(mlen)))
                if anchors_after is None:
                    return handles
                gh = []
                for i, h in enumerate(handles):
                    gh.append(h)
                    if anchors_after[i]:
                        b = blocks[e_[i]]
                        gh.append(("M", int(anchors_after[i]), int(b[0]),
                                   int(b[1])))
                return gh

            if part.strand == 0:
                q_base = flat_off + qa_
            else:
                q_base = flat_off + (L - 1 - qa_)
            h0 = batcher.add_globals_bulk(
                mlen, nlen, q_base, 1 if part.strand == 0 else -1,
                part.strand, ra_, minw=minw)
            gap_handles = _with_anchors(h0)
            left_handle = batcher.add_extend_desc(
                q0 - ls, tlen_l, cfg.scores.end_bonus,
                self._qdesc(flat_off, L, part.strand, ls, q0 - ls, 1),
                (r0 - 1, -1))
            right_handle = batcher.add_extend_desc(
                rs2 - qe, tlen_r, cfg.scores.end_bonus,
                self._qdesc(flat_off, L, part.strand, qe, rs2 - qe, 0),
                (re_, 1))
            pend.append(_PendingPart(part=part, blocks=blocks,
                                     gap_handles=gap_handles,
                                     left_handle=left_handle,
                                     right_handle=right_handle,
                                     o_lo=o_lo, o_hi=o_hi,
                                     secondary=is_secondary))
        return pend

    def _finalize_read(self, read, read_codes, pend, sk, batcher):
        cfg = self.config
        L = len(read_codes)
        if not pend:
            return [unmapped_record(read.name, read.seq, read.qual)]

        finals = []
        seconds = []
        for pp in pend:
            rec = self._finalize_part(pp, read_codes, sk, batcher, L)
            if rec is not None:
                (seconds if pp.secondary else finals).append(rec)
        if not finals:
            return [unmapped_record(read.name, read.seq, read.qual)]

        # primary = best score; others supplementary
        finals.sort(key=lambda fr: (-fr["score"], fr["read_start"]))
        records = []
        rc_seq = rc_qual = None
        for rank, fr in enumerate(finals):
            flag = 0
            if fr["strand"] == 1:
                flag |= FLAG_REVERSE
            if rank > 0:
                flag |= FLAG_SUPPLEMENTARY
            if fr["strand"] == 0:
                seq, qual = read.seq, read.qual
            else:
                if rc_seq is None:
                    rc_seq = read.seq.translate(_RC_TRANS)[::-1]
                    rc_qual = read.qual[::-1] if read.qual else None
                seq, qual = rc_seq, rc_qual
            sid, local_pos = self.ref.global_to_local(fr["pos"])
            tags = {"NM": fr["nm"], "AS": fr["score"]}
            if fr.get("md"):
                tags["MD"] = fr["md"]
            if cfg.rg_id:
                tags["RG"] = cfg.rg_id
            records.append(SamRecord(
                qname=read.name, flag=flag, rname=self.ref.names[sid],
                pos=local_pos, mapq=fr["mapq"], cigar=fr["cigar"], seq=seq,
                qual=qual, tags=tags))
        if len(records) > 1:
            for i, rec in enumerate(records):
                others = [r.sa_item() for j, r in enumerate(records)
                          if j != i]
                rec.tags["SA"] = ";".join(others) + ";"
        if sk.alt_score > 0:
            records[0].tags["XS"] = sk.alt_score
        # secondary alignments (0x100): rejected overlapping chains
        for fr in seconds:
            sid, local_pos = self.ref.global_to_local(fr["pos"])
            flag = FLAG_SECONDARY | (FLAG_REVERSE if fr["strand"] else 0)
            tags = {"NM": fr["nm"], "AS": fr["score"]}
            records.append(SamRecord(
                qname=read.name, flag=flag, rname=self.ref.names[sid],
                pos=local_pos, mapq=0, cigar=fr["cigar"], seq="",
                qual=None, tags=tags))
        if sk.events and any(e["type"] != "gap" for e in sk.events):
            sv = ",".join(e["type"] for e in sk.events if e["type"] != "gap")
            for rec in records:
                rec.tags["sv"] = sv
        return records

    def _finalize_part(self, pp, read_codes, sk, batcher, L):
        cfg = self.config
        part = pp.part
        qseq = read_codes if part.strand == 0 else _revcomp_codes(read_codes)
        blocks = pp.blocks

        # stitch the part's CIGAR as packed uint32 runs
        score = 0
        left = batcher.result(pp.left_handle)
        right = batcher.result(pp.right_handle)

        q0, r0 = int(blocks[0][0]), int(blocks[0][1])
        qs_cov = q0 - left.q_used
        pos = r0 - left.t_used
        score += left.score

        # stitch: left_ext | M(block 0) | span DPs | right_ext —
        # interior anchors live inside the coalesced span results
        la0 = int(blocks[0, 2])
        segs = [left.cigar[::-1],
                np.array([(la0 << 4) | OP_M], np.uint32)]
        run_score, subs = self._anchor_run_score(qseq, q0, r0, la0)
        score += run_score
        for h in pp.gap_handles:
            if isinstance(h, tuple):      # ("M", len, q, r): explicit
                _, ln, qa, ra = h         # anchor run after an oversize
                segs.append(np.array([(ln << 4) | OP_M], np.uint32))
                run_score, n_sub = self._anchor_run_score(qseq, qa, ra, ln)
                score += run_score
                subs += n_sub
                continue
            g = batcher.result(h)
            segs.append(g.cigar)
            score += g.score

        if subs:
            STATS.count("anchor_subs", subs)
        qe = int(blocks[-1][0] + blocks[-1][2])
        segs.append(right.cigar)
        score += right.score
        qe_cov = qe + right.q_used

        merged = merge_runs(np.concatenate(segs))
        if not ((merged & 0xF) == OP_M).any():
            return None
        # canonical SAM boundaries: boundary I -> soft clip, boundary D
        # dropped (advancing pos on the left). AS keeps the DP score;
        # NM/MD are computed after.
        merged, pos, qs_cov, qe_cov = _trim_boundary_indels(
            merged, pos, qs_cov, qe_cov)
        if merged is None:
            return None

        ref_len = cigar_ref_len(merged)
        q_win = qseq[qs_cov:qe_cov]
        t_win = self.ref.codes[pos:pos + ref_len]
        nm = compute_nm(q_win, t_win, merged)
        md = None
        if cfg.emit_md:
            md = md_tag(q_win, t_win, merged)

        clips = [merged]
        if qs_cov > 0:
            clips.insert(0, np.array([(qs_cov << 4) | OP_S], np.uint32))
        if qe_cov < L:
            clips.append(np.array([((L - qe_cov) << 4) | OP_S], np.uint32))
        cigar = np.concatenate(clips) if len(clips) > 1 else merged

        mapq = self._mapq(part, sk)
        # read-space span of the final alignment
        if part.strand == 0:
            rs, re_ = qs_cov, qe_cov
        else:
            rs, re_ = L - qe_cov, L - qs_cov
        return {"strand": part.strand, "pos": pos, "cigar": cigar,
                "score": score, "nm": nm, "md": md, "mapq": mapq,
                "read_start": rs, "read_end": re_}

    def _anchor_run_score(self, qseq, q, r, n):
        """(score, substituted bases) of an anchor run of n bases at
        oriented read position q and reference position r, base by base
        as the DP scores a diagonal step (a code >= 4 never matches). A
        k-mer anchor is exact; an FM 1-edit anchor may carry a
        substitution (ops/fm.py edit1_tracks)."""
        sc = self.config.scores
        a = qseq[q:q + n]
        eq = int(np.count_nonzero((a == self.ref.codes[r:r + n]) & (a < 4)))
        return eq * sc.match - (n - eq) * sc.mismatch, n - eq

    def _mapq(self, part, sk) -> int:
        """MAPQ from chain-score margin: 60 * (1 - alt/score) scaled by
        anchor count, clamped to [0, 60] (lamsa_tpu/pipeline/aln.py
        _mapq has the calibration)."""
        s1 = max(part.score, 1)
        s2 = max(sk.alt_score, 0)
        if s2 >= s1:
            return 0
        m = 60.0 * (1.0 - s2 / s1) * min(1.0, part.n_anchors / 16.0)
        return int(max(0, min(60, round(m))))


def align_reads(ref: PackedReference, index: KmerIndex | FmIndex, reads,
                config: AlignConfig | None = None,
                batch_size: int | None = None,
                aligner: "Aligner | None" = None,
                device="cuda", mesh=None):
    """Align an iterable of reads, yielding SAM record lists per read in
    input order, one batch at a time on the caller's thread.

    aligner — reuse a prepared Aligner (keeps the device state); its
    device or mesh then decides. mesh — device entries for data
    parallelism (Aligner)."""
    cfg = config or AlignConfig()
    aligner = aligner or Aligner(ref, index, cfg, device=device, mesh=mesh)
    bs = batch_size or cfg.batch_reads
    batch: list = []
    for r in reads:
        batch.append(r)
        if len(batch) >= bs:
            yield from aligner.align_batch(batch)
            batch = []
    if batch:
        yield from aligner.align_batch(batch)
