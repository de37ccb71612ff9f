# Copy of lamsa_tpu/index/fmindex.py; only its import lines differ.
"""FM-index: BWT + sampled Occ + sampled SA (host build, device search).

The whole-genome replacement for the sorted k-mer index: GRCh38-scale
position tables (~13 GB) exceed HBM, while the FM-index fits in ~2.3 GB
(SURVEY.md section 7 step 2a — "FM-index backward search on-device ...
partition each seed into exact pieces (pigeonhole), exact-match each
piece with FM backward search — pure gathers"). The reference shipped
GEM, an FM-index mapper, as an opaque binary; this is the TPU-native
equivalent with the classic BWA-style layout:

  * bwt2:    uint32[ceil(n/16)]   2-bit packed $-less BWT (base b of
             word w at bits 2b..2b+1, row = 16 w + b)
  * occ:     uint32[n/64 + 1, 4]  checkpoint counts per 64 BWT chars
  * value-sampled SA (rows whose SA value is a multiple of SA_RATE —
    guarantees every LF-walk resolves within SA_RATE steps, which the
    device resolver relies on for its fixed trip count):
      ssa_marks:  uint32 bitvector over full-BWT rows
      ssa_rankcp: uint32 rank checkpoints every 64 rows
      ssa_pos:    uint32 compacted SA values of marked rows
  * counts C, primary (row of the sentinel in the full BWT)

Row space: n+1 rows including the sentinel row. rank(c, i) counts c in
full-BWT rows [0, i) excluding the sentinel row (index adjustment
i' = i - (i > primary)). Backward step: lo' = C[c] + rank(c, lo).
N bases are substituted with a position-hashed base for indexing (the
reference's bntseq lineage uses random substitution [P]); real N
handling happens at verification/extension scoring.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

_META = "fm_meta.json"
# build chunk sizes (module-level so tests can shrink them to
# exercise chunk boundaries); SSA chunk must be 64-aligned
_OCC_CHUNK = 64 << 20
_SSA_CHUNK = 128 << 20
OCC_RATE = 64                 # fixed (device rank assumes 64-base blocks)
SA_RATE = 16                  # default; instances carry their own rate


def substitute_n(codes: np.ndarray) -> np.ndarray:
    """Deterministic position-hashed substitution of N (code 4)."""
    out = np.asarray(codes, np.uint8).copy()
    idx = np.nonzero(out >= 4)[0]
    if len(idx):
        h = (idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) \
            >> np.uint64(62)
        out[idx] = h.astype(np.uint8)
    return out


@dataclasses.dataclass
class FmIndex:
    n: int                   # text length (sentinel excluded)
    primary: int             # sentinel row in the full BWT
    counts: np.ndarray       # int64[4] symbol counts
    C: np.ndarray            # int64[5] C[c] = 1 + sum(counts[:c])
    bwt2: np.ndarray         # uint32 packed $-less BWT
    occ: np.ndarray          # uint32[ncp, 4]
    ssa_marks: np.ndarray    # uint32 bitvector, 32 rows/word
    ssa_rankcp: np.ndarray   # uint32, marks before row 64*cp
    ssa_pos: np.ndarray      # uint32 SA values of marked rows
    sa_rate: int = SA_RATE

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, codes: np.ndarray, sa_rate: int = SA_RATE) -> "FmIndex":
        import time as _time

        from lamsa_tpu_torch import native

        t0 = _time.time()

        def _phase(name):
            import sys as _sys
            print(f"[fmindex build] {name} ({_time.time() - t0:.0f}s)",
                  file=_sys.stderr, flush=True)

        codes = substitute_n(codes)
        n = len(codes)
        sa_full = native.suffix_array_full(codes)         # uint32[n+1]
        _phase("suffix array")
        bwt, primary = native.bwt_from_sa(codes, sa_full)  # uint8[n]
        _phase("bwt")
        counts = np.bincount(bwt, minlength=4).astype(np.int64)
        C = np.zeros(5, np.int64)
        C[1:] = np.cumsum(counts)
        C += 1                                             # sentinel row

        # pack 16 bases per uint32 — CHUNKED: a whole-array uint32
        # upcast plus the shift temporary cost 2 x 12.4 GB at GRCh38
        # scale, the single biggest RSS spike of the build (measured
        # 46 GB peak round 5; ~25 GB with this loop)
        nwords = (n + 15) // 16
        bwt2 = np.empty(nwords, np.uint32)
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
        CHW = _OCC_CHUNK            # bases per chunk, 16-aligned
        for s0 in range(0, n, CHW):
            blk = bwt[s0:s0 + CHW]
            pad = (-len(blk)) % 16
            if pad:
                blk = np.concatenate([blk, np.zeros(pad, np.uint8)])
            b = blk.astype(np.uint32).reshape(-1, 16)
            bwt2[s0 // 16:s0 // 16 + len(b)] = \
                np.bitwise_or.reduce(b << shifts, axis=1)
        _phase("bwt2 pack")

        # occ checkpoints every OCC_RATE bwt chars — chunked so genome-
        # scale builds (GRCh38: n = 3.1e9) avoid (4, n) temporaries
        ncp = n // OCC_RATE + 1
        occ = np.zeros((ncp, 4), np.uint32)
        CH = _OCC_CHUNK
        running = np.zeros(4, np.uint64)
        for s0 in range(0, n, CH):
            blk = bwt[s0:s0 + CH]
            cp0 = s0 // OCC_RATE
            # per-char counts within each OCC_RATE block of this chunk
            per = np.zeros((4, (len(blk) + OCC_RATE - 1) // OCC_RATE),
                           np.uint32)
            for c in range(4):
                eq = (blk == c).astype(np.uint32)
                pad = (-len(eq)) % OCC_RATE
                if pad:
                    eq = np.concatenate([eq, np.zeros(pad, np.uint32)])
                per[c] = eq.reshape(-1, OCC_RATE).sum(axis=1)
            csum = np.cumsum(per, axis=1, dtype=np.uint64) \
                + running[:, None]
            hi = min(cp0 + per.shape[1], ncp - 1)
            occ[cp0 + 1:hi + 1] = csum[:, :hi - cp0].T.astype(np.uint32)
            running = csum[:, -1]
        _phase("occ checkpoints")

        # value-sampled SA (chunked for the same reason)
        nr = n + 1
        nw = (nr + 31) // 32
        ssa_marks = np.zeros(nw, np.uint32)
        ncp2 = nr // 64 + 1
        ssa_rankcp = np.zeros(ncp2, np.uint32)
        pos_chunks = []
        total_marks = 0
        CH2 = _SSA_CHUNK
        wshift = np.arange(32, dtype=np.uint32)[None, :]
        for s0 in range(0, nr, CH2):
            sa_blk = sa_full[s0:s0 + CH2]
            marked = (sa_blk % sa_rate) == 0
            pos_chunks.append(sa_blk[marked].astype(np.uint32))
            pad = (-len(marked)) % 64
            mk = np.concatenate([marked, np.zeros(pad, bool)]) if pad \
                else marked
            bits = mk.reshape(-1, 32).astype(np.uint32)
            words = np.bitwise_or.reduce(bits << wshift, axis=1)
            # the 64-alignment pad can produce one all-zero word beyond
            # the destination when nr % 64 is in [1, 32] — clip it
            w0 = s0 // 32
            words = words[:nw - w0]
            ssa_marks[w0:w0 + len(words)] = words
            blk_counts = mk.reshape(-1, 64).sum(axis=1, dtype=np.uint64)
            csum2 = np.cumsum(blk_counts) + total_marks
            cp0 = s0 // 64
            hi2 = min(cp0 + len(blk_counts), ncp2 - 1)
            ssa_rankcp[cp0 + 1:hi2 + 1] = \
                csum2[:hi2 - cp0].astype(np.uint32)
            total_marks = int(csum2[-1])
        ssa_pos = np.concatenate(pos_chunks) if pos_chunks \
            else np.zeros(0, np.uint32)
        _phase("sampled SA")
        return cls(n=n, primary=int(primary), counts=counts, C=C,
                   bwt2=bwt2, occ=occ, ssa_marks=ssa_marks,
                   ssa_rankcp=ssa_rankcp, ssa_pos=ssa_pos,
                   sa_rate=sa_rate)

    # ------------------------------------------------------ host queries

    def bwt_char(self, row: int) -> int:
        """Char of full-BWT row (row != primary)."""
        r = row - (row > self.primary)
        return (int(self.bwt2[r >> 4]) >> (2 * (r & 15))) & 3

    def rank(self, c: int, i: int) -> int:
        """# of c in full-BWT rows [0, i), sentinel row excluded."""
        ip = i - (i > self.primary)
        cp = ip // OCC_RATE
        r = int(self.occ[cp, c])
        for x in range(cp * OCC_RATE, ip):
            b = (int(self.bwt2[x >> 4]) >> (2 * (x & 15))) & 3
            r += b == c
        return r

    def backward_search(self, piece: np.ndarray):
        """Exact search; returns (lo, hi) row interval (host reference
        implementation for tests)."""
        lo, hi = 0, self.n + 1
        for c in piece[::-1]:
            c = int(c)
            if c >= 4:
                return 0, 0
            lo = int(self.C[c]) + self.rank(c, lo)
            hi = int(self.C[c]) + self.rank(c, hi)
            if lo >= hi:
                return 0, 0
        return lo, hi

    def _marked(self, row: int) -> bool:
        return bool((int(self.ssa_marks[row >> 5]) >> (row & 31)) & 1)

    def _mark_rank(self, row: int) -> int:
        """# of marked rows in [0, row)."""
        cp = row >> 6
        r = int(self.ssa_rankcp[cp])
        for x in range(cp << 6, row):
            r += (int(self.ssa_marks[x >> 5]) >> (x & 31)) & 1
        return r

    def resolve_row(self, row: int) -> int:
        """Row -> text position via LF-walk to a value-sampled row
        (terminates within SA_RATE steps by construction)."""
        steps = 0
        r = row
        while True:
            if r == self.primary:
                return steps
            if self._marked(r):
                return (int(self.ssa_pos[self._mark_rank(r)]) + steps) \
                    % (self.n + 1)
            c = self.bwt_char(r)
            r = int(self.C[c]) + self.rank(c, r)
            steps += 1
            assert steps <= self.sa_rate, "value-sampled walk overran"

    # ------------------------------------------------------- persistence

    def save(self, index_dir: str) -> None:
        os.makedirs(index_dir, exist_ok=True)
        with open(os.path.join(index_dir, _META), "w") as fh:
            json.dump({"format": "lamsa_tpu_fm_v1", "n": self.n,
                       "primary": self.primary,
                       "counts": self.counts.tolist(),
                       "occ_rate": OCC_RATE, "sa_rate": self.sa_rate},
                      fh)
        np.save(os.path.join(index_dir, "fm_bwt2.npy"), self.bwt2)
        np.save(os.path.join(index_dir, "fm_occ.npy"), self.occ)
        np.save(os.path.join(index_dir, "fm_ssa_marks.npy"), self.ssa_marks)
        np.save(os.path.join(index_dir, "fm_ssa_rankcp.npy"),
                self.ssa_rankcp)
        np.save(os.path.join(index_dir, "fm_ssa_pos.npy"), self.ssa_pos)

    @classmethod
    def load(cls, index_dir: str) -> "FmIndex":
        with open(os.path.join(index_dir, _META)) as fh:
            meta = json.load(fh)
        if meta.get("format") != "lamsa_tpu_fm_v1":
            raise ValueError(f"{index_dir}: not a lamsa_tpu FM index")
        counts = np.asarray(meta["counts"], np.int64)
        C = np.zeros(5, np.int64)
        C[1:] = np.cumsum(counts)
        C += 1
        ld = lambda name: np.load(os.path.join(index_dir, name))
        return cls(n=meta["n"], primary=meta["primary"], counts=counts,
                   C=C, bwt2=ld("fm_bwt2.npy"), occ=ld("fm_occ.npy"),
                   ssa_marks=ld("fm_ssa_marks.npy"),
                   ssa_rankcp=ld("fm_ssa_rankcp.npy"),
                   ssa_pos=ld("fm_ssa_pos.npy"),
                   sa_rate=meta.get("sa_rate", SA_RATE))

    @staticmethod
    def exists(index_dir: str) -> bool:
        return os.path.exists(os.path.join(index_dir, _META))
