# Copy of lamsa_tpu/index/fmindex.py, apart from its import lines and
# build, which gives the same arrays from index/fm_build.py: the copy's
# suffix sort and numpy passes ran on one core.
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
        from lamsa_tpu_torch.index import fm_build

        return cls(**fm_build.build(codes, sa_rate))

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
