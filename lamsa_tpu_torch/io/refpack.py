# Copy of lamsa_tpu/io/refpack.py; only its import lines differ.
"""Packed reference (bntseq equivalent).

The reference tool keeps a 2-bit packed genome plus name/offset tables in
BWA-lineage ``.pac/.ann/.amb`` files (SURVEY.md section 2b "Ref packing",
section 3.1). We keep the same capability TPU-first:

  * on disk: 2-bit packed bases (``ref.2bit.npy``) + ambiguity (N) run
    list + JSON name/offset table, all inside a ``<ref>.lti/`` directory
    written by ``lamsa index`` (SURVEY.md section 3.1);
  * in memory / HBM: the concatenated forward genome as one ``uint8``
    nt4-code array — gather-friendly for seeding and for streaming target
    windows into the banded-DP kernel. N bases are stored as code 4 on
    the host but randomized-to-A in the 2-bit pack (standard bntseq
    behavior is random; we use a fixed base so packing is deterministic)
    and masked via the ambiguity list when scoring.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from lamsa_tpu_torch.io.fasta import encode_seq, read_fastx

_META_NAME = "meta.json"
_PACK_NAME = "ref2bit.npy"
_AMB_NAME = "amb.npy"


@dataclasses.dataclass
class PackedReference:
    """Concatenated multi-sequence reference with name/offset tables."""

    names: list[str]
    offsets: np.ndarray      # int64[S+1] cumulative start of each sequence
    codes: np.ndarray        # uint8[L] nt4 codes of concatenated forward ref
    amb_runs: np.ndarray     # int64[K,2] (start,len) runs of N in `codes`

    @property
    def total_len(self) -> int:
        return int(self.offsets[-1])

    @property
    def num_seqs(self) -> int:
        return len(self.names)

    def seq_len(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def global_to_local(self, pos: int) -> tuple[int, int]:
        """Concatenated coordinate -> (sequence index, 0-based offset)."""
        i = int(np.searchsorted(self.offsets, pos, side="right")) - 1
        i = max(0, min(i, self.num_seqs - 1))
        return i, int(pos - self.offsets[i])

    def local_to_global(self, seq_index: int, pos: int) -> int:
        return int(self.offsets[seq_index]) + pos

    def crosses_boundary(self, start: int, length: int) -> bool:
        """True if [start, start+length) spans two reference sequences."""
        i0, _ = self.global_to_local(start)
        i1, _ = self.global_to_local(start + max(length, 1) - 1)
        return i0 != i1

    # ------------------------------------------------------------------ build

    @classmethod
    def from_fasta(cls, path: str) -> "PackedReference":
        names, lens, chunks = [], [], []
        for rec in read_fastx(path):
            names.append(rec.name)
            codes = np.frombuffer(encode_seq(rec.seq), dtype=np.uint8)
            lens.append(len(codes))
            chunks.append(codes)
        if not names:
            raise ValueError(f"{path}: empty FASTA")
        offsets = np.zeros(len(names) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(lens)
        codes = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
        amb = _find_runs(codes >= 4)
        return cls(names=names, offsets=offsets, codes=codes, amb_runs=amb)

    # ------------------------------------------------------------- persistence

    def save(self, index_dir: str) -> None:
        os.makedirs(index_dir, exist_ok=True)
        meta = {
            "format": "lamsa_tpu_ref_v1",
            "names": self.names,
            "offsets": self.offsets.tolist(),
        }
        with open(os.path.join(index_dir, _META_NAME), "w") as fh:
            json.dump(meta, fh)
        np.save(os.path.join(index_dir, _PACK_NAME), _pack_2bit(self.codes))
        np.save(os.path.join(index_dir, _AMB_NAME), self.amb_runs)

    @classmethod
    def load(cls, index_dir: str) -> "PackedReference":
        with open(os.path.join(index_dir, _META_NAME)) as fh:
            meta = json.load(fh)
        if meta.get("format") != "lamsa_tpu_ref_v1":
            raise ValueError(f"{index_dir}: not a lamsa_tpu reference pack")
        offsets = np.asarray(meta["offsets"], dtype=np.int64)
        total = int(offsets[-1])
        codes = _unpack_2bit(
            np.load(os.path.join(index_dir, _PACK_NAME)), total)
        amb = np.load(os.path.join(index_dir, _AMB_NAME))
        for start, length in amb:
            codes[start:start + length] = 4
        return cls(names=meta["names"], offsets=offsets, codes=codes,
                   amb_runs=amb)


def _find_runs(mask: np.ndarray) -> np.ndarray:
    """Boolean mask -> int64[K,2] array of (start, length) runs of True."""
    if not mask.any():
        return np.zeros((0, 2), dtype=np.int64)
    padded = np.concatenate([[False], mask, [False]])
    diff = np.diff(padded.astype(np.int8))
    starts = np.nonzero(diff == 1)[0]
    ends = np.nonzero(diff == -1)[0]
    return np.stack([starts, ends - starts], axis=1).astype(np.int64)


def _pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 nt4 codes -> 4-bases-per-byte pack. N (4) packs as A (0)."""
    c = np.where(codes >= 4, 0, codes).astype(np.uint8)
    pad = (-len(c)) % 4
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6))


def _unpack_2bit(packed: np.ndarray, total_len: int) -> np.ndarray:
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = packed & 3
    out[:, 1] = (packed >> 2) & 3
    out[:, 2] = (packed >> 4) & 3
    out[:, 3] = (packed >> 6) & 3
    return out.reshape(-1)[:total_len].copy()
