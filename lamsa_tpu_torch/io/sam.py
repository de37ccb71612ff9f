# Copy of lamsa_tpu/io/sam.py; only its import lines differ.
"""SAM output (host side).

Equivalent of the reference's in-aln SAM writer (SURVEY.md section 2b
"SAM writer"): flags, CIGAR with soft clips, ``SA:Z`` linking of split
parts, ``NM``/``AS`` tags, MAPQ. Split-alignment semantics follow
SURVEY.md section 1: one primary record per read part-set plus
supplementary records (flag 0x800), every part listing all *other* parts
in its ``SA:Z`` tag.

SAM spec reference: samtools/hts-specs SAMv1 (public).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FLAG_UNMAPPED", "FLAG_REVERSE", "FLAG_SECONDARY", "FLAG_SUPPLEMENTARY",
    "SamRecord", "sam_header", "format_sam_record", "cigar_to_string",
    "cigar_ref_len", "cigar_query_len", "cigar_pairs", "merge_runs",
    "CIGAR_OPS",
]

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

# Numeric op codes used across the framework (BAM convention).
CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)

_CONSUMES_REF = {OP_M, OP_D, OP_N, OP_EQ, OP_X}
_CONSUMES_QUERY = {OP_M, OP_I, OP_S, OP_EQ, OP_X}


def cigar_pairs(cigar):
    """Normalize either CIGAR representation to (op, len) pairs.

    Two forms coexist: [(op, len), ...] lists (oracle/spec code, tests)
    and packed uint32 run arrays ``(len << 4) | op`` (the hot path —
    native decoders hand these back and the pipeline stitches them
    without per-run Python objects)."""
    if isinstance(cigar, np.ndarray):
        return zip((cigar & 0xF).tolist(), (cigar >> 4).tolist())
    return iter(cigar)


def merge_runs(runs: np.ndarray) -> np.ndarray:
    """Drop zero-length runs and merge adjacent same-op runs of a packed
    uint32 run array (vectorized equivalent of cigar_to_string's merge
    loop)."""
    runs = runs[(runs >> 4) > 0]
    if len(runs) <= 1:
        return runs
    ops = runs & 0xF
    starts = np.concatenate([[0], np.flatnonzero(ops[1:] != ops[:-1]) + 1])
    lens = np.add.reduceat(runs >> np.uint32(4), starts)
    return ((lens << np.uint32(4)) | ops[starts]).astype(np.uint32)


def cigar_to_string(cigar) -> str:
    """CIGAR (either representation) -> SAM string. Merges adjacent
    same ops."""
    out = []
    for op, ln in cigar_pairs(cigar):
        if ln <= 0:
            continue
        if out and out[-1][0] == op:
            out[-1][1] += ln
        else:
            out.append([op, ln])
    return "".join(f"{ln}{CIGAR_OPS[op]}" for op, ln in out) or "*"


def cigar_from_string(s: str) -> list[tuple[int, int]]:
    out, num = [], 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((CIGAR_OPS.index(ch), num))
            num = 0
    return out


def cigar_ref_len(cigar) -> int:
    return sum(ln for op, ln in cigar_pairs(cigar) if op in _CONSUMES_REF)


def cigar_query_len(cigar) -> int:
    return sum(ln for op, ln in cigar_pairs(cigar) if op in _CONSUMES_QUERY)


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int                  # 0-based; rendered 1-based
    mapq: int
    cigar: object             # [(op, len), ...] or packed uint32 runs
    seq: str
    qual: str | None = None
    tags: dict = dataclasses.field(default_factory=dict)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    def sa_item(self) -> str:
        """This record as one ``SA:Z`` element: rname,pos,strand,CIGAR,mapq,NM."""
        strand = "-" if self.is_reverse else "+"
        nm = self.tags.get("NM", 0)
        return (f"{self.rname},{self.pos + 1},{strand},"
                f"{cigar_to_string(self.cigar)},{self.mapq},{nm}")


def _format_tag(key: str, value) -> str:
    if isinstance(value, int):
        return f"{key}:i:{value}"
    if isinstance(value, float):
        return f"{key}:f:{value:g}"
    return f"{key}:Z:{value}"


_TAG_ORDER = ("NM", "MD", "AS", "XS", "SA", "RG", "tp", "cm")


def format_sam_record(rec: SamRecord) -> str:
    cig = cigar_to_string(rec.cigar)
    qual = rec.qual if rec.qual else "*"
    seq = rec.seq if rec.seq else "*"
    fields = [
        rec.qname, str(rec.flag), rec.rname, str(rec.pos + 1),
        str(rec.mapq), cig, "*", "0", "0", seq, qual,
    ]
    for k in _TAG_ORDER:
        if k in rec.tags:
            fields.append(_format_tag(k, rec.tags[k]))
    for k in sorted(rec.tags):
        if k not in _TAG_ORDER:
            fields.append(_format_tag(k, rec.tags[k]))
    return "\t".join(fields)


def unmapped_record(qname: str, seq: str, qual: str | None) -> SamRecord:
    return SamRecord(qname=qname, flag=FLAG_UNMAPPED, rname="*", pos=-1,
                     mapq=0, cigar=[], seq=seq, qual=qual)


def sam_header(ref, prog_args: str = "", rg_id: str | None = None) -> str:
    """@HD/@SQ/@PG header lines for a PackedReference."""
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    for i, name in enumerate(ref.names):
        lines.append(f"@SQ\tSN:{name}\tLN:{ref.seq_len(i)}")
    if rg_id:
        lines.append(f"@RG\tID:{rg_id}")
    from lamsa_tpu_torch import __version__
    lines.append("@PG\tID:lamsa_tpu\tPN:lamsa_tpu"
                 f"\tVN:{__version__}\tCL:{prog_args}")
    return "\n".join(lines)
