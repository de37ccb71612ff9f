# Copy of lamsa_tpu/io/fasta.py; only its import lines differ.
"""FASTA/FASTQ reading (host side).

Equivalent of the reference's klib ``kseq.h`` streaming parser
(SURVEY.md section 2b "klib utilities"): gzip-transparent FASTA/FASTQ
with multi-line sequence support. Parsing is off the hot path (the
batch pipeline overlaps it with device work); encoding is a single
``bytes.translate`` per read, already C-speed.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator

# Base encoding shared across the whole framework: A=0 C=1 G=2 T=3, N/other=4.
# Matches the 2-bit nt4 convention of the BWA/bntseq lineage the reference
# builds on (SURVEY.md section 2b "Ref packing").
_NT4 = bytearray([4]) * 256
for _i, _c in enumerate(b"ACGT"):
    _NT4[_c] = _i
    _NT4[_c | 0x20] = _i  # lowercase
NT4_TABLE = bytes(_NT4)

COMP4 = bytes([3, 2, 1, 0, 4])  # complement in nt4 space
BASES = "ACGTN"


def encode_seq(seq: str | bytes) -> bytes:
    """ASCII sequence -> nt4 codes (one byte per base)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return seq.translate(NT4_TABLE)


def decode_seq(codes) -> str:
    return "".join(BASES[c] for c in codes)


def revcomp4(codes: bytes) -> bytes:
    """Reverse complement in nt4 space."""
    return bytes(COMP4[c] for c in reversed(codes))


@dataclasses.dataclass
class FastxRecord:
    name: str
    seq: str
    qual: str | None = None
    comment: str | None = None

    def __len__(self):
        return len(self.seq)


def _open_text(path: str) -> io.TextIOBase:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a FASTA or FASTQ file (optionally gzipped)."""
    with _open_text(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            yield from _read_fasta_body(fh)
        elif first == "@":
            yield from _read_fastq_body(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _split_header(line: str):
    line = line.rstrip("\n")
    if " " in line:
        name, comment = line.split(" ", 1)
    elif "\t" in line:
        name, comment = line.split("\t", 1)
    else:
        name, comment = line, None
    return name, comment


def _read_fasta_body(fh) -> Iterator[FastxRecord]:
    # fh positioned just after the first '>'
    header = fh.readline()
    while header:
        name, comment = _split_header(header)
        chunks = []
        line = fh.readline()
        while line and not line.startswith(">"):
            chunks.append(line.strip())
            line = fh.readline()
        yield FastxRecord(name=name, seq="".join(chunks), comment=comment)
        header = line[1:] if line else ""


def _read_fastq_body(fh) -> Iterator[FastxRecord]:
    # fh positioned just after the first '@'
    header = fh.readline()
    while header:
        name, comment = _split_header(header)
        seq_chunks = []
        line = fh.readline()
        while line and not line.startswith("+"):
            seq_chunks.append(line.strip())
            line = fh.readline()
        seq = "".join(seq_chunks)
        qual_chunks: list[str] = []
        qlen = 0
        while qlen < len(seq):
            line = fh.readline()
            if not line:
                break
            q = line.strip()
            qual_chunks.append(q)
            qlen += len(q)
        qual = "".join(qual_chunks)
        if len(qual) != len(seq):
            raise ValueError(
                f"malformed FASTQ record {name!r}: seq len {len(seq)} != "
                f"qual len {len(qual)}")
        yield FastxRecord(name=name, seq=seq, qual=qual, comment=comment)
        nxt = fh.readline()
        if not nxt:
            return
        if not nxt.startswith("@"):
            raise ValueError(f"malformed FASTQ near record {name!r}")
        header = nxt[1:]


def read_fasta(path: str) -> list[FastxRecord]:
    return list(read_fastx(path))


def write_fasta(path: str, records) -> None:
    with open(path, "w") as fh:
        for r in records:
            fh.write(f">{r.name}\n{r.seq}\n")


def write_fastq(path: str, records) -> None:
    with open(path, "w") as fh:
        for r in records:
            q = r.qual if r.qual else "I" * len(r.seq)
            fh.write(f"@{r.name}\n{r.seq}\n+\n{q}\n")
