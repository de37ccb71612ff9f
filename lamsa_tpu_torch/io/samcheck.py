# Copy of lamsa_tpu/io/samcheck.py; only its import lines differ.
"""SAM conformance self-validation.

Bit-exact SAM equality against the reference LAMSA binary is
unverifiable in this environment (the reference mount is empty,
SURVEY.md section 0), so this module checks every invariant the SAM
spec (samtools/hts-specs SAMv1) and the split-alignment output
semantics (SURVEY.md section 1) impose on a record set:

  * CIGAR well-formedness (positive runs, no adjacent same-op runs,
    soft clips only at the ends) and query-length consistency
    (clips + M + I == len(SEQ));
  * reference span in bounds: 0 <= pos and pos + ref_len(CIGAR) <=
    the @SQ length of rname;
  * NM re-derived from the reference codes equals the NM:i tag, and
    MD:Z (when present) re-derives identically;
  * flag structure: exactly one primary (neither 0x100 nor 0x800) per
    mapped read, supplementaries carry 0x800, secondaries 0x100;
  * SA:Z round-trip: every SA item of every part is exactly the
    sa_item() of another primary/supplementary record of the same
    read, every other part appears, and no record lists itself.

Checks return a list of human-readable error strings (empty = clean)
so tests can assert on the whole batch at once and print every
violation.
"""

from __future__ import annotations

import numpy as np

from lamsa_tpu_torch.io.fasta import BASES, encode_seq
from lamsa_tpu_torch.io.sam import (FLAG_REVERSE, FLAG_SECONDARY,
                                    FLAG_SUPPLEMENTARY, FLAG_UNMAPPED, OP_D,
                                    OP_I, OP_M, OP_S, cigar_pairs,
                                    cigar_query_len, cigar_ref_len,
                                    cigar_to_string)


def _cigar_shape_errors(pairs, where):
    errs = []
    if not pairs:
        errs.append(f"{where}: empty CIGAR on mapped record")
        return errs
    for i, (op, ln) in enumerate(pairs):
        if ln <= 0:
            errs.append(f"{where}: non-positive run {ln} at {i}")
        if op not in (OP_M, OP_I, OP_D, OP_S):
            errs.append(f"{where}: unexpected op {op} at {i}")
        if op == OP_S and i not in (0, len(pairs) - 1):
            errs.append(f"{where}: interior soft clip at {i}")
        if i and pairs[i - 1][0] == op:
            errs.append(f"{where}: adjacent same-op runs at {i}")
    core = [op for op, _ in pairs if op != OP_S]
    if core and (core[0] != OP_M or core[-1] != OP_M):
        errs.append(f"{where}: alignment does not start/end with M")
    return errs


def _nm_md_from_ref(q, t, pairs):
    """(NM, MD) re-derived by walking the CIGAR over query codes q and
    reference codes t (t starts at the record's pos)."""
    nm = 0
    md = []
    run = 0
    i = j = 0
    for op, ln in pairs:
        if op == OP_M:
            qs, ts = q[i:i + ln], t[j:j + ln]
            bad = (qs != ts) | (qs >= 4) | (ts >= 4)
            nm += int(bad.sum())
            for x in range(ln):
                if bad[x]:
                    md.append(str(run))
                    run = 0
                    md.append(BASES[int(ts[x])])
                else:
                    run += 1
            i += ln
            j += ln
        elif op == OP_I:
            nm += ln
            i += ln
        elif op == OP_D:
            nm += ln
            md.append(str(run))
            run = 0
            md.append("^" + "".join(BASES[int(c)] for c in t[j:j + ln]))
            j += ln
        else:                                   # soft clip
            i += ln
    md.append(str(run))
    return nm, "".join(md)


def validate_read_records(recs, ref) -> list[str]:
    """Validate all SAM records emitted for ONE read against a
    PackedReference. Returns error strings (empty list = conformant)."""
    errs: list[str] = []
    if not recs:
        return ["no records emitted"]
    qname = recs[0].qname
    unmapped = [r for r in recs if r.flag & FLAG_UNMAPPED]
    if unmapped:
        if len(recs) != 1:
            errs.append(f"{qname}: unmapped read with {len(recs)} records")
        return errs

    parts = [r for r in recs
             if not r.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)]
    if len(parts) != 1:
        errs.append(f"{qname}: {len(parts)} primary records (want 1)")
    name_to_sid = {n: i for i, n in enumerate(ref.names)}

    for r in recs:
        kind = ("sec" if r.flag & FLAG_SECONDARY
                else "sup" if r.flag & FLAG_SUPPLEMENTARY else "pri")
        where = f"{qname}/{kind}@{r.rname}:{r.pos + 1}"
        pairs = list(cigar_pairs(r.cigar))
        errs += _cigar_shape_errors(pairs, where)
        if r.rname not in name_to_sid:
            errs.append(f"{where}: unknown rname")
            continue
        sid = name_to_sid[r.rname]
        if r.pos < 0 or r.pos + cigar_ref_len(pairs) > ref.seq_len(sid):
            errs.append(f"{where}: reference span out of bounds "
                        f"(pos {r.pos}, ref_len {cigar_ref_len(pairs)}, "
                        f"SQ {ref.seq_len(sid)})")
            continue
        if not (0 <= r.mapq <= 60):
            errs.append(f"{where}: mapq {r.mapq} out of range")
        if r.seq:
            if cigar_query_len(pairs) != len(r.seq):
                errs.append(f"{where}: CIGAR query len "
                            f"{cigar_query_len(pairs)} != SEQ "
                            f"{len(r.seq)}")
                continue
            q = np.frombuffer(encode_seq(r.seq), np.uint8)
            g0 = ref.local_to_global(sid, r.pos)
            t = ref.codes[g0:g0 + cigar_ref_len(pairs)]
            nm, md = _nm_md_from_ref(q, t, pairs)
            if r.tags.get("NM") != nm:
                errs.append(f"{where}: NM tag {r.tags.get('NM')} != "
                            f"re-derived {nm}")
            if "MD" in r.tags and r.tags["MD"] != md:
                errs.append(f"{where}: MD tag {r.tags['MD']!r} != "
                            f"re-derived {md!r}")

    # SA:Z round-trip over primary + supplementary parts
    sa_parts = [r for r in recs if not r.flag & FLAG_SECONDARY]
    items = {r.sa_item(): r for r in sa_parts}
    if len(items) != len(sa_parts):
        errs.append(f"{qname}: duplicate sa_item among parts")
    for r in sa_parts:
        tag = r.tags.get("SA")
        if len(sa_parts) == 1:
            if tag is not None:
                errs.append(f"{qname}: single part carries SA tag")
            continue
        if tag is None:
            errs.append(f"{qname}: multi-part record without SA tag")
            continue
        if not tag.endswith(";"):
            errs.append(f"{qname}: SA tag not ';'-terminated")
        got = [s for s in tag.split(";") if s]
        expect = [x.sa_item() for x in sa_parts if x is not r]
        if sorted(got) != sorted(expect):
            errs.append(f"{qname}: SA items {got} != other parts "
                        f"{expect}")
        if r.sa_item() in got:
            errs.append(f"{qname}: record lists itself in SA")
    return errs


def validate_batch(out, ref) -> list[str]:
    """Validate align_batch output (list of per-read record lists)."""
    errs: list[str] = []
    for recs in out:
        errs += validate_read_records(recs, ref)
    return errs
