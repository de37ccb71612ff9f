# Frozen copy of lamsa_tpu_torch/eval.py (evaluate's rule for a found part, _rec_interval, _rec_read_interval) and lamsa_tpu_torch/sim.py (TruthPart.decode), on parsed SAM records.
"""Where each read part truly lies, and whether a record found it.

A part counts as found when a mapped record on the right sequence and
strand covers at least half of both its reference interval and its
query interval (``eval.py``'s rule, with its 200 bp slack).
"""

from __future__ import annotations

SLACK = 200


def parse_truth(read_name: str) -> list[tuple]:
    """[(ref_name, ref_start, ref_end, strand, q_start, q_end)] encoded
    in a read name by traffic.make_reads."""
    out = []
    for p in read_name.split("|", 1)[1].split(";"):
        ref, span, strand, qspan = p.rsplit(":", 3)
        rs, re_ = span.split("-")
        qs, qe = qspan.split("-")
        out.append((ref, int(rs), int(re_), strand, int(qs), int(qe)))
    return out


def read_interval(rec, read_len):
    """Read-space span [start, end) of a record from its soft clips;
    reverse-strand CIGARs are in reverse-complemented-read order."""
    ops = rec["cigar"]
    lead = ops[0][1] if ops and ops[0][0] == "S" else 0
    trail = ops[-1][1] if len(ops) > 1 and ops[-1][0] == "S" else 0
    if rec["flag"] & 0x10:
        return trail, read_len - lead
    return lead, read_len - trail


def parts_found(read_name: str, read_len: int, mapped) -> tuple[int, int]:
    """(parts found, parts) of one read given its mapped records."""
    truth = parse_truth(read_name)
    found = 0
    for ref, p_rs, p_re, strand, p_qs, p_qe in truth:
        for rec in mapped:
            if rec["rname"] != ref:
                continue
            if bool(rec["flag"] & 0x10) != (strand == "-"):
                continue
            s, e = rec["pos"], rec["pos"] + rec["ref_len"]
            if not (s < p_re + SLACK and e > p_rs - SLACK):
                continue
            if min(e, p_re) - max(s, p_rs) < 0.5 * (p_re - p_rs):
                continue
            qs, qe = read_interval(rec, read_len)
            if min(qe, p_qe) - max(qs, p_qs) < 0.5 * (p_qe - p_qs):
                continue
            found += 1
            break
    return found, len(truth)
