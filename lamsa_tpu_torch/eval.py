# Copy of lamsa_tpu/eval.py; only its import lines differ.
"""Accuracy evaluation against simulator truth.

The reference's validation style (SURVEY.md section 4): simulated reads
with known origin, aligner output compared to truth. A read part is
"correct" if some SAM record overlaps its true reference interval on the
right strand and sequence.
"""

from __future__ import annotations

import dataclasses

from lamsa_tpu_torch.io.sam import FLAG_REVERSE, FLAG_UNMAPPED, cigar_ref_len
from lamsa_tpu_torch.sim import parse_truth


@dataclasses.dataclass
class EvalStats:
    n_reads: int = 0
    n_parts: int = 0
    parts_found: int = 0
    reads_all_parts: int = 0
    n_unmapped: int = 0
    n_records: int = 0
    # breakpoint accuracy: internal part edges (SV junctions) compared
    # between the matching record's read-space span and the truth
    # part's query interval — the thing a SPLIT aligner is for
    n_breakpoints: int = 0
    bp_err_sum: int = 0
    bp_within_20: int = 0

    @property
    def part_recall(self) -> float:
        return self.parts_found / max(1, self.n_parts)

    @property
    def read_accuracy(self) -> float:
        return self.reads_all_parts / max(1, self.n_reads)

    @property
    def bp_mean_err(self) -> float:
        return self.bp_err_sum / max(1, self.n_breakpoints)

    @property
    def bp_acc_20(self) -> float:
        """Fraction of SV junction edges placed within 20 bp of truth."""
        return self.bp_within_20 / max(1, self.n_breakpoints)

    def summary(self) -> str:
        s = (f"reads={self.n_reads} part_recall={self.part_recall:.3f} "
             f"read_acc={self.read_accuracy:.3f} "
             f"unmapped={self.n_unmapped}")
        if self.n_breakpoints:
            s += (f" bp_mean_err={self.bp_mean_err:.1f} "
                  f"bp_acc20={self.bp_acc_20:.3f} (n={self.n_breakpoints})")
        return s


def _rec_interval(rec):
    return rec.pos, rec.pos + cigar_ref_len(rec.cigar)


def _rec_read_interval(rec, read_len):
    """Read-space span [start, end) of a record, from its soft clips.
    Reverse-strand CIGARs are in reverse-complemented-read order, so
    the clips swap ends in original read coordinates."""
    from lamsa_tpu_torch.io.sam import OP_S, cigar_pairs
    pairs = list(cigar_pairs(rec.cigar))
    lead = pairs[0][1] if pairs and pairs[0][0] == OP_S else 0
    trail = pairs[-1][1] if len(pairs) > 1 and pairs[-1][0] == OP_S else 0
    if rec.flag & FLAG_REVERSE:
        return trail, read_len - lead
    return lead, read_len - trail


def evaluate(records_per_read, reads, slack: int = 200) -> EvalStats:
    """records_per_read: list (per read, input order) of [SamRecord].
    reads: matching FastxRecords with truth-encoded names.

    A part counts as found when a record on the right sequence/strand
    covers >= 50% of BOTH its reference interval and its query
    interval. Internal part edges (SV junction breakpoints) of found
    parts additionally score read-space position error (bp_mean_err /
    bp_acc_20)."""
    st = EvalStats()
    for read, recs in zip(reads, records_per_read):
        truth = parse_truth(read.name)
        L = len(read.seq)
        st.n_reads += 1
        st.n_parts += len(truth)
        mapped = [r for r in recs if not (r.flag & FLAG_UNMAPPED)]
        st.n_records += len(mapped)
        if not mapped:
            st.n_unmapped += 1
            continue
        found = 0
        match_q: list = []           # matched record's read span per part
        for p in truth:
            want_rev = p.strand == "-"
            mq = None
            for rec in mapped:
                if rec.rname != p.ref_name:
                    continue
                if bool(rec.flag & FLAG_REVERSE) != want_rev:
                    continue
                s, e = _rec_interval(rec)
                if not (s < p.ref_end + slack and e > p.ref_start - slack):
                    continue
                inter = min(e, p.ref_end) - max(s, p.ref_start)
                if inter < 0.5 * (p.ref_end - p.ref_start):
                    continue
                qs, qe = _rec_read_interval(rec, L)
                inter_q = min(qe, p.q_end) - max(qs, p.q_start)
                if inter_q < 0.5 * (p.q_end - p.q_start):
                    continue
                mq = (qs, qe)
                break
            match_q.append(mq)
            found += mq is not None
        st.parts_found += found
        if found == len(truth):
            st.reads_all_parts += 1
        # breakpoint accuracy at genuine SV junctions: both flanking
        # parts found, and the junction is a real discontinuity (a
        # colinear-contiguous truth pair — e.g. the second copy of a
        # tandem duplication flowing into the following flank — is
        # correctly reported as ONE record, so it has no junction)
        for a, b, ma, mb in zip(truth, truth[1:], match_q, match_q[1:]):
            if ma is None or mb is None or _colinear(a, b):
                continue
            for err in (abs(ma[1] - a.q_end), abs(mb[0] - b.q_start)):
                st.n_breakpoints += 1
                st.bp_err_sum += err
                st.bp_within_20 += err <= 20
    return st


def _colinear(a, b, tol: int = 40) -> bool:
    """True when truth parts a, b continue each other colinearly (same
    sequence/strand, both the reference and the query step forward by
    < tol) — a single alignment record legitimately spans both."""
    if a.ref_name != b.ref_name or a.strand != b.strand:
        return False
    dr = (b.ref_start - a.ref_end) if a.strand == "+" \
        else (a.ref_start - b.ref_end)
    dq = b.q_start - a.q_end
    return abs(dr) < tol and abs(dq) < tol
