"""A SAM record's CIGAR re-scored against the reference, for the tests
that hold the port's SAM to the JAX package's on FM worlds with the
1-edit re-seed on, where the two differ by design.

The FM re-seed's 1-edit anchors (ops/fm.py ``edit1_tracks``) can carry a
substituted base. The JAX package scores every anchor base as a match,
so its AS exceeds its CIGAR's score by match + mismatch per such base;
the port scores anchor runs base by base (pipeline/aln.py
``_anchor_run_score``). ``as_departures`` allows exactly that: a record
may differ from the JAX package's only in AS, the port's AS has to be
its CIGAR's score, and the JAX package's has to exceed it by a whole
number of substituted bases. Both packages turn an insertion at either
end of an alignment into soft clip and keep the DP score that paid for
it (pipeline/aln.py ``_trim_boundary_indels``), so the CIGAR's score may
also be that AS plus one such gap on a clipped side, or one on each.
The re-scoring is the benchmark's plain reference (benchmark/reference.py
``rescore`` and ``as_explained``); nothing of either package.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import (as_explained, encode, parse_sam,
                                 revcomp, rescore)


def _split(line: str):
    f = line.split("\t")
    tags = [t for t in f[11:] if not t.startswith("AS:i:")]
    as_ = [int(t[5:]) for t in f[11:] if t.startswith("AS:i:")]
    return f[:11] + tags, as_[0] if as_ else None


def as_faults(lines: list[str], ref, scores) -> list[str]:
    """The mapped records among SAM ``lines`` whose AS is not that of
    their CIGAR re-scored against ``ref`` (benchmark/reference.py
    ``rescore`` and ``as_explained``). A record with no SEQ (a
    secondary) takes its read's from another record."""
    sc = {k: getattr(scores, k)
          for k in ("match", "mismatch", "gap_open", "gap_ext")}
    starts = dict(zip(ref.names, np.asarray(ref.offsets[:-1]).tolist()))
    forward = {}                       # each read's bases, forward strand
    for line in lines:
        f = line.split("\t")
        if f[9] != "*" and f[0] not in forward:
            c = encode(f[9])
            forward[f[0]] = revcomp(c) if int(f[1]) & 0x10 else c
    bad = []
    for line in lines:
        r = parse_sam(line)
        if r["flag"] & 0x4:
            continue
        q = forward[r["qname"]]
        if r["flag"] & 0x10:
            q = revcomp(q)
        cig = r["cigar"]
        clip_l = cig[0][1] if cig[0][0] == "S" else 0
        clip_r = cig[-1][1] if cig[-1][0] == "S" else 0
        body = [(op, n) for op, n in cig if op != "S"]
        t0 = starts[r["rname"]] + r["pos"]
        got = rescore(q[clip_l:len(q) - clip_r],
                      ref.codes[t0:t0 + r["ref_len"]], body, sc)
        if got is None or not as_explained(r["tags"].get("AS"), got[0],
                                           clip_l, clip_r, sc):
            bad.append(line)
    return bad


def as_departures(got: list[str], want: list[str], ref,
                  scores) -> tuple[int, int]:
    """Asserts that the port's SAM lines ``got`` equal the JAX package's
    ``want`` but for the AS of records with a substituted anchor base,
    as the module says; returns (records that differ, the substituted
    bases their AS differences stand for)."""
    assert len(got) == len(want)
    differ = [(g, w) for g, w in zip(got, want) if g != w]
    bad = set(as_faults(got, ref, scores))
    n = bases = 0
    step = scores.match + scores.mismatch
    for g, w in differ:
        (gf, g_as), (wf, w_as) = _split(g), _split(w)
        assert gf == wf, (g, w)
        assert g not in bad, g
        assert w_as > g_as and (w_as - g_as) % step == 0, (g_as, w_as)
        n += 1
        bases += (w_as - g_as) // step
    return n, bases
