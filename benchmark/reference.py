"""The plain reference that decides ``correct``. NumPy only.

It reads the SAM lines the timed path produced and works out again,
from the genome's codes and the reads the benchmark made, what each
record claims:

  seeding and chaining  where each read part lands: every truth part of
                        the read has to be found by a record on its
                        chromosome and strand (truth.py)   -> part_miss
  DP batcher, kernels   each record's CIGAR re-scored base by base
                        against the genome under the configuration's
                        affine scores has to give its AS, and its edits
                        its NM; and a banded global Gotoh DP over the
                        record's own query and reference span, around
                        its own diagonals, may beat the record's score
                        by at most a limit                  -> dp_gap
  finalize              one primary per mapped read, supplementary
                        flags, SEQ as the read or its reverse complement
                        by the strand flag, a CIGAR that spans the read,
                        MAPQ in 0-60, SA tags that list every other part
                        exactly, the primary's AS the largest, XS only
                        on the primary                 -> record_faults

A read that the window aligned twice (the pool is cycled) has to give
the same SAM lines both times; the first is judged as above.
"""

from __future__ import annotations

import numpy as np

from benchmark import truth

_ENC = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ENC[_c] = _i
    _ENC[ord(chr(_c).lower())] = _i
_LUT = np.frombuffer(b"ACGTN", np.uint8)
NEG = -(1 << 40)
MARGIN = 64          # diagonals the banded DP may stray past the record's


def encode(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode(), np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, 4).astype(np.uint8)[::-1]


def parse_cigar(s: str) -> list[tuple[str, int]]:
    out, num = [], 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((ch, num))
            num = 0
    return out


def parse_sam(line: str) -> dict:
    f = line.split("\t")
    tags = {}
    for t in f[11:]:
        k, typ, v = t.split(":", 2)
        tags[k] = int(v) if typ == "i" else v
    cig = [] if f[5] == "*" else parse_cigar(f[5])
    return {"qname": f[0], "flag": int(f[1]), "rname": f[2],
            "pos": int(f[3]) - 1, "mapq": int(f[4]), "cigar_str": f[5],
            "cigar": cig, "seq": f[9], "tags": tags,
            "ref_len": sum(n for op, n in cig if op in "MD")}


def rescore(q: np.ndarray, t: np.ndarray, cigar, scores: dict):
    """(score, nm, dmin, dmax) of a clip-less CIGAR aligning q to t
    under affine scores (a gap of L costs gap_open + L * gap_ext; N
    never matches); d = reference index - query index along the path.
    None when the CIGAR does not consume q and t exactly."""
    i = j = score = nm = 0
    dmin = dmax = 0
    for op, n in cigar:
        if op == "M":
            if i + n > len(q) or j + n > len(t):
                return None
            a, b = q[i:i + n], t[j:j + n]
            eq = int(((a == b) & (a < 4)).sum())
            score += scores["match"] * eq - scores["mismatch"] * (n - eq)
            nm += n - eq
            i += n
            j += n
        elif op in "ID":
            score -= scores["gap_open"] + n * scores["gap_ext"]
            nm += n
            if op == "I":
                i += n
            else:
                j += n
        else:
            return None
        dmin, dmax = min(dmin, j - i), max(dmax, j - i)
    if i != len(q) or j != len(t):
        return None
    return score, nm, dmin, dmax


def as_explained(as_tag, score, clip_l, clip_r, scores) -> bool:
    """AS equals the CIGAR's score, or that score less the gaps that the
    port trims off a boundary into its soft clip (pipeline/aln.py
    _trim_boundary_indels: an insertion at either end becomes clip, and
    AS keeps the DP score that paid for it): one gap of 1 <= l <= clip
    bases on a clipped side, or one on each."""
    if as_tag is None:
        return False
    d = score - as_tag
    if d == 0:
        return True
    go, ge = scores["gap_open"], scores["gap_ext"]

    def fits(rest, lo, hi):
        return ge > 0 and rest % ge == 0 and lo <= rest // ge <= hi

    if any(c > 0 and fits(d - go, 1, c) for c in (clip_l, clip_r)):
        return True
    return clip_l > 0 and clip_r > 0 and fits(d - 2 * go, 2, clip_l + clip_r)


def banded_global(jobs, scores: dict) -> list[int]:
    """Best global affine score of each (q, t, dlo, dhi) job, over paths
    whose diagonal j - i stays in [dlo, dhi]: Gotoh's recurrences row by
    row (rows = query bases), all jobs at once, H[c] at reference index
    j = i + dlo + c."""
    if not jobs:
        return []
    ma, mm = scores["match"], scores["mismatch"]
    go, ge = scores["gap_open"], scores["gap_ext"]
    R = len(jobs)
    ms = np.array([len(q) for q, _t, _a, _b in jobs])
    ns = np.array([len(t) for _q, t, _a, _b in jobs])
    dlo = np.array([a for *_x, a, _b in jobs])[:, None]
    Wb = max(b - a + 1 for *_x, a, b in jobs)
    width = np.array([b - a + 1 for *_x, a, b in jobs])[:, None]
    c = np.arange(Wb)[None, :]
    qpad = np.full((R, ms.max() + 1), 4, np.uint8)
    tpad = np.full((R, ns.max() + 2), 4, np.uint8)
    for r, (q, t, _a, _b) in enumerate(jobs):
        qpad[r, :len(q)] = q
        tpad[r, 1:len(t) + 1] = t          # tpad[:, j] = t[j - 1]
    inband = c < width
    j = dlo + c
    ok = inband & (j >= 0) & (j <= ns[:, None])
    H = np.where(ok, np.where(j == 0, 0, -(go + ge * j)), NEG)
    F = np.full((R, Wb), NEG, np.int64)
    out = np.zeros(R, np.int64)
    done = ms == 0
    out[done] = H[done, (ns - dlo[:, 0])[done]]
    ramp = ge * np.arange(Wb)[None, :]
    for i in range(1, int(ms.max()) + 1):
        j = i + dlo + c
        ok = inband & (j >= 0) & (j <= ns[:, None])
        tj = np.take_along_axis(tpad, np.clip(j, 0, tpad.shape[1] - 1), 1)
        qi = qpad[:, i - 1][:, None]
        s = np.where((qi == tj) & (qi < 4), ma, -mm)
        diag = np.where(j >= 1, H + s, NEG)
        Hs = np.concatenate([H[:, 1:], np.full((R, 1), NEG)], 1)
        Fs = np.concatenate([F[:, 1:], np.full((R, 1), NEG)], 1)
        F = np.maximum(Hs - go - ge, Fs - ge)
        Hp = np.maximum(diag, F)
        Hp = np.where(ok, Hp, NEG)
        # E[c] = max_{k<c} (H'[k] + ge k) - go - ge c
        acc = np.maximum.accumulate(Hp + ramp, axis=1)
        E = np.concatenate([np.full((R, 1), NEG), acc[:, :-1]], 1) \
            - go - ramp
        H = np.where(ok, np.maximum(Hp, E), NEG)
        F = np.where(ok, F, NEG)
        fin = ms == i
        if fin.any():
            out[fin] = H[fin, (ns - i - dlo[:, 0])[fin]]
    return out.tolist()


def _read_faults(read, lines, genome, scores, chrom):
    """(faults [str], parsed mapped records, aligned jobs) of one read."""
    faults = []
    recs = [parse_sam(x) for x in lines]
    name = read.name
    codes = encode(read.seq)
    L = len(codes)
    if not recs:
        return ["no record"], [], []
    if any(r["qname"] != name for r in recs):
        return ["a record of another read"], [], []
    if any(r["flag"] & 0x4 for r in recs):
        if len(recs) != 1:
            faults.append("unmapped beside other records")
        return faults, [], []
    prim = [r for r in recs if not r["flag"] & 0x900]
    supp = [r for r in recs if r["flag"] & 0x800]
    if len(prim) != 1:
        faults.append(f"{len(prim)} primary records")
    if any(r["flag"] & 0x100 for r in recs):
        faults.append("a secondary record")
    live = prim + supp
    jobs = []
    rc = None
    for r in live:
        if r["flag"] & ~0x810:
            faults.append(f"flag {r['flag']}")
        if not 0 <= r["mapq"] <= 60:
            faults.append(f"MAPQ {r['mapq']}")
        if r["flag"] & 0x10:
            rc = revcomp(codes) if rc is None else rc
            query = rc
        else:
            query = codes
        if r["seq"] != (read.seq if not r["flag"] & 0x10 else
                        _LUT[query].tobytes().decode()):
            faults.append("SEQ is not the read on its strand")
        cig = r["cigar"]
        lc = cig[0][1] if cig and cig[0][0] == "S" else 0
        tc = cig[-1][1] if len(cig) > 1 and cig[-1][0] == "S" else 0
        core = cig[(1 if lc else 0):len(cig) - (1 if tc else 0)]
        if not core or core[0][0] != "M" or core[-1][0] != "M":
            faults.append(f"CIGAR {r['cigar_str']} does not start and end "
                          f"with M")
            continue
        if r["rname"] not in chrom:
            faults.append(f"RNAME {r['rname']}")
            continue
        ci = chrom[r["rname"]]
        if r["pos"] < 0 or r["pos"] + r["ref_len"] > genome.chrom_len(ci):
            faults.append(f"POS {r['pos']} outside {r['rname']}")
            continue
        g0 = int(genome.offsets[ci]) + r["pos"]
        q = query[lc:L - tc]
        t = genome.codes[g0:g0 + r["ref_len"]]
        got = rescore(q, t, core, scores)
        if got is None or sum(n for op, n in cig if op in "MIS") != L:
            faults.append(f"CIGAR {r['cigar_str']} does not span the read")
            continue
        score, nm, dmin, dmax = got
        if not as_explained(r["tags"].get("AS"), score, lc, tc, scores):
            faults.append(f"AS {r['tags'].get('AS')} but the CIGAR scores "
                          f"{score}")
        if r["tags"].get("NM") != nm:
            faults.append(f"NM {r['tags'].get('NM')} but the CIGAR has "
                          f"{nm} edits")
        jobs.append((q, t, dmin - MARGIN, dmax + MARGIN, score))
    if prim and supp:
        best = prim[0]["tags"].get("AS", 0)
        if any(s["tags"].get("AS", 0) > best for s in supp):
            faults.append("a supplementary record outscores the primary")
    if any("XS" in r["tags"] for r in supp):
        faults.append("XS on a supplementary record")
    items = [f"{r['rname']},{r['pos'] + 1},{'-' if r['flag'] & 0x10 else '+'}"
             f",{r['cigar_str']},{r['mapq']},{r['tags'].get('NM', 0)}"
             for r in live]
    for k, r in enumerate(live):
        want = sorted(items[:k] + items[k + 1:])
        sa = r["tags"].get("SA")
        have = sorted(x for x in sa.split(";") if x) if sa else []
        if have != want:
            faults.append("SA tag does not list the other parts")
            break
    return faults, live, jobs


def judge(reads, outputs, genome, scores, *, dp_sample, rng):
    """The numbers `correct` compares, over every read the window
    completed. reads[i] and outputs[i] (its SAM lines) are in the order
    they were aligned. Returns (numbers, notes) where notes name the
    first faults found."""
    chrom = {n: i for i, n in enumerate(genome.names)}
    seen: dict[str, list[str]] = {}
    faults, notes = 0, []
    found = parts = 0
    jobs = []
    for read, lines in zip(reads, outputs):
        if read.name in seen:
            if seen[read.name] != lines:
                faults += 1
                if len(notes) < 5:
                    notes.append(f"{read.name.split('|')[0]}: records differ "
                                 f"from its earlier alignment in the run")
            continue
        seen[read.name] = lines
        fl, live, rjobs = _read_faults(read, lines, genome, scores, chrom)
        if fl:
            faults += 1
            if len(notes) < 5:
                notes.append(f"{read.name.split('|')[0]}: {fl[0]}")
        f, p = truth.parts_found(read.name, len(read.seq), live)
        found += f
        parts += p
        jobs.extend(rjobs)
    gap = 0
    if jobs:
        longest = max(range(len(jobs)), key=lambda k: len(jobs[k][0]))
        pick = {longest}
        pick.update(rng.choice(len(jobs), min(dp_sample, len(jobs)),
                               replace=False).tolist())
        sel = [jobs[k] for k in sorted(pick)]
        best = banded_global([x[:4] for x in sel], scores)
        gap = max(b - x[4] for b, x in zip(best, sel))
    return {"part_miss": 1.0 - found / max(parts, 1),
            "record_faults": faults,
            "dp_gap": gap}, notes
