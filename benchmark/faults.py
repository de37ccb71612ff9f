"""Faults planted under the timed path: each breaks a prepared entry's
aligner in place, so that the rest of a run (the window, the SAM lines,
the check) goes on as it would. The check has to come out not correct
under each. The benchmark's own runs plant none; ``readings.py
--fault`` and ``tests/test_benchmark_check.py`` do.

  half_batch  half of every batch left out: the second half of its reads
              get an unmapped record, as if never aligned
  stale       a step that returns its state unchanged: each batch gets
              the records of the batch before it (the first, the
              warm-up's)
  altered     an answer altered where it is produced: every 10th part
              the finalize stage builds lies one base to the right

Aligning several cards exchanges nothing in a cell of one card, so no
fault of the exchange is planted.
"""

from __future__ import annotations


def half_batch(entry):
    from lamsa_tpu_torch.io.sam import unmapped_record
    inner = entry.aligner.align_batch

    def align_batch(reads):
        h = len(reads) // 2
        return inner(reads[:h]) + [[unmapped_record(r.name, r.seq, r.qual)]
                                   for r in reads[h:]]
    entry.aligner.align_batch = align_batch


def stale(entry):
    inner = entry.aligner.align_batch
    prev = []

    def align_batch(reads):
        out = inner(reads)
        ret = prev[0] if prev else out
        prev[:] = [out]
        return ret
    entry.aligner.align_batch = align_batch


def altered(entry):
    inner = entry.aligner._finalize_part
    n = [0]

    def finalize_part(*a, **k):
        rec = inner(*a, **k)
        if rec is not None:
            n[0] += 1
            if n[0] % 10 == 0:
                rec["pos"] += 1
        return rec
    entry.aligner._finalize_part = finalize_part


FAULTS = {"half_batch": half_batch, "stale": stale, "altered": altered}
