"""Command-line interface of the PyTorch port.

    python -m lamsa_tpu_torch.cli index <ref.fa>
    python -m lamsa_tpu_torch.cli aln [--device cuda] <ref.fa> <reads.fq>
    python -m lamsa_tpu_torch.cli merge -o out.sam s0.sam s1.sam

The parser, ``index`` and ``merge`` are the JAX package's
(``lamsa_tpu.cli``, which imports no JAX at module level); ``aln`` is
this package's own and adds ``--device`` (default ``cuda``). It aligns
with the index ``index`` built: the FM index (``index --fm``, the
default above 200 Mb) or the k-mer table. Options whose machinery is
not ported yet (several devices, multi-host shards, --resume) are
refused with an error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from lamsa_tpu.cli import _index_dir
from lamsa_tpu.cli import build_parser as _jax_build_parser


def _refuse(msg: str) -> int:
    print(f"[lamsa_tpu_torch aln] {msg} is not ported yet (a later "
          f"PyTorch port step, see ROADMAP.md)", file=sys.stderr)
    return 2


def cmd_aln(args) -> int:
    from lamsa_tpu.config import ScoreParams, preset
    from lamsa_tpu.index.fmindex import FmIndex
    from lamsa_tpu.index.kmer import KmerIndex
    from lamsa_tpu.io.fasta import read_fastx
    from lamsa_tpu.io.refpack import PackedReference
    from lamsa_tpu.io.sam import format_sam_record, sam_header
    from lamsa_tpu_torch.pipeline.aln import align_reads

    if args.devices != 1:
        return _refuse("-d/--devices (multi-device alignment)")
    if args.num_shards != 1:
        return _refuse("--num-shards (multi-host sharding)")
    if args.resume:
        return _refuse("--resume")
    idx_dir = _index_dir(args.ref)
    if not os.path.isdir(idx_dir):
        print(f"[lamsa_tpu_torch aln] no index at {idx_dir}; "
              f"run 'index {args.ref}' first", file=sys.stderr)
        return 1
    ref = PackedReference.load(idx_dir)
    index = FmIndex.load(idx_dir) if FmIndex.exists(idx_dir) \
        else KmerIndex.load(idx_dir)

    cfg = preset(args.preset)
    if args.band_width > 256:
        print(f"[lamsa_tpu_torch aln] -w {args.band_width} exceeds the "
              f"widest kernel band; clamping to 256", file=sys.stderr)
        args.band_width = 256
    scores = ScoreParams(match=args.match, mismatch=args.mismatch,
                         gap_open=args.gap_open, gap_ext=args.gap_ext,
                         end_bonus=cfg.scores.end_bonus)
    cfg = cfg.replace(scores=scores, seed_step=args.seed_step,
                      batch_reads=args.batch_reads,
                      band_width=args.band_width, threads=args.threads,
                      rg_id=args.rg, emit_md=args.md,
                      sv_min_size=args.sv_min, sv_max_size=args.sv_max,
                      report_secondary=args.secondary)

    out = open(args.output, "w") if args.output else sys.stdout
    cl = " ".join(sys.argv[1:])
    print(sam_header(ref, f"lamsa_tpu_torch aln {cl}", rg_id=cfg.rg_id),
          file=out)

    stats_fh = None
    if args.stats:
        from lamsa_tpu.utils.timers import GLOBAL as STATS
        STATS.reset()
        stats_fh = sys.stderr if args.stats == "-" else open(args.stats, "w")

    t0 = time.time()
    n_reads = 0
    n_records = 0

    def emit_stats():
        if stats_fh is None:
            return
        import json
        from lamsa_tpu.utils.timers import GLOBAL as STATS
        snap = STATS.snapshot()
        snap["reads_done"] = n_reads
        snap["wall_total_s"] = round(time.time() - t0, 3)
        print(json.dumps(snap), file=stats_fh)
        stats_fh.flush()

    for recs in align_reads(ref, index, read_fastx(args.reads), cfg,
                            device=args.device):
        n_reads += 1
        for rec in recs:
            print(format_sam_record(rec), file=out)
            n_records += 1
        if n_reads % cfg.batch_reads == 0:
            out.flush()
            emit_stats()
    emit_stats()
    if stats_fh is not None and stats_fh is not sys.stderr:
        stats_fh.close()
    dt = time.time() - t0
    print(f"[lamsa_tpu_torch aln] done: {n_reads} reads -> {n_records} "
          f"records in {dt:.1f}s ({n_reads / max(dt, 1e-9):.1f} reads/s) "
          f"on {args.device}", file=sys.stderr)
    if args.output:
        out.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser with this package's ``aln`` (plus
    --device)."""
    p = _jax_build_parser()
    p.prog = "lamsa-tpu-torch"
    sub = next(a for a in p._actions
               if isinstance(a, argparse._SubParsersAction))
    pa = sub.choices["aln"]
    pa.add_argument("--device", default="cuda",
                    help="torch device to align on: cuda (the CUDA "
                         "kernels) or cpu (their plain torch versions)")
    pa.set_defaults(func=cmd_aln)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
