"""The port's CLI (lamsa_tpu_torch.cli, --device cpu) against the JAX
package's CLI on one world: shard runs and their merge, --resume after
an interruption, the .progress cursor and progress lines, --stats
fields, -d N over CPU entries and the flags' plumbing. Records must be
byte-identical to one unbroken single-device run, and to the JAX CLI's
(whose SAM differs only in its @PG line)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from lamsa_tpu import cli as jcli
from lamsa_tpu_torch import cli, sim
from lamsa_tpu_torch.io.fasta import FastxRecord, write_fasta, write_fastq

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_cli.py's world (same seed and draws), indexed once."""
    d = tmp_path_factory.mktemp("portcli")
    rng = np.random.default_rng(11)
    genome = sim.random_genome(rng, 30000)
    reads = sim.simulate_reads(rng, genome, 8, read_len=(500, 1500),
                               sv_fraction=0.25)
    ref, fq = str(d / "g.fa"), str(d / "r.fq")
    write_fasta(ref, genome)
    write_fastq(fq, reads)
    assert cli.main(["index", ref]) == 0
    full = str(d / "full.sam")
    assert aln("-o", full, ref, fq) == 0
    return d, ref, fq, full, reads


def aln(*args):
    return cli.main(["aln", "--device", "cpu", *args])


def _parse_sam(path):
    headers, records = [], []
    for ln in open(path):
        (headers if ln.startswith("@") else records).append(ln.rstrip("\n"))
    return headers, records


def _by_read(records):
    """Records grouped per read, in order (names are unique here)."""
    order, by = [], {}
    for r in records:
        nm = r.split("\t", 1)[0]
        if nm not in by:
            order.append(nm)
        by.setdefault(nm, []).append(r)
    return [by[nm] for nm in order]


def _no_pg(path):
    return [ln for ln in open(path) if not ln.startswith("@PG")]


def test_aln_resume_appends(world):
    d, ref, fq, full, _ = world
    part = str(d / "part.sam")
    headers, recs = _parse_sam(full)
    head = [r for g in _by_read(recs)[:3] for r in g]
    with open(part, "w") as fh:
        fh.write("\n".join(headers + head) + "\n")
    with open(part + ".progress", "w") as fh:
        fh.write("3")
    assert aln("--resume", "-o", part, ref, fq) == 0
    assert _parse_sam(part)[1] == recs
    assert open(part + ".progress").read() == "8"


def test_aln_resume_after_kill(world):
    """The cursor says 3 reads, but the killed run had written all of
    read 4's records and half a line of read 5's: --resume trims to the
    cursor, and the file equals an unbroken run byte for byte."""
    d, ref, fq, full, _ = world
    part = str(d / "part_k.sam")
    headers, recs = _parse_sam(full)
    groups = _by_read(recs)
    head = [r for g in groups[:4] for r in g]
    with open(part, "w") as fh:
        fh.write("\n".join(headers + head) + "\n" + groups[4][0][:37])
    with open(part + ".progress", "w") as fh:
        fh.write("3")
    assert aln("--resume", "-o", part, ref, fq) == 0
    with open(part) as fa, open(full) as fb:
        assert fa.read() == fb.read()


def test_resume_with_adjacent_reads_of_one_name(world, tmp_path):
    """Two adjacent reads share a name. Counting distinct consecutive
    QNAMEs would take them for one read, keep a read too many and append
    it again; counting primary records resumes byte-identically."""
    d, ref, _, _, reads = world
    dup = list(reads)
    dup[2] = FastxRecord(name=dup[1].name, seq=dup[2].seq, qual=dup[2].qual)
    fq = str(tmp_path / "dup.fq")
    write_fastq(fq, dup)
    full = str(tmp_path / "dup_full.sam")
    assert aln("-o", full, ref, fq) == 0
    headers, recs = _parse_sam(full)
    # records of the first 5 reads: primaries start reads
    starts = [i for i, r in enumerate(recs)
              if int(r.split("\t")[1]) & 0x900 == 0]
    head = recs[:starts[5]]
    part = str(tmp_path / "dup_part.sam")
    with open(part, "w") as fh:
        fh.write("\n".join(headers + head) + "\n" + recs[starts[5]][:20])
    with open(part + ".progress", "w") as fh:
        fh.write("3")
    assert aln("--resume", "-o", part, ref, fq) == 0
    with open(part) as fa, open(full) as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("n", [0, 2, 3, 5, 100])
def test_truncate_cuts_where_the_jax_cli_does(world, tmp_path, n):
    """With unique names, the port's _truncate_sam_to_reads keeps the
    same bytes as lamsa_tpu/cli.py's and returns the same count."""
    _, _, _, full, _ = world
    body = open(full, "rb").read() + b"partial\tli"
    a, b = str(tmp_path / "a.sam"), str(tmp_path / "b.sam")
    for p in (a, b):
        with open(p, "wb") as fh:
            fh.write(body)
    assert cli._truncate_sam_to_reads(a, n) \
        == jcli._truncate_sam_to_reads(b, n)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def shards(world):
    """The port's two shard files (batch 3) and their one-run base."""
    d, ref, fq, _, _ = world
    base = str(d / "whole.sam")
    assert aln("-o", base, "--batch-reads", "3", ref, fq) == 0
    paths = []
    for sid in (0, 1):
        p = str(d / f"s{sid}.sam")
        assert aln("-o", p, "--batch-reads", "3", "--num-shards", "2",
                   "--shard-id", str(sid), ref, fq) == 0
        paths.append(p)
    return base, paths


def test_shard_and_merge_matches_single_run(world, shards):
    d = world[0]
    base, paths = shards
    merged = str(d / "merged.sam")
    assert cli.main(["merge", "-o", merged, *paths]) == 0
    assert _parse_sam(merged)[1] == _parse_sam(base)[1]


def test_shard_files_equal_the_jax_clis(world, shards):
    d, ref, fq, _, _ = world
    _, paths = shards
    for sid, p in enumerate(paths):
        j = str(d / f"jax_s{sid}.sam")
        assert jcli.main(["aln", "-o", j, "--batch-reads", "3",
                          "--num-shards", "2", "--shard-id", str(sid),
                          ref, fq]) == 0
        assert _no_pg(p) == _no_pg(j)
        assert any(ln.startswith("@CO\tlamsa_tpu_shard:")
                   for ln in open(p))


def test_devices_flag_mesh_matches_single(world):
    """-d 8 on the CPU (8 entries of one device) == one device."""
    d, ref, fq, full, _ = world
    eight = str(d / "dev8.sam")
    assert aln("-o", eight, "-d", "8", ref, fq) == 0
    assert _parse_sam(eight)[1] == _parse_sam(full)[1]


def test_stats_jsonl_fields(world, tmp_path):
    """--stats lines carry dp_cells_total (the dp_cells_* counters
    summed) and achieved_gcells_per_s; the last line's total equals the
    JAX CLI's, which counts the same cells."""
    d, ref, fq, _, _ = world
    got = {}
    for name, main in (("port", aln), ("jax", lambda *a:
                                       jcli.main(["aln", *a]))):
        stats = str(tmp_path / f"{name}.jsonl")
        assert main("-o", str(tmp_path / f"{name}.sam"), "--stats", stats,
                    "--batch-reads", "4", ref, fq) == 0
        got[name] = [json.loads(ln) for ln in open(stats)]
    lines = got["port"]
    assert len(lines) >= 2
    last = lines[-1]
    assert last["reads_done"] == 8 and last["counters"]["reads"] == 8
    assert "seed_chain_device" in last["wall_s"]
    assert "spans" not in last          # a line per batch, not its spans
    cells = sum(v for k, v in last["counters"].items()
                if k.startswith("dp_cells_"))
    assert last["dp_cells_total"] == cells > 0
    assert last["achieved_gcells_per_s"] >= 0
    assert last["dp_cells_total"] == got["jax"][-1]["dp_cells_total"]


def test_progress_cursor_and_lines(world, tmp_path, monkeypatch, capsys):
    """<out>.progress is written after each full batch and at the end,
    with -o and without --resume; a progress line goes to stderr every
    PROGRESS_EVERY reads."""
    import lamsa_tpu_torch.pipeline.aln as aln_mod
    d, ref, fq, _, _ = world
    out = str(tmp_path / "prog.sam")
    seen = []
    orig = aln_mod.align_reads

    def spy(*a, **kw):
        for i, recs in enumerate(orig(*a, **kw)):
            if i in (4, 7):       # the CLI has written reads 0..i-1
                seen.append(open(out + ".progress").read()
                            if os.path.exists(out + ".progress") else None)
            yield recs

    monkeypatch.setattr(aln_mod, "align_reads", spy)
    monkeypatch.setattr(cli, "PROGRESS_EVERY", 3)
    assert aln("-o", out, "--batch-reads", "4", ref, fq) == 0
    assert seen == ["4", "4"]
    assert open(out + ".progress").read() == "8"
    err = capsys.readouterr().err
    assert "] 3 reads, " in err and "] 6 reads, " in err


def test_flag_plumbing_matches_the_jax_cli(world, tmp_path, monkeypatch):
    """-V / --sv-min / --secondary / -R / --md reach AlignConfig, and the
    records equal the JAX CLI's with the same flags."""
    import lamsa_tpu_torch.pipeline.aln as aln_mod
    d, ref, fq, _, _ = world
    seen = {}
    orig = aln_mod.align_reads

    def spy(ref_, index, reads, config=None, **kw):
        seen["cfg"] = config
        return orig(ref_, index, reads, config, **kw)

    monkeypatch.setattr(aln_mod, "align_reads", spy)
    flags = ["-V", "5000", "--sv-min", "40", "--secondary", "-R", "rg7",
             "--md"]
    out, jout = str(tmp_path / "f.sam"), str(tmp_path / "jf.sam")
    assert aln("-o", out, *flags, ref, fq) == 0
    cfg = seen["cfg"]
    assert (cfg.sv_max_size, cfg.sv_min_size, cfg.report_secondary,
            cfg.rg_id, cfg.emit_md) == (5000, 40, True, "rg7", True)
    headers, records = _parse_sam(out)
    assert any(h.startswith("@RG\tID:rg7") for h in headers)
    assert all("RG:Z:rg7" in r for r in records
               if not int(r.split("\t")[1]) & 0x100)
    assert any("MD:Z:" in r for r in records)
    assert jcli.main(["aln", "-o", jout, *flags, ref, fq]) == 0
    assert _no_pg(out) == _no_pg(jout)


@pytest.mark.parametrize("extra,msg", [
    (["--num-shards", "2"], "requires -o"),
    (["--num-shards", "2", "--shard-id", "2", "-o", "x.sam"],
     "out of range"),
    (["--device", "cuda", "-d", "99"], "requested but only"),
])
def test_aln_argument_errors(world, tmp_path, capsys, extra, msg):
    _, ref, fq, _, _ = world
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(["aln", "--device", "cpu", *extra, ref, fq]) == 1
    finally:
        os.chdir(cwd)
    assert msg in capsys.readouterr().err


def test_resume_without_cursor_starts_fresh(world, tmp_path):
    """--resume with no .progress file is a fresh run (header included)."""
    _, ref, fq, full, _ = world
    out = str(tmp_path / "fresh.sam")
    shutil.copy(full, out)
    assert aln("--resume", "-o", out, ref, fq) == 0
    assert _parse_sam(out) == _parse_sam(full)
