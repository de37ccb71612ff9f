"""Config-5-shaped soak: sustained alignment through the real CLI.

Counterpart of ``tools/soak_bench.py`` on this package (BASELINE.md
config 5 is "1M mixed reads, data-parallel streaming"; this is its
single-host slice). It reads its world from ``--workdir``: ``index/``
holds the PackedReference and the index in the JAX package's layout (the
directory ``python -m lamsa_tpu_torch.cli index genome.fa`` writes as
``genome.fa.lti``).

  A. One uninterrupted run of --reads 9-11 kb reads through
     ``python -m lamsa_tpu_torch.cli aln --device D -o out.sam --stats
     stats.jsonl``; a poller samples the process's RSS, its .progress
     cursor and, on a card, the process's device memory (nvidia-smi,
     by its exact PID). Reports reads/s per ~1k-read window and RSS
     over time; both should stay flat (+-10%) after window 0 (warm-up).
     On a card it also reports device memory over time, and the caching
     allocator's bytes allocated and reserved from the CLI's progress
     lines, so a rise in reserved is not taken for a leak.
  B. The same input as two shards: shard 0 is killed by PID once its
     cursor passes --kill-frac of its reads and resumed with
     ``--resume``; shard 1 runs clean; ``merge`` interleaves them. The
     merged SAM must equal leg A's record for record (headers apart
     from the @PG command line and the @CO shard tag).

Reads are cached under --workdir/soak, so reruns skip generation.

Run: python -m lamsa_tpu_torch.tools.soak_bench --workdir W
     [--device cuda|cpu] [--reads 50000] [--batch 256] [--leg A|B|all]
     [--kill-frac 0.5]
Prints one JSON line with the sustained curve and the verdicts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 20260821
POLL_S = 2.0                # seconds between samples of the CLI process
MEM_LINE = re.compile(r"\] (\d+) reads, .*device memory allocated "
                      r"([\d.]+) MiB, reserved ([\d.]+) MiB")


def log(msg):
    print(f"[soak] {msg}", file=sys.stderr, flush=True)


def ensure_reads(workdir, n_reads):
    """Simulate (once, cached) n_reads 9-11 kb reads off the workdir's
    reference, written as FASTQ for the CLI."""
    from lamsa_tpu_torch.io.refpack import PackedReference
    from lamsa_tpu_torch.worlds import sample_reads

    soak = os.path.join(workdir, "soak")
    os.makedirs(soak, exist_ok=True)
    fq = os.path.join(soak, f"reads_{n_reads}.fq")
    if os.path.exists(fq + ".done"):
        log(f"reads cached: {fq}")
        return fq
    ref = PackedReference.load(os.path.join(workdir, "index"))
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    with open(fq, "w") as fh:
        done = 0
        while done < n_reads:
            chunk = sample_reads(ref, min(2000, n_reads - done), rng)
            for r in chunk:
                q = r.qual or "I" * len(r.seq)   # sim emits qual=None
                fh.write(f"@{r.name}\n{r.seq}\n+\n{q}\n")
            done += len(chunk)
            log(f"simulated {done}/{n_reads} reads "
                f"({time.time() - t0:.0f}s)")
    open(fq + ".done", "w").close()
    return fq


def make_rundir(workdir, name, fq):
    d = os.path.join(workdir, "soak", name)
    os.makedirs(d, exist_ok=True)
    for link, target in (("genome.fa.lti", os.path.join(workdir, "index")),
                         ("reads.fq", fq)):
        p = os.path.join(d, link)
        if not os.path.exists(p):
            os.symlink(os.path.abspath(target), p)
    return d


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                os.environ.get("PYTHONPATH", ""))


def device_memory_mib(pid):
    """The process's device memory in MiB as nvidia-smi lists it among
    compute apps (exact PID), or None where it is not listed."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    for ln in r.stdout.splitlines():
        f = [x.strip() for x in ln.split(",")]
        if len(f) == 2 and f[0] == str(pid) and f[1].isdigit():
            return int(f[1])
    return None


def run_cli(cwd, out_name, extra, device, kill_at=None, rss_log=None,
            resume=False):
    """Run ``cli aln`` as a subprocess; optionally kill it once its
    .progress cursor passes kill_at reads; optionally append (t, rss_kb,
    reads_done, device_mib) samples to rss_log (device_mib -1 where not
    measured). Returns the exit code, -9 if it was killed."""
    argv = [sys.executable, "-m", "lamsa_tpu_torch.cli", "aln",
            "--device", device, "-o", out_name, "--stats",
            "stats.jsonl"] + extra + (["--resume"] if resume else []) + \
        ["genome.fa", "reads.fq"]
    on_card = device.startswith("cuda")
    t0 = time.time()
    with open(os.path.join(cwd, "cli.log"), "a") as lg:
        proc = subprocess.Popen(argv, cwd=cwd, env=_env(), stdout=lg,
                                stderr=lg)
    prog = os.path.join(cwd, out_name + ".progress")
    killed = False
    while proc.poll() is None:
        time.sleep(POLL_S)
        reads_done = 0
        try:
            with open(prog) as fh:
                reads_done = int(fh.read().strip() or 0)
        except (OSError, ValueError):
            pass
        try:
            with open(f"/proc/{proc.pid}/status") as fh:
                rss = next((int(l.split()[1]) for l in fh
                            if l.startswith("VmRSS")), 0)
        except OSError:
            rss = 0
        if rss_log is not None:
            mib = device_memory_mib(proc.pid) if on_card else None
            with open(rss_log, "a") as fh:
                fh.write(f"{time.time() - t0:.1f}\t{rss}\t{reads_done}\t"
                         f"{-1 if mib is None else mib}\n")
        if kill_at is not None and not killed and reads_done >= kill_at:
            log(f"SIGKILL at {reads_done} reads (cursor)")
            proc.kill()         # exact PID, never a pattern
            killed = True
    rc = proc.wait()
    return -9 if killed else rc


def window_curve(stats_path, win=1000):
    """Per-~win-read throughput from the per-batch --stats JSONL."""
    pts = []
    with open(stats_path) as fh:
        for ln in fh:
            try:
                s = json.loads(ln)
                pts.append((s["reads_done"], s["wall_total_s"]))
            except (ValueError, KeyError):
                continue
    curve = []
    last_r, last_w = 0, 0.0
    for r, w in pts:
        if r - last_r >= win:
            curve.append(round((r - last_r) / (w - last_w), 1))
            last_r, last_w = r, w
    return curve


def flatness(vals):
    """(min, max, median, max deviation from median) over vals."""
    if not vals:
        return None
    med = float(np.median(vals))
    dev = max(abs(v - med) / med for v in vals)
    return {"min": min(vals), "max": max(vals),
            "median": round(med, 1), "max_dev": round(dev, 3)}


def strip_volatile(path):
    """SAM lines minus the @PG command line and @CO shard tag (the only
    text that legitimately differs between a plain run and a
    shard+merge of the same input)."""
    with open(path) as fh:
        return [ln for ln in fh
                if not (ln.startswith("@PG") or
                        ln.startswith("@CO\tlamsa_tpu_shard:"))]


def memory_curve(name, vals):
    """{name}_peak_mb, the medians of the first and the last quarter of
    the samples ({name}_first_quarter_mb, {name}_last_quarter_mb),
    {name}_flat_10pct (last <= 1.10 x first) and {name}_curve_mb (the
    samples at 0, 1/10, ..., 10/10 of the run), over samples in MB; an
    empty dict where there are none."""
    vals = np.asarray(vals, np.float64)
    if len(vals) == 0:
        return {}
    n4 = max(1, len(vals) // 4)
    first = round(float(np.median(vals[:n4])), 1)
    last = round(float(np.median(vals[-n4:])), 1)
    at = np.linspace(0, len(vals) - 1, 11).round().astype(int)
    return {f"{name}_peak_mb": round(float(vals.max()), 1),
            f"{name}_first_quarter_mb": first,
            f"{name}_last_quarter_mb": last,
            f"{name}_flat_10pct": bool(last <= 1.10 * first),
            f"{name}_curve_mb": [round(float(v), 1) for v in vals[at]]}


def allocator_curve(cli_log):
    """The caching allocator's (reads, allocated MiB, reserved MiB) from
    the CLI's progress lines (on a card only)."""
    with open(cli_log) as fh:
        return [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
                for m in map(MEM_LINE.search, fh) if m]


def _fresh(d, names):
    for f in names:
        p = os.path.join(d, f)
        if os.path.exists(p):
            os.unlink(p)


def leg_a(args, fq, extra):
    dA = make_rundir(args.workdir, "runA", fq)
    rss_log = os.path.join(dA, "rss.tsv")
    _fresh(dA, ("out.sam", "out.sam.progress", "stats.jsonl", "rss.tsv",
                "cli.log"))
    t0 = time.time()
    rc = run_cli(dA, "out.sam", extra, args.device, rss_log=rss_log)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"leg A failed rc={rc} (see {dA}/cli.log)")
    curve = window_curve(os.path.join(dA, "stats.jsonl"))
    samples = np.loadtxt(rss_log, ndmin=2)
    if len(samples) == 0:
        raise RuntimeError(f"leg A ended before its first sample "
                           f"({POLL_S} s): too few reads to soak")
    st = flatness(curve[1:])        # window 0 = warm-up
    leg = {
        "wall_s": round(wall, 1),
        "reads_per_s_overall": round(args.reads / wall, 1),
        "window_curve": curve,
        "steady": st,
        # RSS 0: the process ended between the poll and reading /proc
        **memory_curve("rss", samples[samples[:, 1] > 0, 1] / 1024.0),
        "throughput_flat_10pct": bool(st and st["max_dev"] <= 0.10),
        "n_samples": len(samples),
    }
    if args.device.startswith("cuda"):
        dev = samples[:, 3]
        leg.update(memory_curve("dev_mem", dev[dev >= 0] * 2**20 / 1e6))
        leg["dev_mem_source"] = ("nvidia-smi --query-compute-apps, by PID"
                                 if (dev >= 0).any() else "not measured")
        alloc = allocator_curve(os.path.join(dA, "cli.log"))
        leg.update(memory_curve("allocated",
                                [a * 2**20 / 1e6 for _, a, _ in alloc]))
        leg.update(memory_curve("reserved",
                                [r * 2**20 / 1e6 for _, _, r in alloc]))
    log(f"leg A: {leg['reads_per_s_overall']} reads/s, steady {st}, RSS "
        f"peak {leg['rss_peak_mb']} MB")
    return leg


def leg_b(args, fq, extra):
    shard_extra = [extra + ["--num-shards", "2", "--shard-id", str(i)]
                   for i in (0, 1)]
    dB = make_rundir(args.workdir, "runB", fq)
    _fresh(dB, ("s0.sam", "s0.sam.progress", "s1.sam", "s1.sam.progress",
                "merged.sam", "stats.jsonl", "cli.log"))
    kill_at = int(args.reads / 2 * args.kill_frac)
    rc_kill = run_cli(dB, "s0.sam", shard_extra[0], args.device,
                      kill_at=kill_at)
    log(f"shard 0 killed (rc={rc_kill}); resuming")
    for out, ex, resume in (("s0.sam", shard_extra[0], True),
                            ("s1.sam", shard_extra[1], False)):
        rc = run_cli(dB, out, ex, args.device, resume=resume)
        if rc != 0:
            raise RuntimeError(f"{out} (resume={resume}) failed rc={rc} "
                               f"(see {dB}/cli.log)")
    with open(os.path.join(dB, "cli.log"), "a") as lg:
        rc = subprocess.call(
            [sys.executable, "-m", "lamsa_tpu_torch.cli", "merge", "-o",
             "merged.sam", "s0.sam", "s1.sam"], cwd=dB, env=_env(),
            stdout=lg, stderr=lg)
    if rc != 0:
        raise RuntimeError(f"merge failed rc={rc} (see {dB}/cli.log)")
    dA = os.path.join(args.workdir, "soak", "runA")
    same = strip_volatile(os.path.join(dA, "out.sam")) == \
        strip_volatile(os.path.join(dB, "merged.sam"))
    log(f"leg B: kill+resume+merge == plain run: {same}")
    return {"kill_at_reads": kill_at, "shard0_killed": rc_kill == -9,
            "resume_merge_equals_plain_run": bool(same)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True,
                    help="directory holding index/ (PackedReference and "
                         "index); reads and runs go to its soak/")
    ap.add_argument("--reads", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--leg", default="all", choices=["A", "B", "all"])
    ap.add_argument("--kill-frac", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the CLI runs: cuda or cpu")
    args = ap.parse_args(argv)

    fq = ensure_reads(args.workdir, args.reads)
    extra = ["--batch-reads", str(args.batch)]
    result = {"metric": "soak_50k", "n_reads": args.reads,
              "batch": args.batch, "device": args.device}
    if args.leg in ("A", "all"):
        result["leg_A"] = leg_a(args, fq, extra)
    if args.leg in ("B", "all"):
        result["leg_B"] = leg_b(args, fq, extra)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
