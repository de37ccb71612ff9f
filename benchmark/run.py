#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

1. Set-up: the genome of the cell's configuration and a pool of reads of
   its traffic mix, both from the configuration's ``data_seed``, the
   pool's batches in an order drawn from --seed; the entry's index and
   aligner (entries/<entry>.py); one warm batch. ``setup_s`` runs from the start
   of this script, before ``import torch``, to the first timed batch.
2. The window: whole batches of the pool, cycled in order, each on the
   heels of the last, until --seconds have passed. Its rate (every read
   completed over the time from the window's start to the last batch's
   synchronize) is logged on stderr; the traced run reports it, over
   the window's untraced rest, as the per-layer ``entry.reads_per_s``.
3. The check: the plain reference (reference.py) judges the SAM lines
   the window produced; each number is printed beside its limit
   (limits/<cell>.json) as the last lines on stderr and under "check",
   the last key of the result.
4. The result: one JSON line, the last of stdout. With --trace 0 its
   metrics are the cell's end-to-end metrics; with --trace 1 the batches
   of the window's first third run under torch.profiler, each port stage
   also opening a profiler range of its name, and the metrics are the
   cell's per-layer metrics (metrics/<metric>.py) over those batches
   (``entry.reads_per_s`` over the batches after them).

Without a CUDA card, or with fewer than the cell asks for, it exits 2
and prints no result; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import device as dev_math  # noqa: E402
from benchmark import reference, traffic  # noqa: E402
from benchmark.genome import make_genome  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lamsa_tpu")
# A traced run profiles the batches of the window's first third: a
# profiler over all of it records about two million device spans, which
# take minutes to collect and read; the rest of the window runs
# untraced, for its full length, and is checked all the same.
TRACE_SHARE = 1 / 3
GIB = 1 << 30


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of the manifest with the files it names."""

    def __init__(self, workload: str, bench_dir: Path = BENCH,
                 manifest: Path | None = None):
        man = load_json(manifest or bench_dir.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in man["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the manifest "
                             f"has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        self.config = load_json(bench_dir / "configs"
                                / f"{self.workload['config']}.json")
        self.traffic = load_json(bench_dir / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{workload}.json")
        self.entry_path = bench_dir / "entries" / \
            f"{self.config['entry']}.py"
        self.metric_paths = {m["name"]: bench_dir / "metrics"
                             / f"{m['name']}.py"
                             for m in man["per_layer"]
                             if workload in m.get("workloads", [workload])}
        self.end_to_end = [m for m in man["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.units = {m["name"]: m["unit"]
                      for m in man["end_to_end"] + man["per_layer"]}


def streams(data_seed: int, seed: int):
    """Independent generators for the genome and the pool of reads, from
    the configuration's ``data_seed``, and for the order of the pool's
    batches and the check's sample, from --seed. Every seed runs the same
    batches, in an order of its own: the reads decide how much work and
    device memory a batch takes, so reads drawn from --seed changed the
    device peak from seed to seed while two runs of one seed agreed to
    the byte."""
    data = np.random.SeedSequence(data_seed).spawn(2)
    run = np.random.SeedSequence(seed).spawn(2)
    return [np.random.default_rng(s) for s in data + run]


def host_cpu() -> dict:
    """This process's CPU seconds, and its main thread's: a window whose
    main thread is on the CPU for nearly all of its wall is bound by the
    host, and its rate follows the host's speed."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "thread_s": time.thread_time()}


def peak_rss_bytes() -> int:
    """The process's peak resident set (getrusage's ru_maxrss, KiB on
    Linux; the card's machine reports no VmHWM)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class StageTrace:
    """While on, each stage of the port's StageStats also opens a
    torch.profiler range of the same name (the instance's ``stage`` is
    shadowed; the class is left as it is)."""

    def __init__(self, stats):
        self.stats = stats

    def __enter__(self):
        from torch.profiler import record_function
        inner = self.stats.stage

        @contextlib.contextmanager
        def stage(name):
            with record_function(f"stage:{name}"), inner(name):
                yield
        self.stats.stage = stage
        return self

    def __exit__(self, *exc):
        del self.stats.stage


def trace_spans(prof):
    """(device spans [(start_ns, end_ns, name)], stage ranges [(name,
    start_ns, end_ns)], window (start_ns, end_ns)) of a finished
    profiler run, read from kineto's raw events."""
    from torch.autograd import DeviceType
    dev, stages, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if name.startswith("stage:") and e.device_type() == DeviceType.CUDA:
            continue            # a range's copy on the device's timeline
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, end, name))
        elif name == "stage:window":
            window = (s, end)
        elif name.startswith("stage:"):
            stages.append((name[6:], s, end))
    return dev, stages, window


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", program_config: dict | None = None,
             fault=None, log=print):
    """One run of a cell. Returns (result dict, check lines). The
    program gets ``program_config`` in place of the cell's configuration
    where given (the control), and ``fault`` (faults.py) is planted
    under the entry before its warm-up; the reference always judges by
    the cell's configuration."""
    import torch

    g_rng, r_rng, o_rng, c_rng = streams(int(cell.config["data_seed"]),
                                         seed)
    t0 = time.perf_counter()
    genome = make_genome(cell.config["genome"], g_rng)
    batch = int(cell.config["batch_reads"])
    batches = traffic.make_pool(genome, cell.traffic, batch, r_rng)
    batches = [batches[i] for i in o_rng.permutation(len(batches))]
    log(f"genome {len(genome.codes)} bp and {len(batches)} batches in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    entry_mod = load_module(cell.entry_path, f"entry_{cell.config['entry']}")
    entry = entry_mod.Entry(program_config or cell.config, genome, device)
    log(f"index and aligner in {time.perf_counter() - t0:.2f} s")
    if fault is not None:
        fault(entry)
    t0 = time.perf_counter()
    entry.run(batches[-1])                       # warm-up
    log(f"warm batch in {time.perf_counter() - t0:.2f} s")
    setup_s = time.perf_counter() - T_START

    stats = entry.stats
    stats.reset()
    done, outputs = [], []
    prof, snap, traced_reads, resumed = None, None, 0, None
    with contextlib.ExitStack() as tracing:
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if device.startswith("cuda"):
                acts.append(ProfilerActivity.CUDA)
            prof = tracing.enter_context(profile(activities=acts))
            tracing.enter_context(StageTrace(stats))
            tracing.enter_context(record_function("stage:window"))
        h0 = host_cpu()
        w0 = w1 = time.perf_counter()
        k, times = 0, []
        while True:
            b = batches[k % len(batches)]
            outputs.append(entry.run(b))
            done.append(b)
            k += 1
            t = time.perf_counter()
            times.append(t - w1)
            w1 = t
            if trace and snap is None and w1 - w0 >= TRACE_SHARE * seconds:
                snap = stats.snapshot()
                traced_reads = sum(len(x) for x in done)
                tracing.close()
                # the profiler's collection (tens of seconds) is no
                # aligning: the window goes on for its full length
                t = time.perf_counter()
                w0 += t - w1
                w1 = resumed = t
            if w1 - w0 >= seconds:
                break
    window_s = w1 - w0
    h1 = host_cpu()
    log(f"{k} batches in {window_s:.3f} s: batch seconds min "
        f"{min(times):.3f} median {float(np.median(times)):.3f} max "
        f"{max(times):.3f}; first {times[0]:.3f}")
    n_reads = sum(len(b) for b in done)
    log(f"{n_reads} reads, {n_reads / window_s:.3f} reads/s; host over "
        f"the window: process CPU {h1['cpu_s'] - h0['cpu_s']:.3f} s, main "
        f"thread {h1['thread_s'] - h0['thread_s']:.3f} s")
    log("batch seconds: " + " ".join(f"{t:.3f}" for t in times))
    if not trace:
        log("stage seconds: " + ", ".join(
            f"{n} {v:.3f}" for n, v in stats.snapshot()["wall_s"].items()))
    is_cuda = device.startswith("cuda")
    dev_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    rss_peak = peak_rss_bytes()
    result_device = {"platform": "gpu" if is_cuda else "cpu",
                     "kind": torch.cuda.get_device_name() if is_cuda
                     else "cpu",
                     "count": cell.chips, "memory_peak_bytes": dev_peak}
    metrics, breakdown = {}, None
    if not trace:
        values = {"setup_s": setup_s,
                  "device_peak_gib": dev_peak / GIB,
                  "host_peak_rss_gib": rss_peak / GIB}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        t0 = time.perf_counter()
        spans, stages, window = trace_spans(prof)
        prof = None
        if window is None:
            raise RuntimeError("the profiler recorded no window range")
        spans = [(max(s, window[0]), min(e, window[1]), n)
                 for s, e, n in spans if e > window[0] and s < window[1]]
        ctx = {"stats": snap, "reads": traced_reads, "device_spans": spans,
               "window_ns": window, "device": dev_math,
               "untraced_reads": n_reads - traced_reads,
               "untraced_s": w1 - resumed if resumed is not None else 0.0}
        for name, path in cell.metric_paths.items():
            v = load_module(path, f"metric_{name}").read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": cell.units[name]}
        busy = dev_math.busy_s(spans)
        result_device["busy_s"] = busy
        result_device["window_s"] = (window[1] - window[0]) / 1e9
        gaps = dev_math.idle_gaps(spans, *window)
        breakdown = {
            "device_ops": [[n[:120], s]
                           for n, s in dev_math.top_ops(spans)],
            "idle_gaps": [[n, s] for n, s in
                          dev_math.gaps_by_stage(gaps, stages)[:10]]}
        log(f"trace read in {time.perf_counter() - t0:.2f} s: "
            f"{len(spans)} device spans, {len(stages)} stage ranges")
        for n, sec in dev_math.top_ops(spans, 10**6):
            if not n.startswith("void at::native::"):
                log(f"  device {sec:.6f} s  {n[:160]}")

    # the check, once the window has closed and the program is freed
    t0 = time.perf_counter()
    reads = [r for b in done for r in b]
    lines = [entry.sam_lines(recs) for out in outputs for recs in out]
    entry.close()
    del entry, outputs
    if is_cuda:
        torch.cuda.empty_cache()
    numbers, notes = reference.judge(
        reads, lines, genome, cell.config["align"]["scores"],
        dp_sample=int(cell.limits["dp_sample"]), rng=c_rng)
    check = {k: {"value": v, "limit": cell.limits[k]["limit"]}
             for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    for n in notes:
        log(f"fault: {n}")
    log(f"check in {time.perf_counter() - t0:.2f} s")
    result = {"correct": correct, "attempted": n_reads,
              "failed": int(numbers["record_faults"]), "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result, [f"check {k} {c['value']} limit {c['limit']}"
                    for k, c in check.items()]


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = Cell(a.workload)

    def log(msg):
        print(f"[benchmark {cell.name}] {msg}", file=sys.stderr, flush=True)

    import torch
    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    import subprocess
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    log(f"card: {torch.cuda.get_device_name()}; {smi}")
    result, check_lines = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                                   log=log)
    bad = forbidden_modules()
    if bad:
        log(f"the process loaded {bad}: the port must not import them")
        return 3
    for line in check_lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
