#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (lamsa_tpu_torch).

    python3 chip_smoke.py             # one CUDA card, no arguments
    python3 chip_smoke.py --tiles     # only the walkers' tile sizes (below)
    python3 chip_smoke.py --wholegenome   # config 4 at 3.1 Gb (below)
    python3 chip_smoke.py --cards     # several cards only (below)
    python3 chip_smoke.py --tools     # the ported validation tools (below)

Phases (any failure exits non-zero without a result line):
  1. set-up: require CUDA, print the card's name and power limit
     (nvidia-smi), build the CUDA kernels from csrc/ (one nvcc per
     source, in parallel);
  2. kernels against their plain torch versions on the card, at every
     DP bucket (M, W) with B = CHUNK_BY_M instances, exact integer
     equality, times per shape:
     a. the row pair: row DP on global instances, and on extensions
        with an N block with zdrop off and on (direction bytes of rows
        <= m, best cell, h_last through the -20000 floor; zdrop must
        change the best cell of some instance), and row traceback from
        global, extension-best and row-0 starts (step words, terminals),
        then walks built to cross the walker's tile edges (below);
     b. the antidiagonal pair on even-lo global instances with indels
        and N codes, one a 35-base deletion and one a deletion ladder:
        adiag DP (direction words below m + n, h_last through the
        floor, global score equal to the row DP's) and the walker
        (opbits, events, term0, n_ev; both stress instances must
        overflow, the 35-base run only where events are narrow); adiag
        DP and walker times beside the row pair's on the same instances;
        then walks across the walker's tile edges;
     c. both DP kernels on chunks of 1 and 37 instances at (5120, 256)
        and (128, 128), each ending in a long deletion whose E chain
        crosses every thread edge, plus zdrop extensions (exact), and
        both walkers on tile-edge walks of 1 and 37 instances there;
     Tile-edge walks (ops/testing.py walker_edge_walks): a deletion
     longer than the row walker's lane window, an insertion run longer
     than 32 rows, mixed instances, and random direction words whose
     walks leave the band on both sides. On them the kernel must equal
     its plain version, the reload path must have been taken (the
     kernel counts the tiles it stages and its blocking reloads into a
     debug output of the C entry), and on the instances with the most
     reloads those counts must equal the counts of the numpy mirror of
     its tile schedule;
  3. end to end: the config-1 world (lamsa_tpu_torch/worlds.py, a copy
     of bench.py's: 4.6 Mb genome, k=13, 512 reads of 1-5 kb, 15% SV
     reads) through align_reads on the card with batch size 256, after
     one warm batch. Prints reads/s, the stage breakdown with the
     chain_hits loop's share, the four kernels' launch counts in that
     run (each must be > 0), then each kernel's device time in one more
     pass under torch.profiler (e2e_ms), each DP wrapper's (the
     kernel, the instance order's sort and the counter's memset) and
     that of wire.compact_encode, the torch code after every row walk,
     part recall / read accuracy
     (part recall must be >= 0.99), checks the SAM of the first 32 reads
     byte for byte against the port's CPU path (the plain versions), and
     the SAM of the first 64 reads on the card with ADIAG_ENABLED False
     and True (byte-identical);
  3r. the repeat-family world of tests/test_mapq.py
     (lamsa_tpu_torch/tools/repeat_bench.py repeat_world: a 1.5 Mb
     sim.repeat_genome, about half repeats, k = 13, 100 reads of 1-6 kb,
     preset("pacbio")) on the card: every kernel launched (counts set to
     0 just before), SAM equal to the CPU path's on every read, and
     MAPQ >= 30 wrong on under 1% of at least 50 records;
  4. the 10 kb world of bench.py's 10 kb section (worlds.reads_10kb: 768
     reads of 9-11 kb on the config-1 genome): warm on 256 reads, time
     the other 512
     through align_reads with batch 256; prints reads/s, part recall
     (must be >= 0.99), DP cells and instances per bucket and the four
     kernels' launches, and checks the SAM of the first 8 timed reads
     byte for byte against the CPU path;
  5. the whole-genome FM world: chr1 and chr2 of the config-4 genome of
     tools/wholegenome_bench.py (2 x 129,166,666 bp, 8 N runs each, its
     SEED; constants and sample_reads copied into worlds.py), indexed
     with FmIndex.build on the card's host (build seconds and device
     bytes printed). 128 warm + 256 timed 9-11 kb reads from the tool's
     sample_reads through align_reads with batch 128: prints
     reads/s, the stage breakdown (FM seeding in `seed_hits`, beside
     `chain_hits`), DP instances per bucket and the four kernels'
     launches (each must be > 0); part recall must be >= 0.99 and the
     SAM of the first 8 timed reads must equal the CPU path's. Then 32
     reads of 1-3 kb at 28% error under preset("ont"): the adaptive
     re-seed with 1-edit tracks must fire on the card, and all 32 reads'
     SAM must equal the CPU path's (part recall printed only). Last, one
     retry-sized batch of seed_hits_fm with seg_quota and the 1-edit
     tracks on cuda against the same call on the CPU (all four outputs
     equal; both times printed);
  5b. coordinates past 2^31, without an index: reference words of
     config 4's 3.1e9 random codes on the card, a chunk of 24 global gap
     fills and 24 extensions (every other one reading its target
     downward) at (512, 256) whose targets lie past 2^31
     (ops/testing.py make_high_chunk; one starts 8 codes past the line,
     so its band head reaches below it, one ends at the last code).
     The t_base of every descriptor must survive unpack_desc on the
     card, and the q / t windows and the compact wires of the row pair
     (all 48) and the antidiagonal pair (the 24 globals) on the card
     must equal the plain versions on the host copy of the words and on
     the same targets placed at low coordinates;
  6. several devices, shards and validation on the card:
     a. the config-1 world (warm batch, then all 512 reads) through an
        Aligner over the mesh ["cuda:0", "cuda:0"] (two entries of one
        card, one index copy): SAM equal to phase 3's on every read,
        each kernel launched (counts set to 0 just before), DP
        instances per entry and reads/s printed; with more than one card
        also ["cuda:0", "cuda:1"] (two real cards, reads/s beside phase
        3's one entry); then phase 5's timed FM reads and its 28%-error
        set over two entries, on phase 5's index, SAM equal to phase 5's;
     b. seed_hits_sharded over 2 and 4 entries of card 0 and, with more
        than one card, over ["cuda:0", "cuda:1"] and over every card, on
        the config-1 reads, equal to seed_hits; index bytes per shard
        printed;
     c. the CLI with --device cuda on a 48-read world in a temporary
        directory: two shards merged, a simulated kill + --resume and
        -d 0 (every card) each equal one unbroken -d 1 run byte for
        byte; with more than one card, --device cuda:1 -d 1 too;
     d. validate_batch (io/samcheck.py) on every read the card aligned
        in phases 3-6a: no finding;
     e. several cards, only when torch.cuda.device_count() >= 2 (else
        it logs "phase 6e: skipped, 1 card"): config-1 (batch 256)
        through Aligner(device="cuda:1") with SAM equal to phase 3's on
        all 512 reads, every kernel launched (counts set to 0 just
        before), something allocated on cuda:1 and card 0's peak
        allocation not raised; phase 5's 256 timed FM reads on cuda:1,
        SAM equal to phase 5's; then one `python -m lamsa_tpu_torch.cli
        aln --device cuda:i --num-shards N --shard-id i` process per
        card (N = device_count(), all at once, batch 128) on the config-1
        world written to a temporary directory, merged with `merge`: the
        merged file equals one process's on cuda:0 byte for byte apart
        from the @PG command line; the wall of the N processes and of
        one is printed. Every check runs before the phase fails;
     f. full_align_step over two entries of card 0 and, with more than
        one card, over ["cuda:0", "cuda:1"], replicated and sharded
        index, equal to the plain CPU run;
     g. the JAX package's multi-host design: the config-1 world written
        to a temporary directory once (genome and reads as FASTA,
        `cli index -k 13`),
        then two `python -m lamsa_tpu_torch.parallel.host_loop` processes
        on cuda:0 (batch 256, so each owns one batch), joined by
        multihost.initialize at a free local port, each aligning its
        round-robin batches, merged by merge_sam_shards on process 0,
        three times over: every process exits 0, every kernel is
        launched in each, the merged records equal phase 3's byte for
        byte, and the three runs take at most 60 s with the world's
        files; per process its reads/s, launches, max_memory_allocated,
        reserved bytes, in-flight budget, the steps of its start-up and
        its host RSS, and per run the wall (first start to last exit),
        the start-up share and the merge's seconds are printed. With more
        than one card, also one process per card (cuda:i in process i,
        batch 128, three times) with the same checks, beside phase 6e's
        shard processes.
The script imports nothing of JAX, of the JAX package, of bench.py or of
tools/, and fails if any of them was loaded. The last two lines are a
JSON summary of the kernels (per kernel: launches, max_abs_err, ms and
plain_ms summed over the 9 phase-2 buckets, bound_ms with bound_by,
library_ms null, e2e_ms) and the result line
{"ok": true, "device": {...}}.

--wholegenome runs set-up and then config 4 whole: all 24 chromosomes
of the genome of tools/wholegenome_bench.py (3.1 Gb, 8 N runs per
chromosome, its SEED), FmIndex.build on the host (sa_rate 16; each build phase timed),
AlignConfig(ScoreParams(), seed_step=10), 128 warm and 256 timed 10 kb
reads of the tool's sample_reads through align_reads on the card with
batch 128, then phase 5's 32 reads at 28% error under preset("ont").
It checks k == 16, the seg quota on, some timed read past 2^31 (all its
truth parts start there), all four kernels launched in the timed run,
part_recall >= 0.99 on all timed reads and on those past 2^31, the
adaptive re-seed fired at 28% error, no validate_batch finding on any
read the card aligned, and SAM equal to the CPU path's on the first 8
timed reads, on 8 more past 2^31 and on all 32 reads at 28% error. Every
check runs before the mode fails on any. It prints genome and build
seconds (per build phase), peak host RSS, resident device bytes and
torch.cuda.max_memory_allocated, warm-batch seconds, timed reads/s, the
stage shares, densified reads, launches, DP buckets and its elapsed
seconds; its last line is a JSON object {"wholegenome": ...}. It took
1419 s on an H100 host of 8 cores, the build 1217 s of it: give it
--timeout 3600.

--tools runs set-up and then the ported validation tools
(lamsa_tpu_torch/tools/) on the card: (a) repeat_bench at 5 Mb / 300 reads
and at chr20 scale, 64 Mb / 1,000 reads (every kernel launched, MAPQ >= 30
error < 1% on at least 50 records, SAM equal to the CPU path's on the
first 64 reads, DP buckets reached logged, (5120, 256) among them or not);
(b) the whole ONT preset sweep (6 candidates x 4 error profiles, 48 reads a
cell; the step8,mm2, step6,mm2 and fm+1edit(ont) rows at 28% equal to the
CPU path's SAM on every read); (c) soak_bench --leg all on a workdir that
`cli index` builds from the 64 Mb repeat genome: 20,000 reads of 9-11 kb at
batch 256 through `cli aln --device cuda`, shard 0 of leg B killed at half
its reads and resumed; leg A's RSS and device memory last quarter within
1.10x of the first, its throughput windows with their max_dev, the merged
SAM equal to leg A's; then in this process one soak batch (its
launches; SAM equal to leg A's records of those reads) and the first soak
batch reaching the (5120, 256) bucket, narrowed to at most 8 reads that
still reach it, whose SAM must equal the CPU path's; last, one
host_loop process on the soak's index and first batch of reads prints
its host RSS after import torch, the CUDA context, the kernel and native
libraries, the index and reference upload and its first batch, beside
leg A's (where a `cli aln` process's RSS goes). Every check runs
and is reported before the mode fails on any; its last lines are a JSON
object {"tools": ...} and the result line. Give it --timeout 3600.

--cards (more than one card) runs set-up and then only what the
several-card phases are compared with: phases 3 and 5, then phase 6
(a-g); its last line is a JSON object {"cards": ...} with phase 6e's
numbers, the two-card mesh's of 6a and phase 6g's.

--tiles rebuilds the kernels with each tile shape of TILE_VARIANTS for
the two walkers (the committed shape first) and times both walkers at
all 9 buckets on the phase-2 instances, at B = CHUNK_BY_M and on their
first 128 instances, and the row walker on chunks whose every instance
carries a W/2 - 16 deletion (the cost of its leftward D-run scan); every
variant's outputs equal the first's. Its last line is a JSON object
{"tiles": ...}.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

FLOOR = -20000          # dead DP lanes may differ only below this
N_SAM_CHECK = 32
N_ENGINE_CHECK = 64
N_SAM_CHECK_10KB = 8
N_10KB, N_WARM_10KB = 768, 256      # bench.py's 10 kb section
FM_N_CHROM = 2                      # of config-4's 24 chromosomes
N_FM_WARM, N_FM_TIMED, FM_BATCH = 128, 256, 128
N_HIGH_ERR = 32
N_CLI_READS, CLI_BATCH = 48, 12     # phase 6c's world (4 batches)
SHARD_BATCH = 128                   # phase 6e's shard processes (4 batches)
MH_PROCS, MH_BATCH, MH_RUNS = 2, 256, 3    # phase 6g on one card
MH_WALL_S = 60.0                    # phase 6g's bar on one card
COORD_BUCKET, COORD_K = (512, 256), 24   # phase 5b's chunk
WG_N_CHROM_RUN = 24                 # --wholegenome: all of config 4
REPEAT_MB, N_REPEAT = 1.5, 100      # phase 3r: tests/test_mapq.py's world
REPEAT_READ_LEN = (1000, 6000)
TOOLS_REPEAT = ((5.0, 300), (64.0, 1000))   # --tools (a): Mb, reads
N_TOOLS_SAM_CHECK = 64
N_ONT = 48                          # --tools (b): reads per cell
ONT_CHECK_ROWS = ("step8,mm2", "step6,mm2", "fm+1edit(ont)")
SOAK_READS, SOAK_BATCH, SOAK_KILL = 20000, 256, 0.5    # --tools (c)
SOAK_SCAN = 8           # soak batches searched for one reaching (5120, 256)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------- timing

def cuda_ms(fn, reps: int) -> float:
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


KERNEL_NAMES = {        # kernel name fragments in a device trace
    "banded_sw_row": "row_dp::kernel",
    "traceback_row": "traceback_row_kernel",
    "banded_sw_adiag": "adiag_dp::kernel",
    "traceback_adiag": "traceback_adiag_kernel",
}
DP_WRAPPERS = ("banded_sw_row", "banded_sw_adiag")
BRACKETED = DP_WRAPPERS + ("compact_encode",)   # timed by name in phase 3
# phase-2 sums of the walkers when one thread walked each instance
# through device memory (H100 80GB HBM3, 700 W; PERF.md section 6)
ONE_THREAD_WALK_MS = {"traceback_row": 5.311, "traceback_adiag": 5.884}


def profiled(fn, ok, what, tries=3):
    """Run fn() under torch.profiler: (device events, host events), each
    a list of (start us, end us, name), with the device's
    synchronization records (waits, not work) left out. The profiler now
    and then returns a trace without the device events; such a run is
    repeated, at most `tries` times, until ok(device events) holds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev, host = [], []
        for e in prof.events():
            ev = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                if "sync" not in e.name.lower():
                    dev.append(ev)
            elif e.device_type == DeviceType.CPU:
                host.append(ev)
        if ok(dev):
            return dev, host
        log(f"profiler trace of {what} lacks device events "
            f"({len(dev)}: {sorted({n[:50] for _, _, n in dev})[:6]}); again")
    fail(f"{tries} profiler traces of {what} lacked device events")


def kernel_device_ms(fn):
    """Run fn() once under torch.profiler. Returns (per kernel, its summed
    device ms; per DP wrapper, the device work its calls ran, by name:
    the kernel, longest_first's sort and the counter's memset, as
    (ms, count), and the same for wire.compact_encode; the bracketed
    names in call order). To tell this work apart, each such call
    that the pipeline makes (through ops/dp_chain.py) is bracketed on its
    stream by two marker kernels (torch.cuda._sleep, whose kernel is
    spin_kernel), and the device work
    between a pair of markers is that call's, except the copies that the
    collect threads put on the same stream meanwhile."""
    import torch

    from lamsa_tpu_torch.ops import dp_chain
    orig = {n: getattr(dp_chain, n) for n in BRACKETED}
    order = []                  # the wrappers called, in launch order

    def bracketed(name, f):
        def call(*a, **k):
            torch.cuda._sleep(1)
            out = f(*a, **k)
            torch.cuda._sleep(1)
            order.append(name)
            return out
        return call

    def all_kernels(dev):
        return all(any(frag in n for _, _, n in dev)
                   for frag in KERNEL_NAMES.values())

    def run():
        order.clear()
        fn()

    for n, f in orig.items():
        setattr(dp_chain, n, bracketed(n, f))
    try:
        dev, _ = profiled(run, all_kernels, "a config-1 pass")
    finally:
        for n, f in orig.items():
            setattr(dp_chain, n, f)
    dev.sort()
    marks = [i for i, (_, _, n) in enumerate(dev) if "spin_kernel" in n]
    if len(marks) != 2 * len(order):
        names = {}
        for _, _, n in dev:
            names[n[:50]] = names.get(n[:50], 0) + 1
        fail(f"{len(marks)} marker kernels for {len(order)} bracketed "
             f"calls; device events by name: "
             f"{sorted(names.items(), key=lambda kv: -kv[1])[:12]}")
    kern = dict.fromkeys(KERNEL_NAMES, 0.0)
    for s, e, name in dev:
        for k, frag in KERNEL_NAMES.items():
            if frag in name:
                kern[k] += (e - s) / 1e3
    wrap = {w: {} for w in BRACKETED}       # wrapper -> name -> (ms, n)
    for c, w in enumerate(order):
        for s, e, name in dev[marks[2 * c] + 1:marks[2 * c + 1]]:
            if not name.startswith("Memcpy"):
                ms, n = wrap[w].get(name, (0.0, 0))
                wrap[w][name] = (ms + (e - s) / 1e3, n + 1)
    return kern, wrap, list(order)


def dp_kernel_ms(calls, reps=3):
    """calls: (fn, kernel name fragment) pairs, each fn launching one
    such kernel. Device ms of each call's kernel, the least of reps
    rounds, from one profiler trace: the calls run in order on one
    stream, so the k-th kernel of the trace is the k-th launch."""
    import torch
    frags = [f for _, f in calls]
    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()

    def launches(dev):
        return [(s, e) for s, e, n in sorted(dev)
                if any(f in n for f in frags)]

    def run():
        for _ in range(reps):
            for fn, _ in calls:
                fn()

    dev, _ = profiled(run, lambda d: len(launches(d)) == reps * len(calls),
                      "the DP kernels' fixed-work calls")
    ms = [(e - s) / 1e3 for s, e in launches(dev)]
    return [min(ms[r * len(calls) + i] for r in range(reps))
            for i in range(len(calls))]


# ------------------------------------------------------------------ bounds
#
# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# HBM rate and its integer operations over the INT32 issue rate. H100
# SXM (NVIDIA's data sheet and Hopper white paper): 3.35 TB/s, and 132
# SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 T int32 ops/s. A band
# cell of either DP costs OPS_PER_CELL integer operations (H, E, F, the
# score and the direction bits); the cells are those this run's
# instances need (rows <= m, or antidiagonal steps <= m + n).

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_CELL = 12


def add_bound(acc, nbytes, nops):
    """Accumulate one call's bound into acc (ms, bytes_ms, ops_ms)."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / INT32_OPS_PER_S * 1e3
    acc["bound_ms"] += max(b_ms, o_ms)
    acc["bytes_ms"] += b_ms
    acc["ops_ms"] += o_ms


def new_bound():
    return {"bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}


def nbytes(*ts):
    return sum(int(t.nbytes) for t in ts)


def row_dp_work(args, W):
    """(bytes, ops) of one row-DP call: the windows and lengths read,
    the direction words of rows <= m, h_last and best written."""
    import torch
    q, m_len = args[0], args[2]
    B = q.shape[0]
    words = int(((m_len.to(torch.int64) + 3) // 4).sum()) * W
    return (nbytes(*args) + 4 * words + 4 * B * (W + 3),
            OPS_PER_CELL * int(m_len.sum()) * W)


def adiag_dp_work(args, W):
    """(bytes, ops) of one adiag-DP call: steps a <= m + n of V lanes."""
    import torch
    q, m_len, n_len = args[0], args[2], args[3]
    B = q.shape[0]
    steps = (m_len + n_len).to(torch.int64)
    words = int(((steps + 3) // 4).sum()) * (W // 2)
    return (nbytes(*args) + 4 * words + 4 * B * W,
            OPS_PER_CELL * int(steps.sum()) * (W // 2))


def walk_work(ins, outs, m_len, n_len):
    """(bytes, ops) of one walk: its small inputs, one direction byte
    per path step (at most m + n), and its outputs written once."""
    return (nbytes(*ins) + int((m_len + n_len).sum()) + nbytes(*outs), 0)


# ----------------------------------------------------------------- phases

def check_tie_rules(dev):
    """The tie rules the port's seeding and chaining rely on, on the card:
    first_argmax (and torch.argmax) pick the first maximum, and a stable
    sort keeps equal keys in input order."""
    import torch

    from lamsa_tpu_torch.ops.wire import first_argmax
    x = torch.tensor([[3, 7, 7, 1, 7], [0, 0, 0, 0, 0], [-5, -1, -9, -1, -1]],
                     device=dev)
    want = [1, 0, 1]
    if first_argmax(x, dim=1)[1].tolist() != want \
            or torch.argmax(x, dim=1).tolist() != want:
        fail("first-maximum tie rule broken on the card")
    keys = torch.randint(0, 16, (64, 8192), device=dev)
    sk, order = torch.sort(keys, dim=1, stable=True)
    later = order[:, 1:] > order[:, :-1]
    if not bool(((sk[:, 1:] != sk[:, :-1]) | later).all()):
        fail("torch.sort(stable=True) reordered equal keys on the card")
    log("tie rules ok on the card: first maximum, stable sort")


def cuda_ms_once(fn):
    """(result, ms) of one call, timed with CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


N_EDGE_WALKS = 4        # instances per tile-edge case in phases 2a / 2b
N_MIRRORED = 4          # of them all, held to the mirror's tile counts


def edge_chunk(dev, kw, rng, M, W, B, kind):
    """The tile-edge walks of ops/testing.py walker_edge_walks for one
    walker ("row" or "adiag"), B instances of each of its three cases,
    as one chunk: the walker's arguments, concatenated case after case."""
    import torch

    from lamsa_tpu_torch.ops.testing import walker_edge_walks
    walks = [walk for _name, _kind, walk in walker_edge_walks(
        rng, B, M, W, dev, kinds=(kind,), **kw)]
    return tuple(torch.cat(xs) for xs in zip(*walks))


def check_edge_chunk(kind, walk, want, M, W, chunk=0):
    """One walker's kernel on tile-edge walks, launched with its debug
    output: it must equal `want` (the plain version's outputs on the same
    walks); it must have reloaded a tile on some walk; and on the
    N_MIRRORED instances with the most reloads its counts of tiles
    staged and of blocking reloads must equal those of the numpy mirror
    of its schedule on the same words. With chunk = k the walks are
    launched k at a time, and the first of every k is also launched
    alone, as a chunk of 1, and must give the same outputs and counts.
    Returns (tiles staged, blocking reloads)."""
    import torch

    from lamsa_tpu_torch.ops import testing as T
    extra = {} if kind == "row" else {"M": M}
    tiled = T.traceback_row_tiled if kind == "row" \
        else T.traceback_adiag_tiled
    n = walk[0].shape[0]
    where = f"the {kind} walker on {n} tile-edge walks at M={M} W={W}"

    def hold(got, want, what):
        for g, w_ in zip(got, want):
            if not torch.equal(g, w_):
                e = int((g.to(torch.int64) - w_.to(torch.int64)).abs().max())
                fail(f"{where}{what} != plain (max abs err {e})")

    def launch(lo, hi):
        part = tuple(x[lo:hi].contiguous() for x in walk)
        out = T.walker_counts_cuda(kind, *part, **extra)
        torch.cuda.synchronize()
        return out

    parts = [launch(b, b + (chunk or n)) for b in range(0, n, chunk or n)]
    got = tuple(torch.cat(xs) for xs in zip(*(g for g, _ in parts)))
    counts = torch.cat([c for _, c in parts])
    hold(got, want, f" ({chunk or n} at a time)")
    for b in range(0, n, chunk) if chunk else ():
        got1, counts1 = launch(b, b + 1)
        hold(got1, tuple(x[b:b + 1] for x in want),
             f", instance {b} as a chunk of 1,")
        if not torch.equal(counts1[0], counts[b]):
            fail(f"{where}: instance {b} staged {counts1[0].tolist()} alone "
                 f"and {counts[b].tolist()} in its chunk")
    counts = counts.cpu()
    tiles, reloads = counts.sum(dim=0).tolist()
    if reloads == 0:
        fail(f"{where}: no walk made the kernel reload a tile")
    pick = torch.argsort(counts[:, 1], descending=True,
                         stable=True)[:N_MIRRORED]
    _, mirror = tiled(*(x.cpu()[pick] for x in walk), **extra)
    if not torch.equal(counts[pick], mirror):
        bad = int((counts[pick] != mirror).any(dim=1).nonzero()[0])
        fail(f"{where}: the kernel staged {counts[pick][bad].tolist()} "
             f"(tiles, blocking reloads) on instance {int(pick[bad])}, "
             f"the mirror of its schedule {mirror[bad].tolist()}")
    return tiles, reloads


def phase_kernels(dev, scores, rng):
    import torch

    from lamsa_tpu_torch.ops.banded_sw_row import (banded_sw_row,
                                                   banded_sw_row_plain)
    from lamsa_tpu_torch.ops.testing import (make_batch, make_zdrop_batch,
                                             unpack_rows)
    from lamsa_tpu_torch.ops.traceback_row import (traceback_row,
                                                   traceback_row_plain)
    from lamsa_tpu_torch.pipeline.extend import BUCKETS, CHUNK_BY_M

    kw = dict(match=scores.match, mismatch=scores.mismatch,
              gapo=scores.gap_open, gape=scores.gap_ext)
    err = {"dp": 0, "tb": 0}
    tot = {"dp": 0.0, "dp_plain": 0.0, "tb": 0.0, "tb_plain": 0.0}
    bnd = {"dp": new_bound(), "tb": new_bound()}

    def diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    def on_dev(arrs):
        return [torch.from_numpy(a).to(dev) for a in arrs]

    check_tie_rules(dev)
    log("phase 2a: row pair vs plain versions (exact), times in ms per call "
        "(global instances, zdrop off)")
    log(f"{'M':>5} {'W':>4} {'B':>5}  {'dp':>9} {'dp_plain':>9}  "
        f"{'tb':>9} {'tb_plain':>9}  zdrop_changed_best  "
        f"edge-walk reloads/tiles")
    for M, W in BUCKETS:
        B = CHUNK_BY_M[(M, W)]
        q, t_win, m_len, n_len, lo = on_dev(make_batch(rng, B, M, W))
        zq, zt, zm, zn, zlo, zd = on_dev(make_zdrop_batch(rng, B, M, W))
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        cases = {"global": (q, t_win, m_len, n_len, lo, zero),
                 "ext_zdrop_off": (zq, zt, zm, zn, zlo, zero),
                 "ext_zdrop_on": (zq, zt, zm, zn, zlo, zd)}
        res, dp_plain_ms = {}, 0.0
        for name, args in cases.items():
            got = banded_sw_row(*args, **kw)
            want, ms = cuda_ms_once(lambda: banded_sw_row_plain(*args, **kw))
            if name == "global":
                dp_plain_ms = ms
            rows = torch.arange(M, device=dev)[None, :, None]
            live = rows < args[2][:, None, None].to(torch.int64)
            dg, dw = unpack_rows(got["dirs32"]), unpack_rows(want["dirs32"])
            e = max(diff(torch.where(live, dg, 0), torch.where(live, dw, 0)),
                    diff(got["best"], want["best"]),
                    diff(got["h_last"].clamp(min=FLOOR),
                         want["h_last"].clamp(min=FLOOR)))
            if e:
                fail(f"banded_sw_row != plain at M={M} W={W} {name} "
                     f"(max abs err {e})")
            err["dp"] = max(err["dp"], e)
            res[name] = got
        changed = int((res["ext_zdrop_off"]["best"]
                       != res["ext_zdrop_on"]["best"]).any(dim=1).sum())
        if changed == 0:
            fail(f"zdrop changed no best cell at M={M} W={W}: the kernel's "
                 f"zdrop freeze was not exercised")
        dp_ms = cuda_ms(lambda: banded_sw_row(*cases["global"], **kw), 3)

        # walks: global (m, n) starts on the global dirs; extension-best
        # starts on the zdrop-on dirs, instance 2 walking from row 0
        ext = res["ext_zdrop_on"]
        si_e = ext["best"][:, 1].contiguous()
        si_e[2] = 0
        # the tile-edge walks ride the second chunk, so that the first
        # stays the one that is timed
        edge = edge_chunk(dev, kw, rng, M, W, N_EDGE_WALKS, "row")
        ext_walk = (ext["dirs32"], zlo, si_e, ext["best"][:, 2].contiguous())
        walks = [(res["global"]["dirs32"], lo, m_len.clone(),
                  (n_len - m_len - lo).contiguous()),
                 tuple(torch.cat(xs) for xs in zip(ext_walk, edge))]
        tb_plain_ms = 0.0
        for i, (dirs32, lo_, si, sd) in enumerate(walks):
            got = traceback_row(dirs32, lo_, si, sd)
            want, ms = cuda_ms_once(
                lambda: traceback_row_plain(dirs32, lo_, si, sd))
            if i == 0:
                tb_plain_ms = ms
            e = max(diff(got[0], want[0]), diff(got[1], want[1]))
            if e:
                fail(f"traceback_row != plain at M={M} W={W} "
                     f"(max abs err {e})")
            err["tb"] = max(err["tb"], e)
        tiles, reloads = check_edge_chunk(
            "row", edge, tuple(x[B:] for x in want), M, W)
        tb_ms = cuda_ms(lambda: traceback_row(*walks[0]), 3)
        add_bound(bnd["dp"], *row_dp_work(cases["global"], W))
        add_bound(bnd["tb"], *walk_work(
            walks[0][1:], traceback_row(*walks[0]), m_len, n_len))
        log(f"{M:>5} {W:>4} {B:>5}  {dp_ms:9.3f} {dp_plain_ms:9.3f}  "
            f"{tb_ms:9.3f} {tb_plain_ms:9.3f}  {changed}/{B}  "
            f"{reloads}/{tiles}")
        tot["dp"] += dp_ms
        tot["dp_plain"] += dp_plain_ms
        tot["tb"] += tb_ms
        tot["tb_plain"] += tb_plain_ms
    log(f"phase 2a ok: the row pair equals its plain versions at all "
        f"{len(BUCKETS)} buckets (global instances; N-block extensions "
        f"with zdrop off and on, zdrop firing in each bucket; global, "
        f"extension-best and row-0 traceback starts; tile-edge walks with "
        f"the kernel's tile counts equal to its mirror's and a reload in "
        f"each bucket)")
    log(f"row walker, 9 buckets summed: {tot['tb']:.3f} ms (one thread per "
        f"instance through device memory: "
        f"{ONE_THREAD_WALK_MS['traceback_row']} ms)")
    return err, tot, bnd


def phase_adiag(dev, scores, rng):
    """Phase 2b: the antidiagonal pair against its plain versions, and
    its times beside the row pair's on the same global instances."""
    import torch

    from lamsa_tpu_torch.ops.banded_sw_adiag import (banded_sw_adiag,
                                                     banded_sw_adiag_plain)
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops.testing import adiag_live, make_globals
    from lamsa_tpu_torch.ops.traceback_adiag import (traceback_adiag,
                                                     traceback_adiag_plain)
    from lamsa_tpu_torch.ops.traceback_row import traceback_row
    from lamsa_tpu_torch.ops.wire import compact_wide, extract_scores
    from lamsa_tpu_torch.pipeline.extend import BUCKETS, CHUNK_BY_M

    kw = dict(match=scores.match, mismatch=scores.mismatch,
              gapo=scores.gap_open, gape=scores.gap_ext)
    err = {"adp": 0, "atb": 0}
    tot = {"adp": 0.0, "adp_plain": 0.0, "atb": 0.0, "atb_plain": 0.0}
    bnd = {"adp": new_bound(), "atb": new_bound()}

    def diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    log("phase 2b: antidiagonal pair vs plain versions (exact) and vs the "
        "row pair on the same even-lo global instances, ms per call")
    log(f"{'M':>5} {'W':>4} {'B':>5}  {'adiag_dp':>9} {'row_dp':>9} "
        f"{'plain':>9}  {'walker':>9} {'row_tb':>9} {'plain':>9}  overflow  "
        f"edge-walk reloads/tiles")
    for M, W in BUCKETS:
        B = CHUNK_BY_M[(M, W)]
        q, t_win, m_len, n_len, lo = [
            torch.from_numpy(a).to(dev)
            for a in make_globals(rng, B, M, W, stress=True)]
        args = (q, t_win, m_len, n_len, lo)
        got = banded_sw_adiag(*args, **kw)
        want, dp_plain_ms = cuda_ms_once(
            lambda: banded_sw_adiag_plain(*args, **kw))
        live = adiag_live(m_len, n_len, got["dirs32a"].shape[1])
        e = max(diff(torch.where(live, got["dirs32a"], 0),
                     torch.where(live, want["dirs32a"], 0)),
                diff(got["h_last"].clamp(min=FLOOR),
                     want["h_last"].clamp(min=FLOOR)))
        if e:
            fail(f"banded_sw_adiag != plain at M={M} W={W} (max abs err {e})")
        err["adp"] = max(err["adp"], e)
        zero = torch.zeros_like(m_len)
        row = banded_sw_row(*args, zero, **kw)
        g_a = extract_scores(got["h_last"], m_len, n_len, lo)[0]
        g_r = extract_scores(row["h_last"], m_len, n_len, lo)[0]
        if not torch.equal(g_a, g_r):
            fail(f"adiag and row global scores differ at M={M} W={W}")

        sd = (n_len - m_len - lo).contiguous()
        walk = (got["dirs32a"], m_len, sd, (lo >> 1).contiguous())
        # the tile-edge walks ride the same chunk, after the B instances
        # (the times below are taken on the B instances alone)
        edge = edge_chunk(dev, kw, rng, M, W, N_EDGE_WALKS, "adiag")
        both = tuple(torch.cat(xs) for xs in zip(walk, edge))
        tg = traceback_adiag(*both, M=M)
        tw, tb_plain_ms = cuda_ms_once(
            lambda: traceback_adiag_plain(*both, M=M))
        e = max(diff(a, b) for a, b in zip(tg, tw))
        if e:
            fail(f"traceback_adiag != plain at M={M} W={W} "
                 f"(max abs err {e})")
        err["atb"] = max(err["atb"], e)
        tiles, reloads = check_edge_chunk(
            "adiag", edge, tuple(x[B:] for x in tw), M, W)
        tg = tuple(x[:B] for x in tg)
        n_ev = tg[3].cpu().numpy()
        if n_ev[-1] != 0xFFFF or (not compact_wide(M)
                                  and n_ev[-2] != 0xFFFF):
            fail(f"the walker's event overflow was not exercised at M={M} "
                 f"W={W} (n_ev of the stress instances {n_ev[-2:]})")

        adp_ms = cuda_ms(lambda: banded_sw_adiag(*args, **kw), 3)
        rdp_ms = cuda_ms(lambda: banded_sw_row(*args, zero, **kw), 3)
        rwalk = (row["dirs32"], lo, m_len.clone(), sd)
        atb_ms = cuda_ms(lambda: traceback_adiag(*walk, M=M), 3)
        add_bound(bnd["adp"], *adiag_dp_work(args, W))
        add_bound(bnd["atb"], *walk_work(walk[1:], tg, m_len, n_len))
        rtb_ms = cuda_ms(lambda: traceback_row(*rwalk), 3)
        log(f"{M:>5} {W:>4} {B:>5}  {adp_ms:9.3f} {rdp_ms:9.3f} "
            f"{dp_plain_ms:9.3f}  {atb_ms:9.3f} {rtb_ms:9.3f} "
            f"{tb_plain_ms:9.3f}  {int((n_ev == 0xFFFF).sum())}/{B}  "
            f"{reloads}/{tiles}")
        tot["adp"] += adp_ms
        tot["adp_plain"] += dp_plain_ms
        tot["atb"] += atb_ms
        tot["atb_plain"] += tb_plain_ms
    log(f"phase 2b ok: the antidiagonal pair equals its plain versions at "
        f"all {len(BUCKETS)} buckets, with event overflow in each; global "
        f"scores equal the row DP's; tile-edge walks with the kernel's tile "
        f"counts equal to its mirror's and a reload in each bucket")
    log(f"adiag walker, 9 buckets summed: {tot['atb']:.3f} ms (one thread "
        f"per instance through device memory: "
        f"{ONE_THREAD_WALK_MS['traceback_adiag']} ms)")
    return err, tot, bnd


def phase_edges(dev, scores, rng):
    """Phase 2c: both DP kernels against their plain versions on small
    chunks (B = 1 and 37, fewer instances than the card has SMs, so the
    persistent warps' scheduler runs out of work at once) at (5120, 256)
    and (128, 128); the last instance of each carries a W/2 - 16 base
    deletion whose E chain crosses every thread edge of the lane split
    on its way, and one chunk per shape is N-block extensions with
    zdrop. Then, per shape, both walkers on a chunk of 37 instances of
    each tile-edge case and on single instances of it (check_edge_chunk).
    Returns the DP kernels' max abs errors (must be 0; a walker that
    differs fails at once)."""
    import torch

    from lamsa_tpu_torch.ops.banded_sw_adiag import (banded_sw_adiag,
                                                     banded_sw_adiag_plain)
    from lamsa_tpu_torch.ops.banded_sw_row import (banded_sw_row,
                                                   banded_sw_row_plain)
    from lamsa_tpu_torch.ops.testing import (adiag_live, edge_batch,
                                             make_zdrop_batch, unpack_rows)
    from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag_plain
    from lamsa_tpu_torch.ops.traceback_row import traceback_row_plain

    kw = dict(match=scores.match, mismatch=scores.mismatch,
              gapo=scores.gap_open, gape=scores.gap_ext)

    def diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    def on_dev(arrs):
        return [torch.from_numpy(a).to(dev) for a in arrs]

    err = {"dp": 0, "adp": 0}
    for M, W in ((5120, 256), (128, 128)):
        for B in (1, 37):
            q, t, m, n, lo = on_dev(edge_batch(rng, B, M, W))
            rows = [(q, t, m, n, lo, torch.zeros_like(m))]
            if B > 1:
                rows.append(tuple(on_dev(make_zdrop_batch(rng, B, M, W))))
            for args in rows:
                got = banded_sw_row(*args, **kw)
                want = banded_sw_row_plain(*args, **kw)
                live = torch.arange(M, device=dev)[None, :, None] \
                    < args[2][:, None, None].to(torch.int64)
                e = max(diff(torch.where(live, unpack_rows(got["dirs32"]), 0),
                             torch.where(live, unpack_rows(want["dirs32"]),
                                         0)),
                        diff(got["best"], want["best"]),
                        diff(got["h_last"].clamp(min=FLOOR),
                             want["h_last"].clamp(min=FLOOR)))
                if e:
                    fail(f"banded_sw_row != plain at M={M} W={W} B={B} "
                         f"(max abs err {e})")
                err["dp"] = max(err["dp"], e)
            args = on_dev(edge_batch(rng, B, M, W, adiag=True))
            got = banded_sw_adiag(*args, **kw)
            want = banded_sw_adiag_plain(*args, **kw)
            live = adiag_live(args[2], args[3], got["dirs32a"].shape[1])
            e = max(diff(torch.where(live, got["dirs32a"], 0),
                         torch.where(live, want["dirs32a"], 0)),
                    diff(got["h_last"].clamp(min=FLOOR),
                         want["h_last"].clamp(min=FLOOR)))
            if e:
                fail(f"banded_sw_adiag != plain at M={M} W={W} B={B} "
                     f"(max abs err {e})")
            err["adp"] = max(err["adp"], e)
        # both walkers on three chunks of 37 tile-edge walks (one per
        # case), and on the first instance of each alone (a chunk of 1)
        seen = {}
        for kind, plain, extra in (
                ("row", traceback_row_plain, {}),
                ("adiag", traceback_adiag_plain, {"M": M})):
            edge = edge_chunk(dev, kw, rng, M, W, 37, kind)
            seen[kind] = check_edge_chunk(kind, edge, plain(*edge, **extra),
                                          M, W, chunk=37)
        log(f"{M:>5} {W:>4}  walkers' blocking reloads / tiles staged on "
            f"3 x 37 tile-edge walks: " + ", ".join(
                f"{k} {r}/{t}" for k, (t, r) in seen.items()))
    log("phase 2c ok: both DP kernels equal their plain versions on "
        "chunks of 1 and 37 instances at (5120, 256) and (128, 128), a "
        "long deletion's E chain across every thread edge in each, and "
        "N-block extensions with zdrop; both walkers equal theirs on "
        "tile-edge walks of 1 and 37 instances, tile counts equal to the "
        "mirror's, reloads taken")
    return err


SMALL_CHUNK = 128       # instances in a main-path-sized DP chunk


def phase_fixed(dev, scores, rng):
    """Phase 2d: each DP kernel's fixed per-instance work (the windows'
    staging, row or step 0, the best-cell fold and the stores) beside its
    whole time, both as kernel device time: the phase-2 global instances
    at B = CHUNK_BY_M and their first SMALL_CHUNK, once as they are and
    once with every m (for the adiag DP m and n) set to 0, so that only
    the fixed work runs. The staging is a part of that work, so its share
    of the kernel's time is at most the printed share. Beside them the
    two walkers' kernel device time on the walks from (m, n) over the same
    instances, at both sizes (no launch or allocation of the wrapper in
    it, which the CUDA-event times of phases 2a / 2b include)."""
    import torch

    from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops.testing import make_batch, make_globals
    from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag
    from lamsa_tpu_torch.ops.traceback_row import traceback_row
    from lamsa_tpu_torch.pipeline.extend import BUCKETS, CHUNK_BY_M

    kw = dict(match=scores.match, mismatch=scores.mismatch,
              gapo=scores.gap_open, gape=scores.gap_ext)
    sums = {(k, size): [0.0, 0.0] for k in DP_WRAPPERS
            for size in ("phase2", "chunk")}
    walk_sums = {(k, size): 0.0 for k in ("traceback_row", "traceback_adiag")
                 for size in ("phase2", "chunk")}
    log("phase 2d: DP kernels' fixed per-instance work, device ms "
        "(real call / every m = 0 / share), and the walkers' kernel "
        "device ms")
    for M, W in BUCKETS:
        B = CHUNK_BY_M[(M, W)]
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        kinds = (("banded_sw_row", banded_sw_row, (2,),
                  [torch.from_numpy(a).to(dev)
                   for a in make_batch(rng, B, M, W)] + [zero]),
                 ("banded_sw_adiag", banded_sw_adiag, (2, 3),
                  [torch.from_numpy(a).to(dev)
                   for a in make_globals(rng, B, M, W, stress=True)]))
        calls, keys = [], []
        for name, fn, lens, args in kinds:
            for size, n in (("phase2", B), ("chunk", min(B, SMALL_CHUNK))):
                full = [x[:n].contiguous() for x in args]
                empty = [torch.zeros_like(x) if i in lens else x
                         for i, x in enumerate(full)]
                calls += [(lambda a=full, f=fn: f(*a, **kw),
                           KERNEL_NAMES[name]),
                          (lambda a=empty, f=fn: f(*a, **kw),
                           KERNEL_NAMES[name])]
                keys.append((name, size, n))
        n_dp = len(calls)
        q, t_win, m, n_len, lo, _ = kinds[0][3]
        row = banded_sw_row(*kinds[0][3], **kw)
        walks = [("traceback_row", traceback_row,
                  (row["dirs32"], lo, m.clone(),
                   (n_len - m - lo).contiguous()), {})]
        q, t_win, m, n_len, lo = kinds[1][3]
        ad = banded_sw_adiag(*kinds[1][3], **kw)
        walks.append(("traceback_adiag", traceback_adiag,
                      (ad["dirs32a"], m, (n_len - m - lo).contiguous(),
                       (lo >> 1).contiguous()), {"M": M}))
        wkeys = []
        for name, fn, walk, extra in walks:
            for size, n in (("phase2", B), ("chunk", min(B, SMALL_CHUNK))):
                part = [x[:n].contiguous() for x in walk]
                calls.append((lambda a=part, f=fn, k=extra: f(*a, **k),
                              KERNEL_NAMES[name]))
                wkeys.append((name, size, n))
        ms = dp_kernel_ms(calls)
        wline = []
        for (name, size, n), t in zip(wkeys, ms[n_dp:]):
            walk_sums[(name, size)] += t
            wline.append(f"{name[10:]} walker B={n}: {t:.4f}")
        ms = ms[:n_dp]
        line = []
        for (name, size, n), real, fixed in zip(keys, ms[0::2], ms[1::2]):
            sums[(name, size)][0] += real
            sums[(name, size)][1] += fixed
            line.append(f"{name[10:]} B={n}: {real:.4f} / {fixed:.4f} "
                        f"/ {fixed / real:.3f}")
        log(f"{M:>5} {W:>4}  " + "; ".join(line + wline))
    for (name, size), (real, fixed) in sums.items():
        log(f"phase 2d sum, {name} {size}: {real:.4f} ms, fixed "
            f"{fixed:.4f} ms = {fixed / real:.4f} of the kernel's time")
    for (name, size), t in walk_sums.items():
        log(f"phase 2d sum, {name} {size}: {t:.4f} ms of kernel device "
            f"time")
    return sums, walk_sums


KERNEL_MODULES = ("banded_sw_row", "traceback_row", "banded_sw_adiag",
                  "traceback_adiag")


def launch_counts(reset=False):
    """The four kernel wrappers' launch counts (set to 0 with reset)."""
    import importlib
    mods = [importlib.import_module(f"lamsa_tpu_torch.ops.{n}")
            for n in KERNEL_MODULES]
    if reset:
        for m in mods:
            m.LAUNCHES = 0
    return {n: m.LAUNCHES for n, m in zip(KERNEL_MODULES, mods)}


def sam_lines(out):
    from lamsa_tpu_torch.io.sam import format_sam_record
    return [format_sam_record(r) for rs in out for r in rs]


def check_sam(got, want, what):
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want))
                   if a != b) if len(got) == len(want) else -1
        fail(f"{what}: SAM differs (records {len(got)} vs {len(want)}, "
             f"first diff {bad})")


def phase_e2e(dev, card, world):
    import torch

    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.pipeline import extend
    from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

    _genome, ref, idx, cfg, reads = world
    log(f"phase 3: config-1 world ({ref.total_len} bp, k={idx.k}, "
        f"{len(reads)} reads)")
    t0 = time.perf_counter()
    aligner = Aligner(ref, idx, cfg, device=dev)
    aligner.align_batch(reads[:256])
    torch.cuda.synchronize()
    log(f"warm batch (256 reads, incl. device state): "
        f"{time.perf_counter() - t0:.2f} s")

    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = list(align_reads(ref, idx, reads, cfg, batch_size=256,
                           aligner=aligner))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rps = len(reads) / wall
    chain_s = STATS.wall.get("chain_hits", 0.0)
    log(f"end to end: {len(reads)} reads in {wall:.3f} s = {rps:.2f} reads/s"
        f" (align_reads, batch 256, one batch in flight) on {card}")
    log(f"chain_hits loop: {chain_s:.3f} s = {chain_s / wall:.3f} of the "
        f"wall")
    log("stage breakdown (host seconds; seed_chain_device includes "
        "chain_hits):\n" + STATS.report())
    log(f"kernel launches in the end-to-end run: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    e2e_ms, wrap, order = kernel_device_ms(lambda: list(align_reads(
        ref, idx, reads, cfg, batch_size=256, aligner=aligner)))
    log(f"device ms per kernel in one more (profiled) config-1 pass: "
        f"{e2e_ms}")
    for n in DP_WRAPPERS:
        total = sum(ms for ms, _ in wrap[n].values())
        inside = sum(ms for name, (ms, _) in wrap[n].items()
                     if KERNEL_NAMES[n] in name)
        if abs(inside - e2e_ms[n]) > 1e-6:
            fail(f"{n}: the kernel ran outside its wrapper's markers "
                 f"({inside} of {e2e_ms[n]} ms inside)")
        others = sorted(((ms, c, name[:60]) for name, (ms, c)
                         in wrap[n].items() if KERNEL_NAMES[n] not in name),
                        reverse=True)
        log(f"{n} wrapper calls in that pass: {total:.4f} device ms, of "
            f"which the kernel {inside:.4f} and the rest "
            f"{total - inside:.4f} (ms x calls, name: "
            + "; ".join(f"{ms:.4f} x{c} {name}" for ms, c, name in others)
            + ")")
    enc = sorted(((ms, c, name[:60]) for name, (ms, c)
                  in wrap["compact_encode"].items()), reverse=True)
    enc_ms = sum(ms for ms, _, _ in enc)
    log(f"wire.compact_encode (torch; after every row walk) in that pass: "
        f"{enc_ms:.4f} device ms over {order.count('compact_encode')} "
        f"calls, beside the row walker's {e2e_ms['traceback_row']:.4f} "
        f"(largest, ms x launches: "
        + "; ".join(f"{ms:.4f} x{c} {name}" for ms, c, name in enc[:4])
        + ")")

    st = evaluate(out, reads)
    log(f"accuracy: part_recall={st.part_recall:.4f} "
        f"read_accuracy={st.read_accuracy:.4f} ({st.summary()})")
    if st.part_recall < 0.99:
        fail(f"part_recall {st.part_recall:.4f} < 0.99")

    t0 = time.perf_counter()
    cpu_out = Aligner(ref, idx, cfg, device="cpu").align_batch(
        reads[:N_SAM_CHECK])
    sam_gpu = sam_lines(out[:N_SAM_CHECK])
    check_sam(sam_gpu, sam_lines(cpu_out),
              f"cuda vs cpu on the first {N_SAM_CHECK} reads")
    log(f"SAM of the first {N_SAM_CHECK} reads ({len(sam_gpu)} records) is "
        f"byte-identical between cuda and the cpu plain path "
        f"({time.perf_counter() - t0:.1f} s on the cpu)")

    # engine equality on the card: globals on the row pair, then on the
    # antidiagonal pair
    sams, adiag = {}, {}
    for enabled in (False, True):
        extend.ADIAG_ENABLED = enabled
        try:
            launch_counts(reset=True)
            sams[enabled] = sam_lines(
                aligner.align_batch(reads[:N_ENGINE_CHECK]))
            torch.cuda.synchronize()
            adiag[enabled] = launch_counts()["banded_sw_adiag"]
        finally:
            extend.ADIAG_ENABLED = True
    if adiag[False] != 0 or adiag[True] <= 0:
        fail(f"ADIAG_ENABLED did not switch the engine (adiag DP launches "
             f"{adiag})")
    check_sam(sams[True], sams[False],
              f"ADIAG_ENABLED True vs False on the first {N_ENGINE_CHECK} "
              f"reads")
    log(f"SAM of the first {N_ENGINE_CHECK} reads ({len(sams[True])} "
        f"records) is byte-identical on the card with globals on the row "
        f"pair and on the antidiagonal pair ({adiag[True]} adiag DP "
        f"launches)")
    e2e_ms["compact_encode"] = enc_ms
    return launches, rps, e2e_ms, out


def phase_10kb(dev, card, world):
    """Phase 4: bench.py's 10 kb world (its 10 kb section, copied here)
    on the card."""
    import torch

    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
    from lamsa_tpu_torch.worlds import reads_10kb

    genome, ref, idx, cfg, _reads = world
    reads10 = reads_10kb(genome)
    t0 = time.perf_counter()
    a10 = Aligner(ref, idx, cfg, device=dev)
    a10.align_batch(reads10[:N_WARM_10KB])
    torch.cuda.synchronize()
    log(f"phase 4: 10 kb world, warm batch ({N_WARM_10KB} reads) "
        f"{time.perf_counter() - t0:.2f} s")
    timed = reads10[N_WARM_10KB:]
    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = list(align_reads(ref, idx, timed, cfg, batch_size=256,
                           aligner=a10))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rps = len(timed) / wall
    log(f"10 kb: {len(timed)} reads in {wall:.3f} s = {rps:.2f} reads/s "
        f"(align_reads, batch 256) on {card}")
    chain_s = STATS.wall.get("chain_hits", 0.0)
    log(f"chain_hits loop: {chain_s:.3f} s = {chain_s / wall:.3f} of the "
        f"wall; dp_batch {STATS.wall.get('dp_batch', 0.0):.3f} s")
    log_dp_buckets()
    log(f"kernel launches in the 10 kb run: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel was never launched in the 10 kb run: {launches}")
    st = evaluate(out, timed)
    log(f"10 kb accuracy: part_recall={st.part_recall:.4f} "
        f"read_accuracy={st.read_accuracy:.4f} ({st.summary()})")
    if st.part_recall < 0.99:
        fail(f"10 kb part_recall {st.part_recall:.4f} < 0.99")
    t0 = time.perf_counter()
    cpu_out = Aligner(ref, idx, cfg, device="cpu").align_batch(
        timed[:N_SAM_CHECK_10KB])
    sam_gpu = sam_lines(out[:N_SAM_CHECK_10KB])
    check_sam(sam_gpu, sam_lines(cpu_out),
              f"10 kb cuda vs cpu on the first {N_SAM_CHECK_10KB} reads")
    log(f"10 kb SAM of the first {N_SAM_CHECK_10KB} timed reads "
        f"({len(sam_gpu)} records) is byte-identical between cuda and the "
        f"cpu plain path ({time.perf_counter() - t0:.1f} s on the cpu)")
    return out


def dp_buckets(counters):
    """{"MxW": (instances, cells)} per DP bucket from STATS counters."""
    return {k[13:]: (v, counters.get("dp_cells_" + k[13:], 0))
            for k, v in sorted(counters.items())
            if k.startswith("dp_instances_")
            and not k.startswith("dp_instances_entry")}


def log_dp_buckets():
    """DP instances and cells per bucket of the last STATS window; returns
    them (dp_buckets)."""
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
    per_bucket = dp_buckets(STATS.counters)
    log("DP instances / cells per bucket: " + ", ".join(
        f"{b}: {i} / {c}" for b, (i, c) in per_bucket.items())
        + f"; adiag instances {STATS.counters.get('dp_adiag_instances', 0)}")
    return per_bucket


def wholegenome_ref(n_chrom):
    """The first n_chrom chromosomes of tools/wholegenome_bench.py's
    config-4 genome: the same SEED and draws, so chr1 and chr2 are that
    genome's chr1 and chr2 (random bases, N_RUNS // N_CHROM runs of N of
    100-2000 bp per chromosome; constants from lamsa_tpu_torch.worlds)."""
    from lamsa_tpu_torch import worlds as wg
    from lamsa_tpu_torch.io.refpack import PackedReference, _find_runs

    rng = np.random.default_rng(wg.WG_SEED)
    per = wg.WG_GENOME_LEN // wg.WG_N_CHROM
    parts = []
    for _ in range(n_chrom):
        codes = rng.integers(0, 4, per, dtype=np.uint8)
        for _ in range(wg.WG_N_RUNS // wg.WG_N_CHROM):
            p = int(rng.integers(0, per - 2000))
            codes[p:p + int(rng.integers(100, 2000))] = 4
        parts.append(codes)
    codes = np.concatenate(parts)
    return PackedReference(names=[f"chr{c + 1}" for c in range(n_chrom)],
                           offsets=np.arange(n_chrom + 1, dtype=np.int64)
                           * per, codes=codes,
                           amb_runs=_find_runs(codes >= 4))


def sample_window_reads(ref, n_reads, rng, *, read_len, sub, ins, dele,
                        sv_fraction, prefix):
    """tools/wholegenome_bench.py sample_reads with the read class as
    arguments: one read simulated from each sampled 40 kb window (<= 1%
    N, inside one chromosome), truth rebased to chromosome coordinates."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.io.fasta import BASES, FastxRecord

    reads = []
    lut = np.frombuffer("".join(BASES).encode(), np.uint8)
    offs = np.asarray(ref.offsets)
    WIN = 40_000
    while len(reads) < n_reads:
        w0 = int(rng.integers(0, int(ref.total_len) - WIN))
        ci = int(np.searchsorted(offs, w0, side="right")) - 1
        if w0 + WIN > offs[ci + 1]:
            continue
        win = ref.codes[w0:w0 + WIN]
        if (win >= 4).mean() > 0.01:
            continue
        (r,) = sim.simulate_reads(
            rng, [FastxRecord(name="win",
                              seq=lut[np.minimum(win, 4)].tobytes().decode())],
            1, read_len=read_len, sub=sub, ins=ins, dele=dele,
            sv_fraction=sv_fraction, name_prefix=f"{prefix}{len(reads)}")
        pref, enc = r.name.split("|", 1)
        parts = []
        for ps in enc.split(";"):
            p = sim.TruthPart.decode(ps)
            p.ref_name = ref.names[ci]
            p.ref_start += w0 - int(offs[ci])
            p.ref_end += w0 - int(offs[ci])
            parts.append(p.encode())
        reads.append(FastxRecord(name=pref + "|" + ";".join(parts),
                                 seq=r.seq, qual=r.qual))
    return reads


def phase_fm(dev, card):
    """Phase 5: the whole-genome FM world on the card (see the module
    docstring)."""
    import torch

    from lamsa_tpu_torch import worlds as wg
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams, preset
    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.index.fmindex import FmIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
    from lamsa_tpu_torch.pipeline.seeding import make_qpos_grid, \
        seed_hits_fm
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

    t0 = time.perf_counter()
    ref = wholegenome_ref(FM_N_CHROM)
    log(f"phase 5: whole-genome FM world, {ref.num_seqs} chromosomes of "
        f"config-4, {ref.total_len} bp, {len(ref.amb_runs)} N runs "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    fmi = FmIndex.build(ref.codes)
    log(f"FM index built on the host in {time.perf_counter() - t0:.1f} s "
        f"(sa_rate {fmi.sa_rate}, {len(fmi.ssa_pos)} sampled SA entries)")
    cfg = AlignConfig(scores=ScoreParams(), seed_step=10)   # the tool's
    reads = wg.sample_reads(ref, N_FM_WARM + N_FM_TIMED,
                            np.random.default_rng(wg.WG_SEED + 1))

    t0 = time.perf_counter()
    aligner = Aligner(ref, fmi, cfg, device=dev)
    st = aligner._state
    fm_bytes = sum(t.nbytes for n, t in st.items() if n != "ref_words")
    log(f"device state in {time.perf_counter() - t0:.2f} s: FM tensors "
        f"{fm_bytes} B + ref_words {st['ref_words'].nbytes} B = "
        f"{fm_bytes + st['ref_words'].nbytes} B on {card}; k={aligner.k}, "
        f"sub1_k={aligner._sub1_k()}")
    t0 = time.perf_counter()
    aligner.align_batch(reads[:N_FM_WARM])
    torch.cuda.synchronize()
    log(f"warm batch ({N_FM_WARM} reads) {time.perf_counter() - t0:.2f} s")

    timed = reads[N_FM_WARM:]
    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = list(align_reads(ref, fmi, timed, cfg, batch_size=FM_BATCH,
                           aligner=aligner))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rps = len(timed) / wall
    log(f"FM 10 kb: {len(timed)} reads in {wall:.3f} s = {rps:.2f} reads/s "
        f"(align_reads, batch {FM_BATCH}) on {card}")
    seed_s = STATS.wall.get("seed_hits", 0.0)
    chain_s = STATS.wall.get("chain_hits", 0.0)
    log(f"FM seeding (seed_hits, device-synchronized) {seed_s:.3f} s = "
        f"{seed_s / wall:.3f} of the wall; chain_hits {chain_s:.3f} s = "
        f"{chain_s / wall:.3f}; dp_batch "
        f"{STATS.wall.get('dp_batch', 0.0):.3f} s")
    log("stage breakdown (host seconds; seed_chain_device includes "
        "seed_hits and chain_hits):\n" + STATS.report())
    log_dp_buckets()
    log(f"kernel launches in the FM run: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel was never launched in the FM run: {launches}")
    ev = evaluate(out, timed)
    log(f"FM accuracy: part_recall={ev.part_recall:.4f} "
        f"read_accuracy={ev.read_accuracy:.4f} ({ev.summary()})")
    if ev.part_recall < 0.99:
        fail(f"FM part_recall {ev.part_recall:.4f} < 0.99")
    t0 = time.perf_counter()
    cpu = Aligner(ref, fmi, cfg, device="cpu")
    sam_gpu = sam_lines(out[:N_SAM_CHECK_10KB])
    check_sam(sam_gpu, sam_lines(cpu.align_batch(timed[:N_SAM_CHECK_10KB])),
              f"FM cuda vs cpu on the first {N_SAM_CHECK_10KB} timed reads")
    log(f"FM SAM of the first {N_SAM_CHECK_10KB} timed reads "
        f"({len(sam_gpu)} records) is byte-identical between cuda and the "
        f"cpu path ({time.perf_counter() - t0:.1f} s on the cpu)")

    # 28% error: past the exact-piece envelope, the adaptive re-seed with
    # the 1-edit variant tracks must run on the card
    hreads = sample_window_reads(
        ref, N_HIGH_ERR, np.random.default_rng(wg.WG_SEED + 2),
        read_len=(1000, 3000), sub=0.15, ins=0.07, dele=0.06,
        sv_fraction=0.2, prefix="e28_")
    ont = preset("ont")
    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out_h = Aligner(ref, fmi, ont, device=dev).align_batch(hreads)
    torch.cuda.synchronize()
    h_wall = time.perf_counter() - t0
    h_launch = launch_counts()
    dens = STATS.counters.get("seed_densified_reads", 0)
    ev = evaluate(out_h, hreads)
    log(f"28% error (ont preset): {N_HIGH_ERR} reads in {h_wall:.3f} s "
        f"(incl. device state), seed_densified_reads={dens}, launches "
        f"{h_launch}, part_recall={ev.part_recall:.4f} "
        f"read_accuracy={ev.read_accuracy:.4f} (printed, not gated)")
    if dens <= 0:
        fail("the adaptive re-seed (1-edit tracks) never fired at 28% error")
    t0 = time.perf_counter()
    sam_h = sam_lines(out_h)
    check_sam(sam_h, sam_lines(Aligner(ref, fmi, ont, device="cpu")
                               .align_batch(hreads)),
              f"FM 28% error cuda vs cpu on all {N_HIGH_ERR} reads")
    log(f"28% error SAM of all {N_HIGH_ERR} reads ({len(sam_h)} records) is "
        f"byte-identical between cuda and the cpu path "
        f"({time.perf_counter() - t0:.1f} s on the cpu)")

    # one retry sub-batch of seed_hits_fm at this scale, with the >1 Gb
    # seg quota (which this genome does not reach) and the 1-edit tracks
    L = aligner._bucket_len(max(len(r.seq) for r in timed[:FM_BATCH]))
    step_d = max(2, cfg.seed_step // 2)
    grid = make_qpos_grid(L, aligner.k, step_d).astype(np.int64)
    k1 = aligner._sub1_k()
    B = aligner._retry_cap(len(grid))
    rc = np.full((B, L), 4, np.int64)
    lens = np.zeros(B, np.int64)
    for b, r in enumerate(timed[:B]):
        c = np.frombuffer(encode_seq(r.seq), np.uint8)[:L]
        rc[b, :len(c)] = c
        lens[b] = len(c)
    kw = dict(k=aligner.k, cands_per_seed=cfg.max_cands_per_seed,
              max_hits=cfg.max_hits_per_read, sa_rate=fmi.sa_rate,
              seg_quota=cfg.max_hits_per_read // 32,
              sub1_cands=cfg.seed_1edit_cands, sub1_k=k1,
              sub1_kinds=cfg.seed_1edit_kinds)
    args_d = [torch.from_numpy(a).to(dev) for a in (rc, lens, grid)]
    seed_hits_fm(*args_d, st, **kw)                       # warm
    got, ms = cuda_ms_once(lambda: seed_hits_fm(*args_d, st, **kw))
    t0 = time.perf_counter()
    want = seed_hits_fm(*(torch.from_numpy(a) for a in (rc, lens, grid)),
                        cpu._state, **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for n in ("qpos", "rpos", "strand", "valid"):
        if not torch.equal(got[n].cpu(), want[n]):
            fail(f"seed_hits_fm on cuda != cpu ({n}) with seg_quota "
                 f"{kw['seg_quota']} and sub1_k {k1}")
    log(f"seed_hits_fm, {B} reads of the {L} bucket on the step-{step_d} "
        f"retry grid, seg_quota {kw['seg_quota']}, sub1_k {k1}: cuda = cpu "
        f"on all four outputs ({int(want['valid'].sum())} valid hits); "
        f"{ms:.2f} ms on the card, {cpu_ms:.1f} ms on the host cpu")
    return dict(ref=ref, fmi=fmi, cfg=cfg, timed=timed, out=out, rps=rps,
                hreads=hreads, ont=ont, out_h=out_h)


def phase_coords(dev, scores):
    """Phase 5b: reference coordinates past 2^31 through the window
    gather and both DP pairs on the card (see the module docstring)."""
    import torch

    from lamsa_tpu_torch import worlds as wg
    from lamsa_tpu_torch.ops.dp_chain import dp_tb_adiag_gather, \
        dp_tb_gather
    from lamsa_tpu_torch.ops.testing import SIGN_LINE, make_high_chunk
    from lamsa_tpu_torch.ops.wire import gather_windows, unpack_desc

    t0 = time.perf_counter()
    M, W, K = COORD_BUCKET + (COORD_K,)
    flat, patches, desc, low_ref, low_desc = make_high_chunk(
        np.random.default_rng(20260821), wg.WG_GENOME_LEN, M, W, K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20260821)
    # random codes 0-3 in every nibble, then the instances' targets
    words = torch.randint(0, 1 << 30, ((wg.WG_GENOME_LEN + 7) // 8,),
                          dtype=torch.int32, device=dev, generator=gen)
    words.bitwise_and_(0x33333333)
    for w0, p in patches:
        words[w0:w0 + len(p)] = torch.from_numpy(p).to(dev)
    torch.cuda.synchronize()
    words_cpu = words.cpu()
    tb = desc[:, 1].view(np.uint32)
    log(f"phase 5b: coordinates past 2^31 on the card: reference words of "
        f"{wg.WG_GENOME_LEN} random codes ({words.nbytes} B on {dev}, made "
        f"and copied to the host in {time.perf_counter() - t0:.1f} s); "
        f"{K} global gap fills and {K} extensions at ({M}, {W}), t_base "
        f"{int(tb.min())}..{int(tb.max())}")
    if tb.min() < SIGN_LINE:
        fail("phase 5b: a descriptor's t_base lies below 2^31")
    sides = {"cuda": (torch.from_numpy(flat).to(dev), words,
                      torch.from_numpy(desc).to(dev)),
             "cpu": (torch.from_numpy(flat), words_cpu,
                     torch.from_numpy(desc)),
             "low": (torch.from_numpy(flat), torch.from_numpy(low_ref),
                     torch.from_numpy(low_desc))}
    got_tb = unpack_desc(sides["cuda"][2])[3].cpu().numpy()
    if not np.array_equal(got_tb, tb.astype(np.int64)):
        fail("phase 5b: unpack_desc on the card changed a t_base past 2^31")
    wins = {}
    for side, (fl, ref_w, d) in sides.items():
        wins[side] = [x.cpu() for x in gather_windows(
            fl, ref_w, *unpack_desc(d)[:8], M=M, W=W)]
    for side in ("cpu", "low"):
        for what, g, w_ in zip(("q", "t_win"), wins["cuda"], wins[side]):
            if not torch.equal(g, w_):
                fail(f"phase 5b: the {what} windows gathered on the card "
                     f"differ from the {side} ones")
    times, out = {}, {}
    for side, (fl, ref_w, d) in sides.items():
        for pair in ("row", "adiag"):
            t1 = time.perf_counter()
            if pair == "row":
                wire = dp_tb_gather(fl, ref_w, d, M=M, W=W, scores=scores,
                                    zdrop=scores.zdrop)
            else:
                wire = dp_tb_adiag_gather(fl, ref_w, d[:K].contiguous(),
                                          M=M, W=W, scores=scores)
            out[side, pair] = wire.cpu()
            times[side, pair] = time.perf_counter() - t1
    for pair in ("row", "adiag"):
        for side in ("cpu", "low"):
            if not torch.equal(out["cuda", pair], out[side, pair]):
                bad = int((out["cuda", pair] != out[side, pair]).any(dim=1)
                          .nonzero()[0])
                fail(f"phase 5b: the {pair} pair's wire on the card differs "
                     f"from the {side} plain path's, first at instance {bad}")
    log(f"phase 5b ok in {time.perf_counter() - t0:.1f} s: q / t_win windows "
        f"and the compact wires of the row pair ({2 * K} instances) and of "
        f"the antidiagonal pair ({K} globals) on the card equal the plain "
        f"versions on the host copy and on the same targets at low "
        f"coordinates (plain path {times['cpu', 'row']:.1f} s + "
        f"{times['cpu', 'adiag']:.1f} s)")


class _Tee:
    """A text stream that writes through to another and keeps each line
    with the time it arrived."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.out.write(s)
        self.lines += [(time.perf_counter(), ln)
                       for ln in s.splitlines() if ln.strip()]
        return len(s)

    def flush(self):
        self.out.flush()


def past_sign_line(ref, read):
    """True when every truth part of a simulated read starts at or past
    2^31 in the concatenated reference."""
    from lamsa_tpu_torch import sim
    offs = dict(zip(ref.names, np.asarray(ref.offsets).tolist()))
    return all(offs[p.ref_name] + p.ref_start >= 1 << 31
               for p in sim.parse_truth(read.name))


def phase_wholegenome(dev, card, n_chrom=WG_N_CHROM_RUN):
    """--wholegenome: config 4 end to end on the card (see the module
    docstring). Every check runs and is reported before the mode fails
    on any of them. Returns the numbers of its JSON line."""
    import contextlib
    import resource

    import torch

    from lamsa_tpu_torch import worlds as wg
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams, preset
    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.index.fmindex import FmIndex
    from lamsa_tpu_torch.io.samcheck import validate_batch
    from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            log(f"CHECK FAILED: {msg}")

    def rss():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    nums = {"card": card, "n_chrom": n_chrom}
    t0 = time.perf_counter()
    ref = wholegenome_ref(n_chrom)
    nums["genome_bp"] = int(ref.total_len)
    nums["genome_s"] = time.perf_counter() - t0
    log(f"whole genome: {ref.num_seqs} chromosomes of config 4, "
        f"{ref.total_len} bp, {len(ref.amb_runs)} N runs, generated in "
        f"{nums['genome_s']:.1f} s on {card}")
    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        fmi = FmIndex.build(ref.codes)
    nums["fm_build_s"] = time.perf_counter() - t0
    marks = [(t, ln.split("] ", 1)[1].rsplit(" (", 1)[0])
             for t, ln in tee.lines if ln.startswith("[fmindex build]")]
    nums["fm_build_phase_s"] = {
        name: t - prev for (t, name), prev
        in zip(marks, [t0] + [t for t, _ in marks[:-1]])}
    nums["rss_after_build_B"] = rss()
    log(f"FM index built on the host in {nums['fm_build_s']:.1f} s "
        f"(sa_rate {fmi.sa_rate}; phases {nums['fm_build_phase_s']}); peak "
        f"host RSS so far {nums['rss_after_build_B']} B on {card}")

    cfg = AlignConfig(scores=ScoreParams(), seed_step=10)   # the tool's
    reads = wg.sample_reads(ref, N_FM_WARM + N_FM_TIMED,
                            np.random.default_rng(wg.WG_SEED + 1))
    timed = reads[N_FM_WARM:]
    past = [i for i, r in enumerate(timed) if past_sign_line(ref, r)]
    nums["timed_reads_past_2^31"] = len(past)
    log(f"{len(past)} of {len(timed)} timed reads lie past 2^31")
    check(len(past) > 0, "no timed read lies past 2^31")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    aligner = Aligner(ref, fmi, cfg, device=dev)
    st = aligner._state
    fm_bytes = sum(t.nbytes for n, t in st.items() if n != "ref_words")
    nums["device_state_s"] = time.perf_counter() - t0
    nums["resident_B"] = {"fm": fm_bytes, "ref_words": st["ref_words"].nbytes}
    log(f"device state in {nums['device_state_s']:.2f} s: FM tensors "
        f"{fm_bytes} B + ref_words {st['ref_words'].nbytes} B on {card}; "
        f"k={aligner.k}, sub1_k={aligner._sub1_k()}, seg quota "
        f"{'on' if aligner._quota_on() else 'off'}")
    check(aligner.k == 16, f"k = {aligner.k}, not 16")
    check(aligner._quota_on(), "the seg quota is off")
    t0 = time.perf_counter()
    warm = aligner.align_batch(reads[:N_FM_WARM])
    torch.cuda.synchronize()
    nums["warm_batch_s"] = time.perf_counter() - t0

    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = list(align_reads(ref, fmi, timed, cfg, batch_size=FM_BATCH,
                           aligner=aligner))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    nums["launches"] = launches
    nums["timed_reads_per_s"] = len(timed) / wall
    nums["stage_s"] = {s: STATS.wall.get(s, 0.0) for s in (
        "seed_hits", "chain_hits", "dp_batch", "skeleton_host",
        "finalize_host")}
    nums["stage_share"] = {s: v / wall for s, v in nums["stage_s"].items()}
    nums["timed_densified_reads"] = STATS.counters.get(
        "seed_densified_reads", 0)
    nums["dp_buckets"] = {k[len("dp_instances_"):]: v
                          for k, v in sorted(STATS.counters.items())
                          if k.startswith("dp_instances_")
                          and not k.startswith("dp_instances_entry")}
    log(f"timed: {len(timed)} reads in {wall:.3f} s = "
        f"{nums['timed_reads_per_s']:.2f} reads/s (align_reads, batch "
        f"{FM_BATCH}) on {card}; warm batch {nums['warm_batch_s']:.2f} s; "
        f"stage shares {nums['stage_share']}; densified reads "
        f"{nums['timed_densified_reads']}; launches {launches}")
    log("stage breakdown (host seconds):\n" + STATS.report())
    log_dp_buckets()
    check(min(launches.values()) > 0,
          f"a kernel was never launched in the timed run: {launches}")
    ev = evaluate(out, timed)
    ev_past = evaluate([out[i] for i in past], [timed[i] for i in past])
    nums["part_recall"] = ev.part_recall
    nums["read_accuracy"] = ev.read_accuracy
    nums["part_recall_past_2^31"] = ev_past.part_recall
    nums["read_accuracy_past_2^31"] = ev_past.read_accuracy
    log(f"accuracy: part_recall={ev.part_recall:.4f} "
        f"read_accuracy={ev.read_accuracy:.4f} ({ev.summary()}); past "
        f"2^31: part_recall={ev_past.part_recall:.4f} "
        f"read_accuracy={ev_past.read_accuracy:.4f} ({ev_past.summary()})")
    check(ev.part_recall >= 0.99, f"part_recall {ev.part_recall:.4f} < 0.99")
    check(ev_past.part_recall >= 0.99,
          f"part_recall past 2^31 {ev_past.part_recall:.4f} < 0.99")

    hreads = sample_window_reads(
        ref, N_HIGH_ERR, np.random.default_rng(wg.WG_SEED + 2),
        read_len=(1000, 3000), sub=0.15, ins=0.07, dele=0.06,
        sv_fraction=0.2, prefix="e28_")
    ont = preset("ont")
    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out_h = Aligner(ref, fmi, ont, device=dev).align_batch(hreads)
    torch.cuda.synchronize()
    nums["high_error_s"] = time.perf_counter() - t0
    nums["high_error_densified_reads"] = STATS.counters.get(
        "seed_densified_reads", 0)
    ev_h = evaluate(out_h, hreads)
    nums["high_error_part_recall"] = ev_h.part_recall
    log(f"28% error (ont preset): {N_HIGH_ERR} reads in "
        f"{nums['high_error_s']:.3f} s (incl. device state), "
        f"seed_densified_reads={nums['high_error_densified_reads']}, "
        f"launches {launch_counts()}, part_recall={ev_h.part_recall:.4f} "
        f"read_accuracy={ev_h.read_accuracy:.4f} (printed, not gated)")
    check(nums["high_error_densified_reads"] > 0,
          "the adaptive re-seed never fired at 28% error")
    nums["max_memory_allocated_B"] = torch.cuda.max_memory_allocated(dev)

    t0 = time.perf_counter()
    n_bad = 0
    for what, o, rs in (("warm", warm, reads[:N_FM_WARM]),
                        ("timed", out, timed), ("28% error", out_h, hreads)):
        errs = validate_batch(o, ref)
        n_bad += len(errs)
        check(not errs, f"samcheck on the {what} reads: {len(errs)} "
              f"findings, first: {errs[:1]}")
    nums["validated_reads"] = N_FM_WARM + len(timed) + len(hreads)
    log(f"validate_batch on all {nums['validated_reads']} reads the card "
        f"aligned: {n_bad} findings ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    cpu = Aligner(ref, fmi, cfg, device="cpu")
    first = list(range(N_SAM_CHECK_10KB))
    high = [i for i in past if i >= N_SAM_CHECK_10KB][:N_SAM_CHECK_10KB]
    for what, sel in (("the first timed reads", first),
                      ("timed reads past 2^31", high)):
        got = sam_lines([out[i] for i in sel])
        want = sam_lines(cpu.align_batch([timed[i] for i in sel]))
        check(got == want, f"SAM of {len(sel)} {what}: cuda != cpu")
        log(f"SAM of {len(sel)} {what} ({len(got)} records): cuda "
            f"{'=' if got == want else '!='} cpu")
    got = sam_lines(out_h)
    want = sam_lines(Aligner(ref, fmi, ont, device="cpu").align_batch(hreads))
    check(got == want, f"SAM of all {N_HIGH_ERR} reads at 28% error: cuda "
          f"!= cpu")
    log(f"SAM of all {N_HIGH_ERR} reads at 28% error ({len(got)} records): "
        f"cuda {'=' if got == want else '!='} cpu; the cpu path took "
        f"{time.perf_counter() - t0:.1f} s")
    nums["sam_checked_reads"] = len(first) + len(high) + N_HIGH_ERR
    nums["peak_rss_B"] = rss()
    if failures:
        log("whole-genome numbers: " + json.dumps(nums))
        fail(f"--wholegenome: {len(failures)} checks failed: {failures}")
    return nums


def sync(aligner):
    """Wait for every card an Aligner's entries run on."""
    import torch

    from lamsa_tpu_torch.parallel.mesh import distinct
    for d in distinct(aligner.entries):
        torch.cuda.synchronize(d)


def mesh_run(aligner, reads, batch):
    """align_reads over a prepared (mesh) Aligner with the launch counts
    and the per-entry DP instance counters set to 0 just before and read
    just after. Returns (out, wall s, launches, instances per entry)."""
    from lamsa_tpu_torch.pipeline.aln import align_reads
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

    STATS.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = list(align_reads(aligner.ref, aligner.index, reads,
                           aligner.config, batch_size=batch,
                           aligner=aligner))
    sync(aligner)
    wall = time.perf_counter() - t0
    per_entry = {k[len("dp_instances_"):]: v
                 for k, v in sorted(STATS.counters.items())
                 if k.startswith("dp_instances_entry")}
    return out, wall, launch_counts(), per_entry


def phase_mesh(card, world, out3, rps3, fm):
    """Phase 6a: the config-1 world and the FM world's reads through an
    Aligner over two entries of one card, and with more than one card
    over ["cuda:0", "cuda:1"]; SAM must equal the one-entry runs of
    phases 3 and 5. Returns the config-1 run's launches over two entries
    of card 0, the outputs, and the two-card run's numbers (None on one
    card)."""
    import torch

    from lamsa_tpu_torch.parallel.mesh import make_mesh
    from lamsa_tpu_torch.pipeline.aln import Aligner

    _genome, ref, idx, cfg, reads = world
    n_cards = torch.cuda.device_count()
    log(f"phase 6a: data parallelism over mesh entries; "
        f"torch.cuda.device_count() = {n_cards}")
    meshes = [["cuda:0", "cuda:0"]]
    if n_cards > 1:
        meshes.append(["cuda:0", "cuda:1"])
    launches, outs, two_cards = None, [], None
    for entries in meshes:
        mesh = make_mesh(entries)
        t0 = time.perf_counter()
        aligner = Aligner(ref, idx, cfg, mesh=mesh)
        aligner.align_batch(reads[:256])
        sync(aligner)
        log(f"mesh {entries}: device state for {len(set(mesh))} distinct "
            f"device(s) + warm batch {time.perf_counter() - t0:.2f} s")
        out, wall, lc, per_entry = mesh_run(aligner, reads, 256)
        log(f"config-1 over {entries}: {len(reads)} reads in {wall:.3f} s = "
            f"{len(reads) / wall:.2f} reads/s against one entry's "
            f"{rps3:.2f} (phase 3) on {card} (not a speed-up: one host "
            f"thread drives every entry); DP instances per entry "
            f"{per_entry}; kernel launches {lc}")
        if len(set(mesh)) > 1:
            two_cards = {"launches": lc, "reads_per_s": len(reads) / wall,
                         "one_entry_reads_per_s": rps3,
                         "dp_instances_per_entry": per_entry}
        if min(lc.values()) <= 0:
            fail(f"a kernel was never launched over {entries}: {lc}")
        if len(per_entry) != len(mesh):
            fail(f"not every entry ran DP instances: {per_entry}")
        check_sam(sam_lines(out), sam_lines(out3),
                  f"config-1 over {entries} vs one entry (phase 3)")
        log(f"config-1 SAM over {entries} is byte-identical to phase 3's "
            f"one-entry SAM on all {len(reads)} reads")
        if launches is None:
            launches = lc
        outs.append(out)

    mesh = make_mesh(meshes[0])
    t0 = time.perf_counter()
    fa = Aligner(fm["ref"], fm["fmi"], fm["cfg"], mesh=mesh)
    out_f, wall, lc, per_entry = mesh_run(fa, fm["timed"], FM_BATCH)
    log(f"FM 10 kb over {meshes[0]}: {len(fm['timed'])} reads in {wall:.3f} "
        f"s (device state {time.perf_counter() - t0 - wall:.2f} s, index "
        f"reused from phase 5); DP instances per entry {per_entry}; "
        f"launches {lc}")
    if min(lc.values()) <= 0:
        fail(f"a kernel was never launched in the FM mesh run: {lc}")
    check_sam(sam_lines(out_f), sam_lines(fm["out"]),
              "FM over two entries vs one entry (phase 5)")
    out_h = Aligner(fm["ref"], fm["fmi"], fm["ont"],
                    mesh=mesh).align_batch(fm["hreads"])
    check_sam(sam_lines(out_h), sam_lines(fm["out_h"]),
              "FM 28% error over two entries vs one entry (phase 5)")
    log(f"FM SAM over {meshes[0]} is byte-identical to phase 5's on all "
        f"{len(fm['timed'])} timed reads and all {len(fm['hreads'])} "
        f"28%-error reads")
    return launches, outs + [out_f, out_h], two_cards


def phase_sharded(world):
    """Phase 6b: seed_hits_sharded over 2 and 4 entries of card 0 and,
    with more than one card, over ["cuda:0", "cuda:1"] and over every
    card, on the config-1 reads, against seed_hits exactly."""
    import torch

    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from lamsa_tpu_torch.parallel.sharded_index import (
        place_sharded, seed_hits_sharded, shard_kmer_index)
    from lamsa_tpu_torch.pipeline.seeding import make_qpos_grid, seed_hits
    from lamsa_tpu_torch.pipeline.state import device_state

    _genome, ref, idx, cfg, reads = world
    dev = torch.device("cuda", 0)
    L = -(-max(len(r.seq) for r in reads) // 512) * 512
    rc = np.full((len(reads), L), 4, np.int64)
    rl = np.zeros(len(reads), np.int64)
    for i, r in enumerate(reads):
        c = np.frombuffer(encode_seq(r.seq), np.uint8)
        rc[i, :len(c)] = c
        rl[i] = len(c)
    grid = make_qpos_grid(L, idx.k, cfg.seed_step).astype(np.int64)
    kw = dict(k=idx.k, cands_per_seed=cfg.max_cands_per_seed,
              max_hits=cfg.max_hits_per_read)
    st = device_state(ref, idx, dev)
    whole = sum(st[n].nbytes for n in ("keys", "starts", "counts",
                                       "positions"))
    t = [torch.from_numpy(a).to(dev) for a in (rc, rl, grid)]
    want = seed_hits(*t, st["keys"], st["starts"], st["counts"],
                     st["positions"], **kw)
    n_cards = torch.cuda.device_count()
    meshes = [["cuda:0"] * 2, ["cuda:0"] * 4]
    if n_cards > 1:
        meshes.append(["cuda:0", "cuda:1"])
    if n_cards > 2:
        meshes.append([f"cuda:{i}" for i in range(n_cards)])
    for entries in meshes:
        D = len(entries)
        mesh = make_mesh(entries)
        sh = place_sharded(mesh, shard_kmer_index(idx, D))
        rc_d, rl_d = shard_batch(mesh, rc, rl)
        parts = seed_hits_sharded(rc_d, rl_d, grid, sh["keys"], sh["starts"],
                                  sh["counts"], sh["positions"], mesh=mesh,
                                  **kw)
        for n in ("qpos", "rpos", "strand", "valid"):
            got = torch.cat([p[n].to(dev) for p in parts])
            if not torch.equal(got, want[n]):
                fail(f"seed_hits_sharded over {entries} != seed_hits ({n})")
        per = [sum(sh[n][d].nbytes for n in ("keys", "starts", "counts",
                                             "positions")) for d in range(D)]
        log(f"phase 6b: seed_hits_sharded over {entries} = seed_hits on "
            f"all {len(reads)} config-1 reads ({int(want['valid'].sum())} "
            f"valid hits); index bytes per shard {per} against {whole} "
            f"whole ({whole / max(per):.2f}x less)")


def phase_cli(card):
    """Phase 6c: the CLI with --device cuda on a small world in a
    temporary directory: two shards merged = one run, a simulated kill +
    --resume = an unbroken run, -d 0 (every card) = -d 1, byte for byte;
    with more than one card, --device cuda:1 -d 1 = -d 1 on card 0 byte
    for byte."""
    import tempfile

    import torch

    from lamsa_tpu_torch import cli, sim
    from lamsa_tpu_torch.io.fasta import write_fasta, write_fastq

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    genome = sim.random_genome(rng, 200_000)
    reads = sim.simulate_reads(rng, genome, N_CLI_READS,
                               read_len=(500, 3000), sv_fraction=0.25)
    with tempfile.TemporaryDirectory() as d:
        ref, fq = os.path.join(d, "g.fa"), os.path.join(d, "r.fq")
        write_fasta(ref, genome)
        write_fastq(fq, reads)

        def aln(*args, device="cuda"):
            if cli.main(["aln", "--device", device, "--batch-reads",
                         str(CLI_BATCH), *args, ref, fq]) != 0:
                fail(f"aln {args} on {device} exited non-zero")

        def records(path):
            return [ln for ln in open(path) if not ln.startswith("@")]

        if cli.main(["index", ref]) != 0:
            fail("cli index exited non-zero")
        full = os.path.join(d, "full.sam")
        aln("-o", full)
        shards = [os.path.join(d, f"s{i}.sam") for i in range(2)]
        for i, p in enumerate(shards):
            aln("-o", p, "--num-shards", "2", "--shard-id", str(i))
        merged = os.path.join(d, "merged.sam")
        if cli.main(["merge", "-o", merged, *shards]) != 0:
            fail("cli merge exited non-zero")
        if records(merged) != records(full):
            fail("CLI on cuda: two shards merged != one run")
        # a run killed mid-batch: the cursor at 2 batches, the records of
        # one more read and half a line of the next on disk
        lines = open(full).read().split("\n")
        head = [ln for ln in lines if ln.startswith("@")]
        body = [ln for ln in lines if ln and not ln.startswith("@")]
        starts = [i for i, ln in enumerate(body)
                  if int(ln.split("\t")[1]) & 0x900 == 0]
        k = 2 * CLI_BATCH
        part = os.path.join(d, "part.sam")
        with open(part, "w") as fh:
            fh.write("\n".join(head + body[:starts[k + 1]]) + "\n"
                     + body[starts[k + 1]][:30])
        with open(part + ".progress", "w") as fh:
            fh.write(str(k))
        aln("-o", part, "--resume")
        if open(part).read() != open(full).read():
            fail("CLI on cuda: kill + --resume != an unbroken run")
        d0, d1 = os.path.join(d, "d0.sam"), os.path.join(d, "d1.sam")
        aln("-o", d0, "-d", "0")
        aln("-o", d1, "-d", "1")
        if records(d0) != records(d1) or records(d1) != records(full):
            fail("CLI on cuda: -d 0 != -d 1")
        n_cards = torch.cuda.device_count()
        other = ""
        if n_cards > 1:
            c1 = os.path.join(d, "c1.sam")
            aln("-o", c1, "-d", "1", device="cuda:1")
            if open(c1).read() != open(d1).read():
                fail("CLI: --device cuda:1 -d 1 != --device cuda -d 1")
            other = ", --device cuda:1 -d 1 = -d 1 on card 0 byte for byte"
    log(f"phase 6c: CLI --device cuda on {N_CLI_READS} reads (batch "
        f"{CLI_BATCH}): two shards merged = one run, kill + --resume = an "
        f"unbroken run byte for byte, -d 0 (all {n_cards} card(s)) = -d 1"
        f"{other} ({time.perf_counter() - t0:.1f} s on {card})")


def phase_validate(checks):
    """Phase 6d: validate_batch (io/samcheck.py) on every read the card
    aligned in phases 3-6a; no finding may remain."""
    from lamsa_tpu_torch.io.samcheck import validate_batch

    t0 = time.perf_counter()
    n_reads = n_recs = 0
    for what, out, ref in checks:
        errs = validate_batch(out, ref)
        if errs:
            fail(f"samcheck on {what}: {len(errs)} findings, first: "
                 f"{errs[0]}")
        n_reads += len(out)
        n_recs += sum(len(r) for r in out)
    log(f"phase 6d: validate_batch found nothing on all {n_reads} reads "
        f"({n_recs} records) the card aligned in phases 3-6a "
        f"({time.perf_counter() - t0:.1f} s)")


def cli_processes(jobs, timeout=600, module="lamsa_tpu_torch.cli"):
    """Start one `python -m <module>` process per argument list of jobs,
    all at once, from the repository root, and wait for all of them; a
    process still running at the timeout is killed, as is every process
    left running when this returns. Returns (wall seconds from the first
    start to the last exit, [(exit code, stderr)])."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    procs, res = [], []
    t0 = time.perf_counter()
    try:
        for args in jobs:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args],
                cwd=here, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        for p in procs:
            try:
                err = p.communicate(timeout=timeout)[1]
            except subprocess.TimeoutExpired:
                p.kill()
                err = p.communicate()[1] + f"\n(killed after {timeout} s)"
            res.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0, res


def cli_reads_per_s(err):
    """The reads/s of a `cli aln` process's closing "done:" line."""
    import re
    m = re.search(r"done: .*\(([0-9.]+) reads/s\)", err)
    return float(m.group(1)) if m else None


def without_pg_cl(path):
    """A SAM file's text with the CL field of its @PG line taken out
    (each process writes its own command line there)."""
    import re
    return re.sub(r"^(@PG\t.*?)\tCL:[^\t\n]*", r"\1",
                  open(path).read(), flags=re.M)


def phase_cards(card, world, out3, rps3, fm):
    """Phase 6e: several cards (only with more than one card; see the
    module docstring). Every check runs before the phase fails. Returns
    its numbers, or None on one card."""
    import torch

    from lamsa_tpu_torch.pipeline.aln import Aligner

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log("phase 6e: skipped, 1 card")
        return None
    t6e = time.perf_counter()
    genome, ref, idx, cfg, reads = world
    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            log(f"phase 6e: CHECK FAILED: {msg}")

    # card 1 alone: config-1 and the FM world's timed reads
    cuda1 = torch.device("cuda", 1)
    for i in range(2):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    base0 = torch.cuda.memory_allocated(0)
    a1 = Aligner(ref, idx, cfg, device=cuda1)
    a1.align_batch(reads[:256])
    sync(a1)
    out, wall, lc1, _ = mesh_run(a1, reads, 256)
    peak1 = torch.cuda.max_memory_allocated(1)
    peak0 = torch.cuda.max_memory_allocated(0)
    rps1 = len(reads) / wall
    log(f"phase 6e: config-1 on cuda:1 alone: {len(reads)} reads in "
        f"{wall:.3f} s = {rps1:.2f} reads/s against {rps3:.2f} on cuda:0 "
        f"(phase 3) on {card}; launches {lc1}; max_memory_allocated "
        f"cuda:1 {peak1} B, cuda:0 {peak0} B against {base0} B before")
    check(min(lc1.values()) > 0, f"a kernel was never launched on cuda:1: "
          f"{lc1}")
    check(sam_lines(out) == sam_lines(out3),
          "config-1 SAM on cuda:1 != phase 3's on cuda:0")
    check(peak1 > 0, "nothing was allocated on cuda:1")
    check(peak0 == base0, f"the cuda:1 run raised card 0's allocation "
          f"({base0} -> {peak0} B)")
    del a1
    fa = Aligner(fm["ref"], fm["fmi"], fm["cfg"], device=cuda1)
    fa.align_batch(fm["timed"][:FM_BATCH])
    out_f, wall_f, lc_f, _ = mesh_run(fa, fm["timed"], FM_BATCH)
    rps_f = len(fm["timed"]) / wall_f
    log(f"phase 6e: FM 10 kb on cuda:1 alone: {len(fm['timed'])} reads in "
        f"{wall_f:.3f} s = {rps_f:.2f} reads/s against {fm['rps']:.2f} on "
        f"cuda:0 (phase 5); launches {lc_f}")
    check(min(lc_f.values()) > 0, f"a kernel was never launched in the FM "
          f"run on cuda:1: {lc_f}")
    check(sam_lines(out_f) == sam_lines(fm["out"]),
          "FM SAM on cuda:1 != phase 5's on cuda:0")
    del fa

    shards = shard_processes(
        genome, idx.k, reads, [f"cuda:{i}" for i in range(n_cards)], check)
    log(f"phase 6e: {n_cards} `cli aln` processes, one per card "
        f"(--device cuda:i --num-shards {n_cards} --shard-id i, batch "
        f"{SHARD_BATCH}), merged = one process on cuda:0 byte for byte but "
        f"the @PG command line: {len(reads)} reads in "
        f"{shards['shard_processes_wall_s']:.2f} s of wall = "
        f"{len(reads) / shards['shard_processes_wall_s']:.2f} reads/s "
        f"against one process's {shards['one_process_wall_s']:.2f} s = "
        f"{len(reads) / shards['one_process_wall_s']:.2f} reads/s (first "
        f"start to last exit); aligning alone (each process's own count): "
        f"{shards['one_process_aln_reads_per_s']} reads/s in one process, "
        f"{shards['shard_processes_aln_reads_per_s']} in the shard "
        f"processes; on {card}")
    if failures:
        fail(f"phase 6e: {len(failures)} checks failed: {failures}")
    log(f"phase 6e passed in {time.perf_counter() - t6e:.1f} s")
    return {"cards": n_cards, "launches_card1": lc1,
            "card1_reads_per_s": rps1, "card0_reads_per_s": rps3,
            "card1_fm_reads_per_s": rps_f, "card0_fm_reads_per_s": fm["rps"],
            "card1_max_memory_allocated": peak1, **shards}


def world_files(d, genome, k, reads):
    """The world written into directory d, genome and reads as FASTA
    (the simulated reads carry no qualities, so their SAM QUAL stays
    "*" as in memory), and indexed there by this package's `cli index`
    (k-mer size k); returns the two paths."""
    from lamsa_tpu_torch import cli
    from lamsa_tpu_torch.io.fasta import write_fasta

    ref_fa, reads_fa = os.path.join(d, "g.fa"), os.path.join(d, "r.fa")
    write_fasta(ref_fa, genome)
    write_fasta(reads_fa, reads)
    if cli.main(["index", "-k", str(k), ref_fa]) != 0:
        fail("cli index exited non-zero")
    return ref_fa, reads_fa


STATS_TAG = "[lamsa_tpu_torch host_loop] stats "


def host_loops(ref_fa, fq, devices, batch, out, tries=2):
    """One `python -m lamsa_tpu_torch.parallel.host_loop` process per
    entry of devices (process i on devices[i]), all at once, joined by
    multihost.initialize at a free local port (started again on a new
    port if process 0 found it taken); process 0 writes the merged SAM
    to out. Returns (wall seconds from the first start to the last
    exit, the wall clock at the start, [(exit code, stats or None,
    stderr)])."""
    import socket
    for _ in range(tries):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t_launch = time.time()
        wall, res = cli_processes(
            [["--coordinator", f"127.0.0.1:{port}",
              "--num-processes", str(len(devices)), "--process-id", str(i),
              "--device", dev, "--batch-reads", str(batch), "-o", out,
              ref_fa, fq] for i, dev in enumerate(devices)],
            timeout=300, module="lamsa_tpu_torch.parallel.host_loop")
        if "EADDRINUSE" not in res[0][1]:
            break
    procs = []
    for rc, err in res:
        tail = err.split(STATS_TAG)
        procs.append((rc, json.loads(tail[1].splitlines()[0])
                      if len(tail) > 1 else None, err))
    return wall, t_launch, procs


def phase_multihost(card, world, out3, cards):
    """Phase 6g: the JAX package's multi-host design on the card (see the
    module docstring). Every check runs before the phase fails. Returns
    its numbers."""
    import tempfile

    import torch

    t6g = time.perf_counter()
    genome, _ref, idx, _cfg, reads = world
    want = [ln + "\n" for ln in sam_lines(out3)]
    n_cards = torch.cuda.device_count()
    total = torch.cuda.mem_get_info(0)[1]
    failures, nums = [], {}

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            log(f"phase 6g: CHECK FAILED: {msg}")

    def run(d, ref_fa, fq, devices, batch, what):
        out = os.path.join(d, "merged.sam")
        if os.path.exists(out):
            os.unlink(out)
        wall, t_launch, procs = host_loops(ref_fa, fq, devices, batch, out)
        for i, (rc, st, err) in enumerate(procs):
            check(rc == 0, f"{what}: process {i} exited {rc}: {err[-1500:]}")
            check(st is not None, f"{what}: process {i} printed no stats")
        stats = [st for _, st, _ in procs if st is not None]
        for st in stats:
            check(min(st["launches"].values()) > 0,
                  f"{what}: a kernel was never launched in process "
                  f"{st['process']}: {st['launches']}")
            t = st["t"]
            ready = st["t0"] + t["index_upload"] - t_launch
            log(f"phase 6g {what}: process {st['process']} on "
                f"{st['device']}: {st['batches']} batches, {st['reads']} "
                f"reads in {st['align_s']:.3f} s = {st['reads_per_s']} "
                f"reads/s (its own count); launches {st['launches']}; "
                f"max_memory_allocated {st['max_memory_allocated']} B, "
                f"reserved {st['memory_reserved']} B, in-flight budget "
                f"{st['inflight_budget']} B; start to aligner ready "
                f"{ready:.2f} s (import torch {st['t0'] - t_launch:.2f}, "
                f"CUDA context {t['cuda_context']:.2f}, libraries "
                f"{t['kernel_library'] - t['cuda_context']:.2f}, group "
                f"{t['group'] - t['kernel_library']:.2f}, index and "
                f"upload {t['index_upload'] - t['group']:.2f}); merge "
                f"{t['merged'] - t['aligned']:.3f} s, write "
                f"{t['written'] - t['merged']:.3f} s; host RSS MB "
                f"{st['rss_mb']}")
        got = open(out).readlines() if os.path.exists(out) else []
        check(bool(got) and got[0].startswith("@HD"),
              f"{what}: the merged SAM has no header")
        recs = [ln for ln in got if not ln.startswith("@")]
        check(recs == want, f"{what}: merged SAM != phase 3's one process "
              f"({len(recs)} vs {len(want)} records)")
        check(sum(st["reads"] for st in stats) == len(reads),
              f"{what}: the processes aligned "
              f"{sum(st['reads'] for st in stats)} of {len(reads)} reads")
        ready = max((st["t0"] + st["t"]["index_upload"] - t_launch
                     for st in stats), default=float("nan"))
        merge_s = max((st["t"]["merged"] - st["t"]["aligned"]
                       for st in stats), default=float("nan"))
        log(f"phase 6g {what}: {len(reads)} reads in {wall:.2f} s of wall "
            f"(first start to last exit) = {len(reads) / wall:.2f} reads/s; "
            f"start-up (to the last aligner ready) {ready:.2f} s = "
            f"{ready / wall:.3f} of the wall; merge {merge_s:.3f} s; "
            f"in-flight budgets planned "
            f"{sum(st['inflight_budget'] for st in stats)} B of the card's "
            f"{total} B; SAM = phase 3's: {recs == want}")
        return {"wall_s": wall, "startup_s": ready, "merge_s": merge_s,
                "processes": [{k: st[k] for k in (
                    "process", "device", "reads", "reads_per_s",
                    "launches", "max_memory_allocated", "memory_reserved",
                    "inflight_budget", "rss_mb", "t")} for st in stats]}

    with tempfile.TemporaryDirectory() as d:
        ref_fa, fq = world_files(d, genome, idx.k, reads)
        log(f"phase 6g: {MH_PROCS} host_loop processes on cuda:0 through "
            f"multihost.initialize / merge_sam_shards (config-1, batch "
            f"{MH_BATCH}), {MH_RUNS} times")
        nums["one_card"] = [run(d, ref_fa, fq, ["cuda:0"] * MH_PROCS,
                                MH_BATCH, f"{MH_PROCS} on cuda:0 run {r}")
                            for r in range(MH_RUNS)]
        one_s = time.perf_counter() - t6g
        check(one_s <= MH_WALL_S, f"phase 6g on cuda:0 took {one_s:.1f} s "
              f"(bar {MH_WALL_S} s)")
        nums["one_card_s"] = one_s
        if n_cards > 1:
            devs = [f"cuda:{i}" for i in range(n_cards)]
            nums["cards"] = [run(d, ref_fa, fq, devs, SHARD_BATCH,
                                 f"one per card ({n_cards}) run {r}")
                             for r in range(MH_RUNS)]
            if cards:
                walls = [r["wall_s"] for r in nums["cards"]]
                log(f"phase 6g: {n_cards} host_loop processes, one per "
                    f"card, {len(reads)} reads in {min(walls):.2f}-"
                    f"{max(walls):.2f} s of wall, beside phase 6e's "
                    f"{n_cards} `cli aln` shard processes "
                    f"{cards['shard_processes_wall_s']:.2f} s (aligning "
                    f"alone {cards['shard_processes_aln_reads_per_s']} "
                    f"reads/s) and one process's "
                    f"{cards['one_process_wall_s']:.2f} s, on {card}")
    wall = time.perf_counter() - t6g
    nums["phase_s"] = wall
    if failures:
        fail(f"phase 6g: {len(failures)} checks failed: {failures}")
    log(f"phase 6g passed in {wall:.1f} s ({nums['one_card_s']:.1f} s of it "
        f"on cuda:0)")
    return nums


def shard_processes(genome, k, reads, devices, check):
    """The JAX package's shard deployment, one process per device: the
    world written to a temporary directory and indexed, one `cli aln`
    process on devices[0], then one `cli aln --device devices[i]
    --num-shards N --shard-id i` process per device, all at once, and
    `merge` of their files, which must equal the one process's apart
    from the @PG command line (failures go to check). The kernels and
    the native library must have been built by the caller. Returns the
    walls and each process's own reads/s."""
    import tempfile

    from lamsa_tpu_torch import cli

    n = len(devices)
    with tempfile.TemporaryDirectory() as d:
        ref_fa, fq = world_files(d, genome, k, reads)
        common = ["aln", "--batch-reads", str(SHARD_BATCH)]
        one = os.path.join(d, "one.sam")
        wall1, res1 = cli_processes(
            [common + ["--device", devices[0], "-o", one, ref_fa, fq]])
        paths = [os.path.join(d, f"s{i}.sam") for i in range(n)]
        wall_n, res_n = cli_processes(
            [common + ["--device", dev, "--num-shards", str(n),
                       "--shard-id", str(i), "-o", paths[i], ref_fa, fq]
             for i, dev in enumerate(devices)])
        for rc, err in res1 + res_n:
            check(rc == 0, f"a cli aln process exited {rc}: {err[-2000:]}")
        merged = os.path.join(d, "merged.sam")
        ok = all(rc == 0 for rc, _ in res1 + res_n) and cli.main(
            ["merge", "-o", merged, *paths]) == 0
        check(ok, "cli merge of the shard files failed")
        if ok:
            check(without_pg_cl(merged) == without_pg_cl(one),
                  f"{n} shard processes merged != one process")
            check(sum(1 for ln in open(one) if not ln.startswith("@"))
                  >= len(reads), "one process wrote fewer records than "
                  "reads")
    return {"shard_processes_wall_s": wall_n, "one_process_wall_s": wall1,
            "shard_processes_aln_reads_per_s": [cli_reads_per_s(e)
                                                for _, e in res_n],
            "one_process_aln_reads_per_s": cli_reads_per_s(res1[0][1])}


def phase_steps():
    """Phase 6f: full_align_step over two entries of card 0 and, with
    more than one card, over ["cuda:0", "cuda:1"] (replicated and
    sharded index) against the plain CPU run."""
    import torch

    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.ops.testing import make_batch
    from lamsa_tpu_torch.parallel.mesh import full_align_step, make_mesh
    from lamsa_tpu_torch.pipeline.seeding import make_qpos_grid

    rng = np.random.default_rng(3)
    cfg = AlignConfig(seed_step=10)
    genome = sim.random_genome(rng, 20000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    idx = KmerIndex.build(codes, 13)
    B, L = 16, 256
    reads = sim.simulate_reads(rng, genome, B, read_len=(L // 2, L - 8),
                               sub=0.01, ins=0.03, dele=0.03)
    rc = np.full((B, L), 4, np.int32)
    rl = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        c = np.frombuffer(encode_seq(r.seq), np.uint8)[:L]
        rc[i, :len(c)] = c
        rl[i] = len(c)
    index = {"k": idx.k, "grid": make_qpos_grid(L, idx.k, cfg.seed_step),
             "keys": idx.keys, "starts": idx.starts, "counts": idx.counts,
             "positions": idx.positions}
    q, t_win, m_len, n_len, lo = make_batch(rng, B, 128, 128)
    dp = {"q": q, "t_win": t_win, "m_len": m_len, "n_len": n_len, "lo": lo}
    batch = {"codes": rc, "len": rl}
    want = full_align_step(make_mesh(["cpu"]), batch, index, dp, cfg)
    meshes = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        meshes.append(["cuda:0", "cuda:1"])
    for entries in meshes:
        for shard_index in (False, True):
            got = full_align_step(make_mesh(entries), batch, index, dp, cfg,
                                  shard_index=shard_index)
            for part in ("chain", "dp"):
                for n, w in want[part].items():
                    if not torch.equal(got[part][n].cpu(), w):
                        fail(f"full_align_step over {entries} (shard_index "
                             f"{shard_index}) != cpu ({part} {n})")
    log(f"phase 6f: full_align_step over {' and '.join(map(str, meshes))} "
        f"= the plain cpu run (chains and DP scores of {B} reads and {B} "
        f"instances, replicated and sharded index)")


def phase_tiles(dev, scores):
    """--tiles: both walkers' times by tile shape. The direction words
    come once from the DP kernels on the phase-2 recipes; then, per
    variant, _build's flags and library path are pointed at that shape,
    the library is rebuilt and loaded, and each walker is timed (CUDA
    events around 3 calls, the least of 3 such means) at every bucket
    on all B = CHUNK_BY_M instances and on the first SMALL_CHUNK of
    them, and its share of blocking reloads among the tiles it staged
    is read from the kernel's debug output. The row walker is also
    timed on chunks whose every instance carries a W/2 - 16 deletion.
    The first variant must be the committed WALK_TILES; every other
    variant's outputs must equal its."""
    import torch

    from lamsa_tpu_torch import _build
    from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops.testing import (make_batch,
                                             make_deletion_batch,
                                             make_globals,
                                             walker_counts_cuda)
    from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag
    from lamsa_tpu_torch.ops.traceback_row import traceback_row
    from lamsa_tpu_torch.pipeline.extend import BUCKETS, CHUNK_BY_M

    kw = dict(match=scores.match, mismatch=scores.mismatch,
              gapo=scores.gap_open, gape=scores.gap_ext)
    rng = np.random.default_rng(20260817)

    def least_ms(fn):
        return min(cuda_ms(fn, 3) for _ in range(3))

    walks = []      # per bucket: the row walk's and the adiag walk's inputs
    for M, W in BUCKETS:
        B = CHUNK_BY_M[(M, W)]
        q, t_win, m, n, lo = [torch.from_numpy(a).to(dev)
                              for a in make_batch(rng, B, M, W)]
        row = banded_sw_row(q, t_win, m, n, lo, torch.zeros_like(m), **kw)
        rwalk = (row["dirs32"], lo, m.clone(), (n - m - lo).contiguous())
        q, t_win, m, n, lo = [torch.from_numpy(a).to(dev) for a in
                              make_globals(rng, B, M, W, stress=True)]
        ad = banded_sw_adiag(q, t_win, m, n, lo, **kw)
        awalk = (ad["dirs32a"], m, (n - m - lo).contiguous(),
                 (lo >> 1).contiguous())
        q, t_win, m, n, lo = [torch.from_numpy(a).to(dev) for a in
                              make_deletion_batch(rng, B, M, W)]
        row = banded_sw_row(q, t_win, m, n, lo, torch.zeros_like(m), **kw)
        dwalk = (row["dirs32"], lo, m.clone(), (n - m - lo).contiguous())
        walks.append((M, rwalk, awalk, dwalk))
    torch.cuda.synchronize()

    def head(walk):
        return tuple(x[:SMALL_CHUNK].contiguous() for x in walk)

    base_flags = tuple(f for f in _build.NVCC_FLAGS
                       if "_TILE_" not in f)
    first = {k: (_build.WALK_TILES[f"{k}_TILE_ROWS"],
                 _build.WALK_TILES[f"{k}_TILE_LANES"])
             for k in TILE_VARIANTS}
    if any(v[0] != first[k] for k, v in TILE_VARIANTS.items()):
        fail(f"the first tile variant is not the committed one ({first})")
    lib_dir, want, out = os.path.dirname(_build.LIB_PATH), None, []
    for v in range(len(TILE_VARIANTS["ROW"])):
        shape = {k: TILE_VARIANTS[k][v] for k in TILE_VARIANTS}
        for k, (rows, lanes) in shape.items():
            _build.WALK_TILES.update({f"{k}_TILE_ROWS": rows,
                                      f"{k}_TILE_LANES": lanes,
                                      f"{k}_TILE_LEFT": lanes // 2 - 2})
        _build.NVCC_FLAGS = base_flags + tuple(
            f"-D{k}={x}" for k, x in _build.WALK_TILES.items())
        _build.LIB_PATH = os.path.join(lib_dir, f"libkernels_tiles{v}.so")
        _build._lib = None
        _build.lib()
        got, ms = [], {"ROW": [], "ADIAG": [], "ROW_chunk": [],
                       "ADIAG_chunk": [], "ROW_deletions": []}
        staged = {"ROW": torch.zeros(2, dtype=torch.int64),
                  "ADIAG": torch.zeros(2, dtype=torch.int64)}
        for M, rwalk, awalk, dwalk in walks:
            got.append((traceback_row(*rwalk), traceback_adiag(*awalk, M=M)))
            ms["ROW_deletions"].append(
                least_ms(lambda: traceback_row(*dwalk)))
            staged["ROW"] += walker_counts_cuda(
                "row", *rwalk)[1].sum(dim=0).cpu()
            staged["ADIAG"] += walker_counts_cuda(
                "adiag", *awalk, M=M)[1].sum(dim=0).cpu()
            ms["ROW"].append(least_ms(lambda: traceback_row(*rwalk)))
            ms["ADIAG"].append(
                least_ms(lambda: traceback_adiag(*awalk, M=M)))
            rh, ah = head(rwalk), head(awalk)
            ms["ROW_chunk"].append(least_ms(lambda: traceback_row(*rh)))
            ms["ADIAG_chunk"].append(
                least_ms(lambda: traceback_adiag(*ah, M=M)))
        if want is None:
            want = got
        for (M, *_), g, w_ in zip(walks, got, want):
            if not all(torch.equal(a, b) for gs, ws in zip(g, w_)
                       for a, b in zip(gs, ws)):
                fail(f"tile variant {shape} changed a walker's output at "
                     f"M={M}")
        for k in ("ROW", "ADIAG"):
            tiles, reloads = staged[k].tolist()
            ms[k + "_tiles_reloads"] = [tiles, reloads]
            log(f"{k} tile {shape[k][0]} x {shape[k][1]}: "
                f"sum {sum(ms[k]):.3f} ms, 128-instance chunks "
                f"{sum(ms[k + '_chunk']):.3f} ms, blocking reloads "
                f"{reloads} of {tiles} tiles; per bucket "
                + " ".join(f"{x:.3f}" for x in ms[k]) + " | "
                + " ".join(f"{x:.3f}" for x in ms[k + "_chunk"]))
        log(f"ROW tile {shape['ROW'][0]} x {shape['ROW'][1]} on chunks whose "
            f"every instance scans a W/2 - 16 deletion: sum "
            f"{sum(ms['ROW_deletions']):.3f} ms; per bucket "
            + " ".join(f"{x:.3f}" for x in ms["ROW_deletions"]))
        out.append({"shape": shape, "ms": ms})
    return out


# ------------------------------------------------- the ported tools' worlds

def phase_repeat(dev, card):
    """Phase 3r: tests/test_mapq.py's repeat-family world on the card
    (lamsa_tpu_torch/tools/repeat_bench.py's genome at 1.5 Mb, 100 reads of
    1-6 kb, preset("pacbio")). Returns the kernels' launches in its run."""
    import torch

    from lamsa_tpu_torch.pipeline.aln import Aligner
    from lamsa_tpu_torch.tools import repeat_bench as rb

    t0 = time.perf_counter()
    _genome, ref, idx, cfg, reads = rb.repeat_world(
        REPEAT_MB, N_REPEAT, read_len=REPEAT_READ_LEN)
    log(f"phase 3r: repeat-family world, {ref.total_len} bp "
        f"(sim.repeat_genome), k={idx.k}, {len(reads)} reads, "
        f"preset('pacbio'); built in {time.perf_counter() - t0:.1f} s")
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = rb.align(Aligner(ref, idx, cfg, device=dev), reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f"repeat world: {len(reads)} reads in {wall:.3f} s = "
        f"{len(reads) / wall:.2f} reads/s (first batch included) on {card}; "
        f"launches {launches}")
    if min(launches.values()) <= 0:
        fail(f"phase 3r: a kernel was never launched: {launches}")
    pairs = rb.mapq_calibration(out, reads)
    hi = [ok for m, ok in pairs if m >= 30]
    wrong = sum(1 for ok in hi if not ok)
    log(f"repeat world MAPQ >= 30: {wrong} wrong of {len(hi)} records "
        f"(bar: < 1%, at least 50 records); below 30: "
        f"{sum(1 for m, ok in pairs if m < 30 and not ok)} wrong of "
        f"{sum(1 for m, _ in pairs if m < 30)}")
    if len(hi) < 50 or wrong >= 0.01 * len(hi):
        fail(f"phase 3r: MAPQ >= 30 error {wrong}/{len(hi)} (bar: < 1% "
             f"of at least 50)")
    t0 = time.perf_counter()
    cpu = rb.align(Aligner(ref, idx, cfg, device="cpu"), reads)
    got = sam_lines(out)
    check_sam(got, sam_lines(cpu), "phase 3r: repeat world cuda vs cpu")
    log(f"phase 3r ok: SAM of all {len(reads)} reads ({len(got)} records) "
        f"is byte-identical between cuda and the cpu plain path "
        f"({time.perf_counter() - t0:.1f} s on the cpu)")
    return launches


def _soak_workdir(genome, workdir):
    """The soak tool's workdir: index/ from this package's `cli index`
    over the genome (auto k), in the JAX package's layout."""
    from lamsa_tpu_torch import cli
    from lamsa_tpu_torch.io.fasta import write_fasta
    fa = os.path.join(workdir, "genome.fa")
    write_fasta(fa, genome)
    if cli.main(["index", fa]) != 0:
        raise RuntimeError("cli index failed")
    os.rename(fa + ".lti", os.path.join(workdir, "index"))
    os.unlink(fa)


def soak_batches(workdir, dev, check):
    """In this process, on the soak's reads with the soak's `cli aln`
    config: the first batch (its launches, recall, SAM equal to leg A's
    records of its reads); then the first of SOAK_SCAN batches whose DP
    reaches the (5120, 256) bucket, narrowed on the card by halves to at
    most 8 reads that still reach it, whose SAM must equal the CPU
    path's. Returns the numbers."""
    import torch

    from lamsa_tpu_torch import cli
    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import read_fastx
    from lamsa_tpu_torch.io.refpack import PackedReference
    from lamsa_tpu_torch.pipeline.aln import Aligner
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

    n = SOAK_BATCH
    idx_dir = os.path.join(workdir, "index")
    ref = PackedReference.load(idx_dir)
    idx = KmerIndex.load(idx_dir)
    soak = os.path.join(workdir, "soak")
    reads = []
    for r in read_fastx(os.path.join(soak, f"reads_{SOAK_READS}.fq")):
        reads.append(r)
        if len(reads) == SOAK_SCAN * n:
            break
    by_name = collections.defaultdict(list)
    with open(os.path.join(soak, "runA", "out.sam")) as fh:
        for ln in fh:
            if not ln.startswith("@"):
                by_name[ln.split("\t", 1)[0]].append(ln.rstrip("\n"))
    cfg = cli.aln_config(cli.build_parser().parse_args(
        ["aln", "--batch-reads", str(n), "genome.fa", "reads.fq"]))
    aligner = Aligner(ref, idx, cfg, device=dev)

    def run(batch):
        STATS.reset()
        out = aligner.align_batch(batch)
        torch.cuda.synchronize()
        return out, STATS.counters.get("dp_instances_5120x256", 0)

    nums, found = {}, None
    for b in range(SOAK_SCAN):
        batch = reads[b * n:(b + 1) * n]
        launch_counts(reset=True)
        out, n5120 = run(batch)
        if b == 0:
            launches = launch_counts()
            st = evaluate(out, batch)
            nums["first_batch"] = {"launches": launches,
                                   "part_recall": st.part_recall,
                                   "read_accuracy": st.read_accuracy}
            log(f"one soak batch ({n} reads) in this process: launches "
                f"{launches}; {st.summary()}")
            got = sam_lines(out)
            check(got == [ln for r in batch for ln in by_name[r.name]],
                  f"one soak batch in this process = leg A's records of "
                  f"those reads ({len(got)})")
        if n5120:
            found = (b, batch)
            break
    check(found is not None, f"one of the first {SOAK_SCAN} soak batches "
                             f"reaches (5120, 256)")
    if found is None:
        return nums
    b, group = found
    while len(group) > 8:
        half = len(group) // 2
        group = group[:half] if run(group[:half])[1] else group[half:]
    out, n5120 = run(group)
    t0 = time.perf_counter()
    cpu = Aligner(ref, idx, cfg, device="cpu").align_batch(group)
    nums["bucket_5120x256"] = {"batch": b, "reads": [r.name.split("|")[0]
                                                     for r in group],
                               "instances": n5120}
    check(n5120 > 0 and sam_lines(out) == sam_lines(cpu),
          f"soak batch {b} reaches (5120, 256); {len(group)} of its reads "
          f"still reach it ({n5120} instances) and their SAM on the card = "
          f"the cpu path's ({time.perf_counter() - t0:.1f} s on the cpu)")
    return nums


def rss_probe(workdir, dev, leg_a, check):
    """The host RSS of one `cli aln`-like process on the soak's index,
    split at the points a process passes: one host_loop process (no
    group; the soak's aln options) on the soak's first SOAK_BATCH reads
    reports its RSS after import torch, the CUDA context, the kernel and
    native libraries, the index and reference upload, and its first
    batch; printed beside leg A's RSS. Returns the split."""
    idx_dir = os.path.join(workdir, "genome.fa.lti")
    if not os.path.exists(idx_dir):
        os.symlink(os.path.join(workdir, "index"), idx_dir)
    fq = os.path.join(workdir, "probe.fq")
    with open(os.path.join(workdir, "soak", f"reads_{SOAK_READS}.fq")) as fh, \
            open(fq, "w") as out:
        for _ in range(4 * SOAK_BATCH):        # FASTQ: four lines a read
            out.write(fh.readline())
    _wall, _t, procs = host_loops(os.path.join(workdir, "genome.fa"), fq,
                                  [str(dev)], SOAK_BATCH,
                                  os.path.join(workdir, "probe.sam"))
    rc, st, err = procs[0]
    check(rc == 0 and st is not None,
          f"RSS probe process exited {rc}: {err[-1500:]}")
    if st is None:
        return {}
    import glob

    import torch
    rss = st["rss_mb"]
    steps = list(rss)
    site = os.path.dirname(os.path.dirname(torch.__file__))
    libs_mb = sum(os.path.getsize(f) for d in
                  [os.path.join(site, "torch", "lib")]
                  + glob.glob(os.path.join(site, "nvidia", "*", "lib"))
                  for f in glob.glob(os.path.join(d, "*.so*"))) / 2**20
    log("--tools (c): host RSS of one aln process on the soak's index "
        "(MB, and the step's rise): " + ", ".join(
            f"{k} {rss[k]:.1f} (+{rss[k] - (rss[steps[i - 1]] if i else 0):.1f})"
            for i, k in enumerate(steps))
        + f"; shared libraries of torch and its CUDA wheels {libs_mb:.1f} "
        f"MB on disk; leg A's cli aln: first quarter "
        f"{leg_a.get('rss_first_quarter_mb')} MB, peak "
        f"{leg_a.get('rss_peak_mb')} MB; the probe's device memory: "
        f"max_memory_allocated {st['max_memory_allocated']} B, reserved "
        f"{st['memory_reserved']} B")
    return {"rss_mb": rss, "torch_libs_mb": libs_mb,
            "max_memory_allocated":
            st["max_memory_allocated"], "memory_reserved":
            st["memory_reserved"], "t": st["t"]}


def soak_buckets(workdir):
    """DP instances / cells per bucket over leg A's whole run: the
    counters of the last line of its --stats file."""
    with open(os.path.join(workdir, "soak", "runA", "stats.jsonl")) as fh:
        return dp_buckets(json.loads(fh.readlines()[-1])["counters"])


def phase_tools(dev, card):
    """--tools: the port's validation tools on the card (see the module
    docstring). Every check runs and is reported before the mode fails
    on any. Returns the numbers of its JSON line."""
    import shutil
    import tempfile
    import traceback

    import torch

    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.pipeline.aln import Aligner
    from lamsa_tpu_torch.tools import ont_preset_sweep as ont
    from lamsa_tpu_torch.tools import repeat_bench as rb
    from lamsa_tpu_torch.tools import soak_bench
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

    failures = []
    nums = {"card": card}

    def check(ok, msg):
        log(f"check: {msg}: {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append(msg)

    def part(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:       # noqa: BLE001 - reported, then the mode fails
            log(f"{name} raised:\n{traceback.format_exc()}")
            failures.append(f"{name} raised")
        nums[f"{name}_s"] = time.perf_counter() - t0
        log(f"{name}: {nums[f'{name}_s']:.1f} s")

    worlds = {}

    def repeat_worlds():
        for mb, n in TOOLS_REPEAT:
            key = f"repeat_{mb:g}mb"
            log(f"--tools (a): repeat_bench at {mb} Mb, {n} reads on {card}")
            STATS.reset()
            launch_counts(reset=True)
            r = rb.run(n, mb, device=str(dev))
            torch.cuda.synchronize()
            launches = launch_counts()
            buckets = log_dp_buckets()
            res = r["result"]
            nums[key] = {**res, "reads_per_s": r["reads_per_s"],
                         "launches": launches, "dp_buckets": buckets,
                         "bucket_5120x256": "5120x256" in buckets}
            log(f"{key}: {r['reads_per_s']:.2f} reads/s (first batch "
                f"included), launches {launches}; (5120, 256) reached: "
                f"{'5120x256' in buckets}")
            check(min(launches.values()) > 0,
                  f"{key}: every kernel launched ({launches})")
            check(res["n_records_mapq30"] >= 50 and res["value"] < 0.01,
                  f"{key}: MAPQ >= 30 error {res['value']} < 0.01 on "
                  f"{res['n_records_mapq30']} records (>= 50)")
            t0 = time.perf_counter()
            cpu = rb.align(Aligner(r["ref"], r["index"], r["config"],
                                   device="cpu"),
                           r["reads"][:N_TOOLS_SAM_CHECK])
            same = sam_lines(r["out"][:N_TOOLS_SAM_CHECK]) == sam_lines(cpu)
            check(same, f"{key}: SAM cuda = cpu on the first "
                        f"{N_TOOLS_SAM_CHECK} reads "
                        f"({time.perf_counter() - t0:.1f} s on the cpu)")
            for strand in "+-":
                sel = [i for i, rd in enumerate(r["reads"])
                       if sim.parse_truth(rd.name)[0].strand == strand]
                st = evaluate([r["out"][i] for i in sel],
                              [r["reads"][i] for i in sel])
                nums[key][f"part_recall_{strand}"] = st.part_recall
                log(f"{key}, reads whose first part lies on the {strand} "
                    f"strand: {st.summary()}")
            worlds[mb] = r["genome"]

    def sweep():
        log(f"--tools (b): ONT preset sweep, {N_ONT} reads per cell on "
            f"{card}")
        keep = {(row, "28%") for row in ONT_CHECK_ROWS}
        launch_counts(reset=True)
        cells, kept, (_g, ref, idx, fm) = ont.sweep(N_ONT, str(dev),
                                                    keep=keep)
        torch.cuda.synchronize()
        launches = launch_counts()
        nums["ont_sweep"] = {"cells": cells, "launches": launches}
        check(min(launches.values()) > 0,
              f"ont sweep: every kernel launched ({launches})")
        cands = ont.candidates(idx, fm)
        for row, prof in sorted(keep):
            reads, out = kept[(row, prof)]
            cfg, index = cands[row]
            t0 = time.perf_counter()
            cpu = Aligner(ref, index, cfg, device="cpu").align_batch(reads)
            check(sam_lines(out) == sam_lines(cpu),
                  f"ont sweep {row} at {prof}: SAM cuda = cpu on all "
                  f"{len(reads)} reads ({time.perf_counter() - t0:.1f} s "
                  f"on the cpu)")

    def soak():
        genome = worlds.get(TOOLS_REPEAT[-1][0])
        if genome is None:
            raise RuntimeError("the 64 Mb repeat genome was not built")
        workdir = tempfile.mkdtemp(prefix="soak_")
        try:
            t0 = time.perf_counter()
            _soak_workdir(genome, workdir)
            log(f"--tools (c): soak workdir indexed by `cli index` in "
                f"{time.perf_counter() - t0:.1f} s; soak_bench --leg all, "
                f"{SOAK_READS} reads, batch {SOAK_BATCH}, kill fraction "
                f"{SOAK_KILL}, on {card}")
            res = soak_bench.main([
                "--workdir", workdir, "--reads", str(SOAK_READS),
                "--batch", str(SOAK_BATCH), "--leg", "all",
                "--kill-frac", str(SOAK_KILL), "--device", str(dev)])
            nums["soak"] = res
            a, b = res["leg_A"], res["leg_B"]
            check(a["rss_flat_10pct"],
                  f"soak leg A RSS last quarter {a['rss_last_quarter_mb']} "
                  f"MB <= 1.10 x first {a['rss_first_quarter_mb']} MB "
                  f"(peak {a['rss_peak_mb']})")
            mem = "dev_mem" if "dev_mem_flat_10pct" in a else "reserved"
            check(a.get(f"{mem}_flat_10pct", False),
                  f"soak leg A device memory ({mem}; source "
                  f"{a.get('dev_mem_source')}) last quarter "
                  f"{a.get(f'{mem}_last_quarter_mb')} MB <= 1.10 x first "
                  f"{a.get(f'{mem}_first_quarter_mb')} MB (peak "
                  f"{a.get(f'{mem}_peak_mb')})")
            log(f"soak leg A caching allocator: allocated first / last "
                f"quarter / peak {a.get('allocated_first_quarter_mb')} / "
                f"{a.get('allocated_last_quarter_mb')} / "
                f"{a.get('allocated_peak_mb')} MB, reserved "
                f"{a.get('reserved_first_quarter_mb')} / "
                f"{a.get('reserved_last_quarter_mb')} / "
                f"{a.get('reserved_peak_mb')} MB")
            log(f"soak leg A throughput windows {a['window_curve']}; after "
                f"window 0: {a['steady']} (max_dev reported, no bar)")
            check(b["shard0_killed"] and b["resume_merge_equals_plain_run"],
                  f"soak leg B: shard 0 killed at {b['kill_at_reads']} "
                  f"reads ({b['shard0_killed']}), resumed, merged = leg "
                  f"A's SAM apart from @PG / @CO")
            buckets = soak_buckets(workdir)
            nums["soak_dp_buckets"] = buckets
            log("soak leg A DP instances / cells per bucket: " + ", ".join(
                f"{k}: {i} / {c}" for k, (i, c) in buckets.items())
                + f"; (5120, 256) reached: {'5120x256' in buckets}")
            nums["soak_batches"] = soak_batches(workdir, dev, check)
            nums["rss_probe"] = rss_probe(workdir, dev, a, check)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)

    part("repeat", repeat_worlds)
    part("ont_sweep", sweep)
    part("soak", soak)
    nums["failures"] = failures
    if failures:
        print(json.dumps({"tools": nums}, default=str), flush=True)
        fail(f"--tools: {len(failures)} checks failed: {failures}")
    return nums


def main() -> int:
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke test runs "
             "the CUDA kernels on a card and has no CPU path")
    try:
        from lamsa_tpu_torch import _build
        from lamsa_tpu_torch.config import ScoreParams
    except ImportError as e:
        fail(f"the repository is not next to chip_smoke.py ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    with open(_build.LOG_PATH) as fh:
        for ln in fh:
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log("ptxas: " + ln.strip())

    if sys.argv[1:] == ["--wholegenome"]:
        nums = phase_wholegenome(dev, card)
        nums["elapsed_s"] = time.perf_counter() - t_start
        print(json.dumps({"wholegenome": nums}), flush=True)
        return 0
    if sys.argv[1:] == ["--tools"]:
        nums = phase_tools(dev, card)
        nums["elapsed_s"] = time.perf_counter() - t_start
        log(f"all checks of --tools passed in {nums['elapsed_s']:.1f} s")
        print(json.dumps({"tools": nums}, default=str), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    from lamsa_tpu_torch.worlds import build_world
    scores = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1)
    if sys.argv[1:] == ["--tiles"]:
        print(json.dumps({"card": card, "tiles": phase_tiles(dev, scores)}),
              flush=True)
        return 0
    cards_only = sys.argv[1:] == ["--cards"]
    if cards_only and torch.cuda.device_count() < 2:
        fail("--cards needs more than one card")
    if not cards_only:
        rng = np.random.default_rng(20260817)
        err, tot, bnd = phase_kernels(dev, scores, rng)
        err_a, tot_a, bnd_a = phase_adiag(dev, scores, rng)
        err_e = phase_edges(dev, scores, rng)
        fixed_sums, walk_sums = phase_fixed(dev, scores,
                                            np.random.default_rng(20260818))
        kernel_ms = {n: fixed_sums[(n, "phase2")][0] for n in DP_WRAPPERS}
        kernel_ms.update({n: walk_sums[(n, "phase2")]
                          for n in ("traceback_row", "traceback_adiag")})
    t0 = time.perf_counter()
    world = build_world()
    log(f"config-1 world built in {time.perf_counter() - t0:.1f} s")
    launches, rps3, e2e_ms, out3 = phase_e2e(dev, card, world)
    ref1 = world[1]
    checks = [("phase 3", out3, ref1)]
    if not cards_only:
        launches_repeat = phase_repeat(dev, card)
        out4 = phase_10kb(dev, card, world)
        checks.append(("phase 4", out4, ref1))
    fm = phase_fm(dev, card)
    if not cards_only:
        phase_coords(dev, scores)
    t6 = time.perf_counter()
    launches_mesh, outs6, two_cards = phase_mesh(card, world, out3, rps3, fm)
    phase_sharded(world)
    phase_cli(card)
    ref_fm = fm["ref"]
    phase_validate(checks + [("phase 5", fm["out"], ref_fm),
                             ("phase 5 28% error", fm["out_h"], ref_fm)]
                   + [("phase 6a", o, ref1) for o in outs6[:-2]]
                   + [("phase 6a FM", o, ref_fm) for o in outs6[-2:]])
    cards = phase_cards(card, world, out3, rps3, fm)
    phase_steps()
    mh = phase_multihost(card, world, out3, cards)
    log(f"phase 6 passed in {time.perf_counter() - t6:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "lamsa_tpu", "bench",
                                           "tools"))
    if leaked:
        fail(f"the port imported {leaked}")
    if cards_only:
        log(f"all phases of --cards passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"cards": {**cards, "two_card_mesh": two_cards,
                                    "launches_card0": launches,
                                    "multihost": mh}}),
              flush=True)
        return 0
    rows = (("banded_sw_row", "banded_sw_pallas.py:344", err["dp"],
             err_e["dp"], tot["dp"], tot["dp_plain"], bnd["dp"]),
            ("traceback_row", "traceback_pallas.py:227", err["tb"], 0,
             tot["tb"], tot["tb_plain"], bnd["tb"]),
            ("banded_sw_adiag", "banded_sw_adiag.py:375", err_a["adp"],
             err_e["adp"], tot_a["adp"], tot_a["adp_plain"], bnd_a["adp"]),
            ("traceback_adiag", "banded_sw_adiag.py:607", err_a["atb"], 0,
             tot_a["atb"], tot_a["atb_plain"], bnd_a["atb"]))
    kernels = []
    for name, tpu, e1, e2, ms, plain_ms, b in rows:
        by_ops = b["ops_ms"] > b["bytes_ms"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"lamsa_tpu_torch/csrc/{name}.cu",
            "replaces": f"lamsa_tpu/ops/{tpu}",
            "launches": launches[name], "max_abs_err": max(e1, e2),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": "operations" if by_ops else "bytes",
            "library_ms": None, "e2e_ms": e2e_ms[name],
            "kernel_ms": kernel_ms[name],
            "launches_mesh": launches_mesh[name],
            "launches_repeat": launches_repeat[name],
            "launches_card1": cards["launches_card1"][name] if cards
            else None,
            "launches_two_cards": two_cards["launches"][name] if two_cards
            else None,
            "launches_multihost": [p["launches"][name] for p in
                                   mh["one_card"][0]["processes"]],
            "launches_multihost_cards": [
                p["launches"][name] for p in mh["cards"][0]["processes"]]
            if "cards" in mh else None})
    log("kernels: ms / plain_ms / bound_ms = one call at each of the 9 "
        "buckets (B = CHUNK_BY_M, phase 2), summed; launches = the "
        "config-1 run of phase 3, launches_repeat = the repeat world of "
        "phase 3r, launches_mesh = that run over two "
        "entries of the card (phase 6a), launches_card1 = that run on "
        "cuda:1 alone (phase 6e) and launches_two_cards = over ['cuda:0', "
        "'cuda:1'] (phase 6a), null on one card; launches_multihost = "
        "each host_loop process's on cuda:0 (phase 6g, first run), "
        "launches_multihost_cards = each of one process per card's, null "
        "on one card; e2e_ms = the kernel's "
        "device time in "
        "one profiled config-1 pass; kernel_ms = its device time on the "
        "phase-2 work without the wrapper's launch and allocations "
        "(phase 2d, 9 buckets summed); library_ms null: no single PyTorch "
        "call computes a banded DP with direction bits or its walk")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
