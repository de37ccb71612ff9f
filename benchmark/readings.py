#!/usr/bin/env python3
"""The readings the limits of limits/<cell>.json are set from.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 30 [--control | --fault half_batch|stale|altered]

Runs the cell as run.py does (untraced), once per seed, each seed
with its own order of the pool's batches and its own sample, and prints one JSON line per run with the numbers
the check compares. With --control the program is the control: the
configuration's scores with the DP's gap-open term dropped (a linear-gap
DP, one state instead of three: the cheaper recurrence a later change
could be tempted by), which breaks the configuration's guarantee that AS
and the CIGARs are those of its affine scores. The reference judges by
the configuration as it stands. With --fault the program runs as the
configuration states with a fault of faults.py planted under it. Needs
the card, as run.py does.
"""

import copy
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def control_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["align"]["scores"]["gap_open"] = 0
    return c


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = run.Cell(a.workload)
    side = "control" if a.control else a.fault or "program"
    pc = control_config(cell.config) if a.control else None

    def log(msg):
        print(f"[readings {cell.name} {side}] {msg}", file=sys.stderr,
              flush=True)

    for seed in (int(s) for s in a.seeds.split(",")):
        res, _lines = run.run_cell(cell, seed, a.seconds, False,
                                   program_config=pc, log=log,
                                   fault=FAULTS.get(a.fault))
        print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                          "attempted": res["attempted"],
                          "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
