#!/usr/bin/env python3
"""Readings for the output check's limits, many seeds in one process.

    python benchmark/calibrate.py --workload <cell> --mode program --seconds 3 --seeds 11,12,13
    python benchmark/calibrate.py --workload <cell> --mode control --seeds 21,22,23
    python benchmark/calibrate.py --workload <cell> --mode half_batch --seeds 31,32,33

`program` runs the cell as `run.py` does, with a short window at the cell's
own sizes, and reads what its check compares (the lower readings); `control`
puts the reference with TF32 products in the program's place, `half_batch`
the reference with the mean taken over half of each batch (training cells):
their readings are the upper ones. One JSON line per seed on standard
output. Set-up is paid once per seed, the process start once.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "control", "half_batch"), required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from mtsbench import harness, spec

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                             control=args.mode == "control",
                             fault=args.mode if args.mode == "half_batch" else None)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
