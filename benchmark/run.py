#!/usr/bin/env python3
"""The benchmark of multimodaltopicsegmentation_torch on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. One run: set-up (load, weights and inputs
made on the card from --seed, the cell's shapes warmed up), a window of
--seconds driving the program's own calls, the output check against the
plain reference, and one JSON line on standard output (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`, and
last the numbers the check compared, each beside its limit). With --trace 0
the metrics are the cell's end-to-end metrics, with --trace 1 its per-layer
ones, read from a torch.profiler trace of the window.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when the process has loaded JAX or the JAX
package by the end of the window.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodaltopicsegmentation_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from mtsbench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"error: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    device.update(result["device"])
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = result["checks"]
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
