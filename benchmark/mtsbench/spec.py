"""What a cell is made of, found by name.

`BENCHMARK.json` (at the checkout's root) names each cell's configuration and
traffic mix and each metric. The harness finds the rest by those names:

- a configuration: the file its entry names (`configs/<name>.json`);
- a traffic mix: `traffic/<name>.json`, parameters that `traffic.py` reads;
  its `kind` names the driver, `drivers/<kind>.py` (class `Driver`);
- a tagger architecture (the configuration's `tagger.architecture`):
  `architectures/<name>.py`, what the harness counts for it, and
  `reference/taggers/<name>.py`, its plain reference;
- a metric, end-to-end or per-layer: `metrics/<name>.py`, whose `read(run)`
  returns the number or None when the run has nothing for it to read
  (`setup_s` alone is the harness's own);
- the output check's limits: `limits/<cell>.json`.

A later change adds a cell, a mix, an architecture, a driver or a metric by
adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the metrics the untraced run reports
    per_layer: List[dict]   # the metrics the traced run reports
    limits: Dict[str, float]  # the output check's, `limits/<cell>.json`


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    bench = bench or load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    traffic = load_traffic(w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in reported]
    return Cell(name, w["config"], w["traffic"], w["chips"], config, traffic, e2e, per_layer,
                load_limits(name))


def load_limits(cell_name: str) -> Dict[str, float]:
    with open(os.path.join(BENCH_DIR, "limits", f"{cell_name}.json")) as f:
        return json.load(f)["limits"]


def load_traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


_MODULES: Dict[str, object] = {}


def _module(folder: str, name: str, what: str):
    """The module `<folder>/<name>.py` under the benchmark (the name may hold
    dots), loaded once; a ValueError naming the file when there is none."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    if path not in _MODULES:
        if not os.path.exists(path):
            raise ValueError(f"no {what} {name!r}: {os.path.relpath(path, ROOT)} is missing")
        spec = importlib.util.spec_from_file_location(
            f"mtsbench_{folder}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def metric_reader(name: str):
    """`read` of `metrics/<name>.py`."""
    return _module("metrics", name, "metric").read


def driver(kind: str):
    """The `Driver` class of `drivers/<kind>.py`."""
    return _module("drivers", kind, "driver").Driver


def architecture(name: str):
    """The harness's module of a tagger architecture, `architectures/<name>.py`."""
    return _module("architectures", name, "architecture")


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found something."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
