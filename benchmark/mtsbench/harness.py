"""One run of one cell: set-up, the measured window, the output check.

A traffic mix's `kind` names its driver, `drivers/<kind>.py`; each drives
the program's own calls (named in its file) in a closed loop for `seconds`,
records host spans around the calls into each layer and the work each
launch does, and keeps what the window produced for the check. The check
runs after the window has closed, the peak memory has been read and the
program's state is freed: the plain reference (`benchmark/reference`) works
the same answers out again from the inputs and weights this harness made,
and each number compared is held to its limit (`limits/<cell>.json`).
`run_cell(control=True)` (for `calibrate.py`) puts the reference, computed
with TF32 products, in the program's place: the configurations state
float32 with TF32 off, and that control has to fail.
"""
from __future__ import annotations

import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import trace
from .spec import Cell, architecture, driver as driver_class, read_metrics

SR = 16000


class Run:
    """What a window did, for the metric readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.t0 = None
        self.completions: List[tuple] = []  # (host time, units, model FLOPs)
        self.spans: Dict[str, float] = {}    # name -> host seconds inside the window's loop
        self.span_units: Dict[str, int] = {}
        self.loop_end = None
        self._work: Dict[str, list] = {}  # kernel -> [(fn, args)] per launch, worked out on demand
        self.launches: Dict[str, int] = {}             # program counters over the window
        self.samples: Dict[str, List[float]] = {}  # name -> one reading per work item
        self.timeline: Optional[trace.Timeline] = None
        self.attempted = 0

    def add_span(self, name: str, seconds: float, units: int = 0):
        self.spans[name] = self.spans.get(name, 0.0) + seconds
        self.span_units[name] = self.span_units.get(name, 0) + units

    def add_sample(self, name: str, value: float):
        self.samples.setdefault(name, []).append(value)

    def add_work(self, kernel: str, fn, *args):
        """One launch of `kernel`, whose (operations, bytes) are fn(*args): worked
        out after the window, so that the window pays no host time for it."""
        self._work.setdefault(kernel, []).append((fn, args))

    def work(self, kernel: str) -> List[tuple]:
        """[(operations, bytes)] of each recorded launch of `kernel`."""
        cache: dict = {}
        out = []
        for fn, args in self._work.get(kernel, []):
            key = (fn, repr(args))
            if key not in cache:
                cache[key] = fn(*args)
            out.append(cache[key])
        return out

    # -- what the end-to-end metrics and readers use --------------------------------
    def in_window(self) -> List[tuple]:
        return [c for c in self.completions if c[0] <= self.t0 + self.seconds]

    def rate(self) -> Optional[float]:
        done = self.in_window()
        if not done:
            return None
        return sum(c[1] for c in done) / (done[-1][0] - self.t0)

    def loop_s(self) -> float:
        """Host seconds from the window's start to the end of the last work item."""
        return self.loop_end - self.t0

    def flops_all(self) -> float:
        return sum(c[2] for c in self.completions)


def _counters() -> Dict[str, int]:
    """The program's launch counters: every function of its `ops` modules that
    carries a `launches` count, as "<module>.<function>"."""
    import importlib
    import pkgutil

    from multimodaltopicsegmentation_torch import ops

    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, obj in vars(module).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int):
                out[f"{info.name}.{name}"] = obj.launches
    return out


def sync(device):
    """Waits for the device's queue to drain (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tagger_config(tagger: dict):
    """The program's TaggerConfig of a configuration's `tagger`: every field
    the configuration names, its `dropout` on the input and the output."""
    import dataclasses

    from multimodaltopicsegmentation_torch.models.base import TaggerConfig

    fields = {f.name for f in dataclasses.fields(TaggerConfig)}
    given = {k: v for k, v in tagger.items() if k in fields}
    return TaggerConfig(**given, dropout_in=tagger["dropout"], dropout_out=tagger["dropout"])


def gap_rel(a: np.ndarray, b: np.ndarray) -> float:
    """Worst row's ||a - b|| / ||b||."""
    num = np.linalg.norm(a.astype(np.float64) - b, axis=-1)
    den = np.maximum(np.linalg.norm(b.astype(np.float64), axis=-1), 1e-30)
    return float((num / den).max())


class Driver:
    """A traffic mix's driver (`drivers/<kind>.py` subclasses it): `setup`,
    `window(run)`, `free_program`, `check(run, control, fault)` -> [(name,
    value, limit)], and `prepare_inputs` (all that `check` needs when the
    reference takes the program's place)."""

    def __init__(self, cell: Cell, seed: int, device, tmp: str):
        self.cell, self.seed, self.device, self.tmp = cell, seed, torch.device(device), tmp
        self.config, self.traffic = cell.config, cell.traffic
        self.tagger_cfg = cell.config["tagger"]
        self.arch = architecture(self.tagger_cfg["architecture"])
        self.phases: Dict[str, float] = {}  # set-up's steps, host seconds, for standard error
        self.notes: Dict[str, object] = {}  # what the check found worth a line on standard error
        self._t_phase = time.perf_counter()

    def phase(self, name: str):
        """Ends one step of set-up (after the device's queue has drained)."""
        sync(self.device)
        t = time.perf_counter()
        self.phases[name] = t - self._t_phase
        self._t_phase = t

    def prepare_inputs(self):
        """The inputs the check needs, made from the seed (no program)."""
        raise NotImplementedError

    def build_kernels(self, names):
        """Builds (or finds built) the program's kernel libraries `names`."""
        if self.device.type == "cuda" and names:
            from multimodaltopicsegmentation_torch.core import cuda_build

            cuda_build.build_all(tuple(names))


# ---------------------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_process: float = None, control: bool = False, fault: str = None) -> dict:
    """One run -> the result object of the benchmark's last line (less the
    device's name, which the caller adds). `control` and `fault` put the
    reference in the program's place, with TF32 products or with a planted
    fault ("half_batch": the mean over half of each batch's documents), to
    read what the check's numbers give for them; no window runs."""
    t_process = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="mtsbench-")
    try:
        return _run(cell, seed, seconds, traced, device, t_process, control, fault, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, t_process, control, fault, tmp):
    from multimodaltopicsegmentation_torch.core.torch_setup import setup as port_setup

    port_setup()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver = driver_class(cell.traffic["kind"])(cell, seed, device, tmp)
    t_start = time.perf_counter()
    if control or fault:  # the reference takes the program's place: only the inputs
        driver.prepare_inputs()
    else:
        driver.setup()
    sync(device)
    run = Run(cell, seed, seconds, traced)
    before = _counters()
    if traced:  # a mix may trace a shorter window than it measures
        run.seconds = min(seconds, cell.traffic.get("trace_seconds", seconds))
    with trace.capture(traced) as prof, trace.span(trace.WINDOW, traced):
        run.t0 = time.perf_counter()
        setup_s = run.t0 - t_process
        if not (control or fault):
            driver.window(run)
        sync(device)
        run.loop_end = time.perf_counter()
    after = _counters()
    t_window_end = time.perf_counter()
    run.launches = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    driver.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        run.timeline = trace.Timeline(prof)
    t_trace = time.perf_counter()
    checks = driver.check(run, control, fault)
    t_check = time.perf_counter()
    phases = ", ".join(f"{k} {v:.3f}" for k, v in driver.phases.items())
    print(f"[mtsbench] setup {setup_s:.3f} s (start {t_start - t_process:.3f}, {phases}), window {run.loop_end - run.t0:.3f} s, "
          f"profiler stop {t_window_end - run.loop_end:.3f} s, "
          f"trace read {t_trace - t_window_end:.3f} s, check {t_check - t_trace:.3f} s, "
          f"{run.attempted} attempted, {len(run.in_window())} done in the window, "
          f"launches {({k: v for k, v in run.launches.items() if v})}", file=sys.stderr)
    spans = ", ".join(f"{k} {v:.3f}" for k, v in run.spans.items())
    print(f"[mtsbench] spans (s): {spans}", file=sys.stderr)
    for key, value in driver.notes.items():
        print(f"[mtsbench] {key}: {value}", file=sys.stderr)
    correct = all(np.isfinite(v) and v <= limit for _, v, limit in checks)
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": 0, "metrics": {}, "device": {"count": 1, "memory_peak_bytes": int(peak)}}
    if not (control or fault):
        if traced:
            result["metrics"] = read_metrics(cell.per_layer, run)
            tl = run.timeline
            result["device"].update({"busy_s": tl.busy_s, "window_s": run.loop_s()})
            result["breakdown"] = {"device_ops": tl.top_ops(10), "idle_gaps": tl.idle_gaps(10)}
        else:
            result["metrics"] = {m["name"]: {"value": float(setup_s), "unit": m["unit"]}
                                 for m in cell.end_to_end if m["name"] == "setup_s"}
            result["metrics"].update(read_metrics(
                [m for m in cell.end_to_end if m["name"] != "setup_s"], run))
    result["checks"] = {name: {"value": float(v), "limit": float(limit)}
                        for name, v, limit in checks}
    return result
