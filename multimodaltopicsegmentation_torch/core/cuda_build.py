"""Build the package's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library under `build/torch_kernels/`
at the repository root (listed in .gitignore). The file name carries a hash
of the source, the `csrc/*.cuh` headers and the flags, so an edited source
builds anew and an unchanged one is loaded as it is. Nothing is built when a
module is imported: `load` runs inside the wrappers that launch a kernel, and
`build_all` lets a caller start every build at once, one `nvcc` per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("instance_norm_gelu", "flash_local_attention", "flash_local_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH and CUDA_HOME): the CUDA kernels of "
        "multimodaltopicsegmentation_torch are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the headers a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    lib = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, lib: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a reader sees the old file or the new one, never half
    return log


def build_all(names=KERNELS) -> Dict[str, Tuple[float, str]]:
    """Build every kernel not yet built, all `nvcc`s started together.
    -> {name: (seconds, nvcc log)}; an already built kernel reports (0.0, "")."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if not library_path(n).exists()}
    out = {n: (0.0, "") for n in names}
    for n, job in started.items():
        log = _finish(n, *job)
        out[n] = (time.perf_counter() - t0, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed (needs nvcc)."""
    if name not in _loaded:
        if not library_path(name).exists():
            build_all((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
