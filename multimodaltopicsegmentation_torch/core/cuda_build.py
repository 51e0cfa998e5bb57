"""Build the package's native libraries at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library under `build/torch_kernels/`
at the repository root (listed in .gitignore). The host libraries
(`HOST_LIBRARIES`, `csrc/<name>.cpp`: the native audio loader) are compiled
the same way by the host's C++ compiler with the JAX package's runtime flags
(`HOST_FLAGS`), less `-fopenmp` where the compiler has no OpenMP runtime
(`host_flags`: the pragmas are then ignored and the loops run on one thread,
with the same results). The file name carries a hash of the source, the
`csrc/*.cuh` headers and the flags (for a host library, also what
`-march=native` means on this CPU, so that a build copied to another machine
is not loaded there), so an edited source builds anew and an unchanged one is
loaded as it is. Nothing is built when a module is imported: `load` runs
inside the wrappers that launch a kernel or read a file, and `build_all`
lets a caller start every build at once, one compiler per source. A failed
build raises with the compiler's log.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("instance_norm_gelu", "flash_local_attention", "flash_local_attention_bwd",
           "linear_tf32x3", "conv_tf32x3")
HOST_LIBRARIES = ("audio_native",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_host = {}  # the host compiler's flags and target, probed once


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


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found:
        return found
    raise RuntimeError(
        "no C++ compiler found (g++ or c++ on PATH): the native audio loader of "
        "multimodaltopicsegmentation_torch is built from csrc/audio_native.cpp at first use"
    )


def _probe(*args) -> str:
    proc = subprocess.run([_cxx(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{_cxx()} {' '.join(args)} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def host_flags() -> Tuple[str, ...]:
    """HOST_FLAGS, less -fopenmp when the compiler finds no libgomp.spec (an
    installation without the OpenMP runtime)."""
    if "flags" not in _host:
        omp = os.path.isabs(_probe("-print-file-name=libgomp.spec").strip())
        _host["flags"] = tuple(f for f in HOST_FLAGS if omp or f != "-fopenmp")
    return _host["flags"]


def _march_native() -> str:
    """The target options `-march=native` selects on this CPU."""
    if "target" not in _host:
        _host["target"] = _probe("-march=native", "-Q", "--help=target")
    return _host["target"]


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_LIBRARIES else f"{name}.cu")


def library_path(name: str) -> Path:
    source = _source(name)
    digest = hashlib.sha256(source.read_bytes())
    if name in HOST_LIBRARIES:
        digest.update(" ".join(host_flags()).encode())
        digest.update(_march_native().encode())
    else:
        for header in sorted(CSRC.glob("*.cuh")):  # the headers a source may include
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    lib = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    compiler = [_cxx(), *host_flags()] if name in HOST_LIBRARIES else [_nvcc(), *NVCC_FLAGS]
    cmd = [*compiler, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, lib: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        compiler = os.path.basename(proc.args[0])
        raise RuntimeError(f"{compiler} failed for csrc/{_source(name).name}:\n{log}")
    os.replace(tmp, lib)  # atomic: a reader sees the old file or the new one, never half
    return log


def build_all(names=KERNELS) -> Dict[str, Tuple[float, str]]:
    """Build every library not yet built, all compilers started together.
    -> {name: (seconds, compiler log)}; an already built one reports (0.0, "")."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if not library_path(n).exists()}
    out = {n: (0.0, "") for n in names}
    for n, job in started.items():
        log = _finish(n, *job)
        out[n] = (time.perf_counter() - t0, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed (needs nvcc, or a C++ compiler
    for a host library). Threads that ask for a library not loaded yet take
    turns, so that it is built once (its temporary file is named by the
    process)."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            if name not in _loaded:
                if not library_path(name).exists():
                    build_all((name,))
                _loaded[name] = ctypes.CDLL(str(library_path(name)))
            lib = _loaded[name]
    return lib
