"""Build the package's CUDA kernels with nvcc, at first use.

Every `kernels/<name>/csrc/<name>.cu` becomes its own shared library with a
plain C interface, compiled for sm_90a into `build/kernels/` at the root of
the checkout and loaded with ctypes. The library's file name carries a hash
of its sources and flags, so an edited source is rebuilt and a stale
library is never loaded. `build_all()` starts one nvcc per source, all at
once. A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
INCLUDE_DIR = KERNELS_DIR / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Build:
    name: str
    library: Path
    seconds: float        # wall time of this process's nvcc; 0 if cached
    log: str              # nvcc's output (the -Xptxas -v lines)


def sources() -> dict[str, Path]:
    """Kernel name -> its .cu source, for every kernel of the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of repro_torch are built from source at first use")


def build_all(names=None) -> dict[str, Build]:
    """Compile the named kernels (default: all) that are not built yet.

    One nvcc process per source, started together and all waited for.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no CUDA source for kernel(s) {unknown}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Build] = {}
    running = []
    for n in names:
        lib = _library_path(srcs[n])
        if lib.exists():
            out[n] = Build(n, lib, 0.0, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", str(tmp),
               str(srcs[n])]
        t0 = time.perf_counter()  # simlint: ok[DET002]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((n, lib, tmp, proc, t0))
    failures = []
    for n, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0  # simlint: ok[DET002]
        if proc.returncode != 0:
            failures.append(f"--- nvcc for {n} exited {proc.returncode}:\n"
                            f"{log}")
            continue
        os.replace(tmp, lib)
        out[n] = Build(n, lib, secs, log)
    if failures:
        raise RuntimeError("building the CUDA kernels failed\n"
                           + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LOADED:
        lib = build_all([name])[name].library
        _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]
