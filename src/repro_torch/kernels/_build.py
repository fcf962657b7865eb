"""Builds the CUDA sources of this package with nvcc and loads them by ctypes.

Each kernel family has one source under ``<family>/csrc/`` with a plain C
interface (no PyTorch headers), compiled for Hopper into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<family>-<hash>.so <family>/csrc/<source>.cu

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and never loaded stale.  Builds go to ``kernels/build/``
beside this file (listed in ``.gitignore``) at the first use of any;
:func:`build_all` starts one nvcc per source at once.  No ``--use_fast_math``: the kernels'
``d + w`` must round exactly like the plain version's.

nvcc runs with ``-Xptxas -v``; what it reports (registers, shared memory and
spills of each kernel) is kept beside the library, :func:`build_log`.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.knobs import count_build

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
SOURCES = {
    "minplus": KERNELS_DIR / "minplus" / "csrc" / "minplus.cu",
    "segmin": KERNELS_DIR / "segmin" / "csrc" / "segmin.cu",
    "mst": KERNELS_DIR / "mst" / "csrc" / "prim.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: "dict[str, ctypes.CDLL]" = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def _lib_path(family: str) -> Path:
    src = SOURCES[family]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{family}-{digest.hexdigest()[:12]}.so"


def _start(family: str):
    """Starts nvcc for ``family`` unless its library exists; returns the
    (process, tmp path, final path) or None."""
    out = _lib_path(family)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[family])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(family: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {family} ({proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all() -> None:
    """Compiles every source that has no current library, one nvcc each,
    all started together."""
    jobs = {fam: _start(fam) for fam in SOURCES}
    for fam, job in jobs.items():
        _finish(fam, job)


def build_log(family: str) -> str:
    """What nvcc printed when it built the current library of ``family``
    ("" if it was not built from this checkout)."""
    log = _lib_path(family).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(family: str) -> ctypes.CDLL:
    """The loaded library of ``family``; if it has none yet, every family
    without one is built first, all at once, so a checkout's first run
    pays one build and not one a family."""
    lib = _libs.get(family)
    if lib is None:
        if not _lib_path(family).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(family)))
        _libs[family] = lib
        count_build("library")
    return lib


def check(rc: int, what: str) -> None:
    """Raises if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
