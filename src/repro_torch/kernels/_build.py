"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, on first use, and loaded
with ``ctypes``. Libraries land in ``build/kernels/`` at the root of the
checkout, named by a digest of their sources and flags, so an edited
source is rebuilt and concurrent builders never see a half-written file.

No fallback: a missing ``nvcc`` or a failed build raises. The kernels'
plain PyTorch versions run only for tensors on the CPU, and that choice
is the wrappers', made from the tensor's device, never here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_HEADERS = ("common.cuh", "sm90.cuh")
# Passed to every build but not part of a library's name: they change
# what nvcc reports, not what it builds.
REPORT_FLAGS = ("-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# What nvcc (and ptxas: registers, spills) reported for each library
# built by this process.
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built. CUDA "
        "tensors need the kernels; pass CPU tensors (device='cpu') for "
        "the plain PyTorch path")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Raises on any failure."""
    names = list(names)
    targets = [library_path(n) for n in names]
    todo = [(n, t) for n, t in zip(names, targets) if not t.exists()]
    if not todo:
        return targets
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, t in todo:
        tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *REPORT_FLAGS, "-I", str(CSRC), "-o",
               str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, t, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, t, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            BUILD_LOG[n] = out
            os.replace(tmp, t)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library for ``name`` (built on first use);
    ``declare(lib)`` sets its functions' argtypes/restype once."""
    lib = _LIBS.get(name)
    if lib is None:
        path, = build([name])
        lib = ctypes.CDLL(str(path))
        declare(lib)
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
