"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``bigdl_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The library's file name carries a hash of its source,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when a module is imported: :func:`load` runs inside the
wrapper that launches the kernel.  ``nvcc`` prints each kernel's
registers and shared memory (``-Xptxas -v``) into a ``.log`` beside the
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns ``(target, process or None)``."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return out, (proc, tmp, log)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp, log = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        tail = out.with_suffix(".log").read_text()[-4000:]
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n"
                           f"{tail}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source at once (one ``nvcc`` each, all started
    together) and return the library paths."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, (out, job) in jobs.items():
            _finish(n, out, job)
    return {n: out for n, (out, _) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(name, out, job)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def build_log(name: str) -> str:
    """What ``nvcc`` printed for the current build of ``name`` ('' when
    the library was already there)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
