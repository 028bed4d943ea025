"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``bigdl_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  Every source gets :data:`NVCC_FLAGS`, and some get
extra flags of their own (:data:`EXTRA_FLAGS`).  The library's file name
carries a hash of its source, of every header under ``csrc/`` (which a
source may include) and of its flags, so an edited source or header or a
changed flag is rebuilt and an unchanged one is loaded as it is.
Nothing is built when a module is imported: :func:`load` runs inside the
wrapper that launches the kernel.  ``nvcc`` prints each kernel's
registers and shared memory (``-Xptxas -v``) into a ``.log`` beside the
library.

Each wrapper counts its launches here, one count per kernel name
(:func:`count_launch`), so that a run can show which kernels its main
path went through.

The port's native host runtime (``bigdl_tpu_torch/native/src/*.cpp``:
crc32c, the prefetching record ring, batched image prep) is built by the
same machinery with ``g++`` into ``build/native/``
(:func:`build_native`), one library over the three sources, named after
their hash and the flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "src"
NATIVE_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
NATIVE_SOURCES = ("crc32c", "prefetch", "imageprep")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# fused_adam, fused_sgd: no FMA contraction, so that every multiply and add
# rounds on its own as in the plain PyTorch version (IEEE / and sqrt are
# nvcc's default and stay on).  flash_fwd and flash_bwd keep nvcc's default
# contraction: they are held to a tolerance, not bitwise.
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"fused_adam": ("-fmad=false",),
                                           "fused_sgd": ("-fmad=false",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_launches: Dict[str, int] = {}


def count_launch(kernel: str) -> None:
    """Add one to ``kernel``'s count; a wrapper calls it once for every
    launch of its kernel, and nowhere else."""
    with _count_lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> Dict[str, int]:
    """``{kernel: launches}`` since the last :func:`reset_launch_counts`."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        _launches.clear()


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


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _spawn(out: Path, compiler: list, sources: list):
    """Start ``compiler -o <tmp> sources`` with its output in a ``.log``
    beside ``out``; returns the job :func:`_finish` completes."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*compiler, "-o", str(tmp), *map(str, sources)]
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return proc, tmp, log


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns ``(target, job or None)``."""
    out = _target(name)
    if out.exists():
        return out, None
    return out, _spawn(out, [_nvcc(), *_flags(name)],
                       [CSRC / f"{name}.cu"])


def _finish(what: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp, log = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        tail = out.with_suffix(".log").read_text()[-4000:]
        raise RuntimeError(f"{what} failed (rc={rc}):\n{tail}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source at once (one ``nvcc`` each, all started
    together) and return the library paths."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, (out, job) in jobs.items():
            _finish(f"nvcc for csrc/{n}.cu", out, job)
    return {n: out for n, (out, _) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(f"nvcc for csrc/{name}.cu", out, job)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def build_log(name: str) -> str:
    """What ``nvcc`` printed for the current build of ``name`` ('' when
    the library was already there)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def native_target() -> Path:
    """The native runtime's library: its name hashes the sources and
    :data:`CXX_FLAGS`."""
    h = hashlib.sha256()
    for name in NATIVE_SOURCES:
        h.update(name.encode() + b"\0"
                 + (NATIVE_SRC / f"{name}.cpp").read_bytes())
    h.update("\0".join(CXX_FLAGS).encode())
    return NATIVE_DIR / f"libbigdl_torch_rt_{h.hexdigest()[:16]}.so"


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's native runtime is "
                           "built from source at first use")
    return found


def build_native() -> Path:
    """Compile ``native/src/*.cpp`` with ``g++`` unless the library
    exists; returns its path.  A failed build raises: the port has no
    Python stand-in for its native runtime."""
    out = native_target()
    with _lock:
        if not out.exists():
            job = _spawn(out, [_gxx(), *CXX_FLAGS],
                         [NATIVE_SRC / f"{n}.cpp" for n in NATIVE_SOURCES])
            _finish("g++ for native/src", out, job)
    return out
