"""Build the CUDA kernels from ``pycmf_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. Builds go
to ``pycmf_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.
Each build's compiler output (``-Xptxas -v``: registers, spills, shared
memory per kernel) is kept beside the library as ``<library>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NAMES = ("mu_fused", "newton_fused")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of pycmf_tpu_torch are built "
        "from source at first use on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, out: Path) -> list:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, float]:
    """Build every missing library (in parallel); return seconds per name
    (0.0 for one already built). Raises RuntimeError if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
        lib = _library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "wb")
        procs[name] = (subprocess.Popen(_compile_cmd(name, tmp), stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, lib, log, time.perf_counter())
    secs = {name: 0.0 for name in NAMES}
    failed = []
    for name, (proc, tmp, lib, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (see {lib.with_suffix('.log')}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """Compiler output of the current build of ``name`` ('' if none)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.pycmf_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.pycmf_workspace_floats.restype = ctypes.c_longlong
        lib.pycmf_error_string.argtypes = [ctypes.c_int]
        lib.pycmf_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.pycmf_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
