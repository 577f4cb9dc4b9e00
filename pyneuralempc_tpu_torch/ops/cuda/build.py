"""Build the package's CUDA sources at first use and load them with ctypes.

Each source under ``pyneuralempc_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface, in
``pyneuralempc_tpu_torch/_build/``.  The library's file name carries a hash
of the source and the flags, so an edited source builds anew and an
unchanged one loads from the build directory.  Nothing here runs at import
time: the CPU tests import this module on machines without ``nvcc``.
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
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float     # wall time of the nvcc run (0 when loaded as built)
    log: str           # nvcc's output (ptxas register/spill report)


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``, the toolkit's standard prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels build only where the CUDA toolkit "
                       "is installed")


def library_path(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where ``source`` builds to: its stem plus a hash of its bytes and
    the flags."""
    h = hashlib.sha256(Path(source).read_bytes()
                       + "\0".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{h}.so"


def nvcc_command(nvcc: str, source: Path, out: Path,
                 flags: Sequence[str] = NVCC_FLAGS) -> List[str]:
    return [nvcc, *flags, "-o", str(out), str(source)]


def build(source: Path) -> BuildResult:
    """Build ``source`` unless it is built already.  Raises with nvcc's
    output if the build fails."""
    out = library_path(source)
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(find_nvcc(), source, tmp),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)      # atomic: a loader never sees half a library
    return BuildResult(out, seconds, proc.stdout)


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(source_name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source_name>``, built on first use.
    Later calls return the loaded library without touching the disk."""
    lib = _LOADED.get(source_name)
    if lib is None:
        lib = ctypes.CDLL(str(build(CSRC_DIR / source_name).path))
        _LOADED[source_name] = lib
    return lib
