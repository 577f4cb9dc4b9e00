"""Build the package's CUDA sources at first use and load them with ctypes.

Each source under ``pyneuralempc_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface, in
``pyneuralempc_tpu_torch/_build/``.  The library's file name carries a hash
of the source, the flags and the headers beside the sources (``*.cuh``), so
an edited source or header builds anew and an unchanged one loads from the
build directory.  :func:`build_all` starts one ``nvcc`` for each source at
once.  Nothing here runs at import time: the CPU tests import this module
on machines without ``nvcc``.
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
    """Where ``source`` builds to: its stem plus a hash of its bytes, the
    flags, and the names and bytes of every header in ``CSRC_DIR`` (a
    source may include any of them)."""
    h = hashlib.sha256(Path(source).read_bytes()
                       + "\0".join(flags).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, source: Path, out: Path,
                 flags: Sequence[str] = NVCC_FLAGS) -> List[str]:
    return [nvcc, *flags, "-o", str(out), str(source)]


def build_all(sources: Sequence) -> List[BuildResult]:
    """Build every source that is not built already, one ``nvcc`` for each,
    all started together.  A source is a path, or a (path, extra nvcc
    flags) pair.  Raises with nvcc's output if a build fails (after every
    build has ended)."""
    results: List[BuildResult] = [None] * len(sources)
    running = []
    for n, item in enumerate(sources):
        source, extra = item if isinstance(item, tuple) else (item, ())
        flags = NVCC_FLAGS + tuple(extra)
        out = library_path(source, flags)
        if out.exists():
            results[n] = BuildResult(out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(find_nvcc(), source, tmp, flags),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((n, source, out, tmp, proc, time.perf_counter()))
    failed = []
    try:
        for n, source, out, tmp, proc, t0 in running:
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source.name} "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)   # atomic: a loader never sees half a library
            results[n] = BuildResult(out, time.perf_counter() - t0, log)
    finally:
        for *_, proc, _t0 in running:   # none outlives a failed build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build(source: Path) -> BuildResult:
    """Build ``source`` unless it is built already (see :func:`build_all`)."""
    return build_all([source])[0]


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(source_name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source_name>``, built on first use.
    Later calls return the loaded library without touching the disk."""
    lib = _LOADED.get(source_name)
    if lib is None:
        lib = ctypes.CDLL(str(build(CSRC_DIR / source_name).path))
        _LOADED[source_name] = lib
    return lib
