"""Where the CUDA kernels' builds are kept.

PyTorch counterpart of ``pyneuralempc_tpu/utils/compile_cache.py``.  The
JAX package turns on XLA's persistent compilation cache; the port compiles
its CUDA sources with ``nvcc`` at first use into a build directory, keyed
by a hash of the source, the flags and the headers (:mod:`..ops.cuda.
build`), so that cache already persists.  :func:`enable_compilation_cache`
only points it at another directory.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..ops.cuda import build


def enable_compilation_cache(cache_dir: str | None = None,
                             min_compile_time_secs: float = 1.0) -> str:
    """Keep the kernels' builds in ``cache_dir`` (default
    ``$NEMPC_COMPILE_CACHE``, else the package's ``_build/``) and return
    the directory.  Libraries loaded already stay loaded.

    ``min_compile_time_secs`` is accepted for the JAX package's signature
    and ignored: XLA persists only the compiles slower than it, while
    every nvcc build is kept, keyed by the hash of its source, flags and
    headers, however long it took."""
    cache_dir = (cache_dir or os.environ.get("NEMPC_COMPILE_CACHE")
                 or str(build.BUILD_DIR))
    build.BUILD_DIR = Path(cache_dir)
    return cache_dir
