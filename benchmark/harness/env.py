"""The run's environment, set before torch is imported: every build and
kernel cache of the program at a fixed path inside the checkout
(``benchmark/_cache/``), and no library loading JAX or Flax by itself."""

import os
from pathlib import Path

CACHES = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TRITON_CACHE_DIR", "triton"),
          ("CUDA_CACHE_PATH", "cuda"),
          ("NEMPC_COMPILE_CACHE", "nvcc"))


def cache_dir(root) -> Path:
    return Path(root) / "benchmark" / "_cache"


def setup(root) -> Path:
    cache = cache_dir(root)
    for var, sub in CACHES:
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    return cache
