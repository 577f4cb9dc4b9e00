"""Benchmark timing helper.

PyTorch counterpart of ``pyneuralempc_tpu/utils/timing.py``.  A CUDA launch
returns before the card has run it, so :func:`time_fn` synchronises the
device after every call, before it reads the clock.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Wall time of ``fn(*args, **kwargs)``: p50/mean/min/max seconds a
    call, each call timed to the end of its device work."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {"p50": float(np.median(ts)), "mean": float(ts.mean()),
            "min": float(ts.min()), "max": float(ts.max()),
            "iters": iters}
