"""Carry MLP weights across from the JAX package.

The JAX package keeps MLP params as a list of ``{"w": (in, out),
"b": (out,)}`` arrays, the same layout as the port's.  After ``np.asarray``
on each leaf they arrive here as numpy arrays; :func:`mlp_params_from_numpy`
makes the port's tensors from them, so both packages compute with the same
weights.
"""

from __future__ import annotations

import numpy as np
import torch


def mlp_params_from_numpy(params, device="cuda", dtype=torch.float32):
    """List of ``{"w", "b"}`` numpy arrays -> list of dicts of tensors."""
    return [{k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
             for k, v in layer.items()} for layer in params]
