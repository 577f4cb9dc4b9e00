"""Carry model weights across from the JAX package.

The JAX package keeps MLP params as a list of ``{"w": (in, out),
"b": (out,)}`` arrays, the same layout as the port's, and its recurrent
models (:mod:`.rnn`) as dicts of arrays (a stacked LSTM's with a
``"layers"`` list of dicts), again in the port's layout.  After
``np.asarray`` on each leaf they arrive here as numpy arrays;
:func:`mlp_params_from_numpy` and :func:`params_from_numpy` make the port's
tensors from them, so both packages compute with the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """A tree of dicts and lists with numpy leaves (any params layout of
    the JAX package: MLP layer lists, GRU/LSTM/Keras-GRU dicts, the stacked
    LSTM's ``{"layers": [...], "wo", "bo"}``) -> the same tree of
    tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def mlp_params_from_numpy(params, device="cuda", dtype=torch.float32):
    """List of ``{"w", "b"}`` numpy arrays -> list of dicts of tensors."""
    return params_from_numpy(list(params), device, dtype)
