"""Rollouts and multiple-shooting defects.

PyTorch counterpart of ``pyneuralempc_tpu/ops/rollout.py``:

* :func:`defects` — the NLP equality residuals ``c_t = Φ(x_{t-1}, u_t) - x_t``
  where every ``x_{t-1}`` comes from the decision vector (``x_0`` from the
  runtime data): one batched model call over all stages.
* :func:`simulate` — a sequential rollout, a Python loop over the horizon
  (the JAX package's ``lax.scan``), used for the cold-start initialiser.
"""

from __future__ import annotations

from typing import Callable

import torch


def shift_states(x0, X):
    """``x_prev[t] = x0 if t == 0 else X[t-1]``, on the last two axes (so a
    leading batch axis rides along)."""
    return torch.cat([x0.unsqueeze(-2), X[..., :-1, :]], dim=-2)


def defects(phi: Callable, X, U, x0, p=None, tvp=None, params=None):
    """Multiple-shooting defect residuals, shape (H, x_dim)."""
    x_prev = shift_states(x0, X)
    return phi(x_prev, U, p, tvp, params) - X


def simulate(phi: Callable, x0, U, p=None, tvp=None, params=None):
    """Sequential rollout: apply Φ one step at a time over U.

    ``x0`` is (x_dim,) or (B, x_dim) and ``U`` (H, u_dim) or (B, H, u_dim);
    ``p``/``tvp``/``params`` are shared.  A batch rides as the model's row
    axis (rows are independent stages).  Returns X with X[t] = x_{t+1},
    shape (H, x_dim) or (B, H, x_dim).
    """
    single = x0.dim() == 1
    x = x0.reshape(-1, x0.shape[-1])
    Us = U.reshape(x.shape[0], U.shape[-2], U.shape[-1])
    xs = []
    for t in range(Us.shape[1]):
        tvp_t = (None if tvp is None
                 else tvp[t].expand(x.shape[0], tvp.shape[-1]))
        x = phi(x, Us[:, t], p, tvp_t, params).to(x.dtype)
        xs.append(x)
    X = torch.stack(xs, dim=1)
    return X[0] if single else X
