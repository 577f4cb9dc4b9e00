"""Surrogate fitting: train an MLP dynamics model on a ground-truth system.

PyTorch counterpart of ``sample_transitions`` and ``fit_surrogate`` in
``pyneuralempc_tpu/models/train.py``: sample transitions from any
ground-truth step function, fit the MLP by Adam, and get back a params list
ready to thread through the solver.  Random numbers come from explicit
``torch.Generator``s, so the same seed gives the same surrogate.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .mlp import MLPDynamics


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def sample_transitions(truth_fn: Callable, generator: torch.Generator,
                       n: int, x_dim: int, u_dim: int, x_range=(-1.0, 1.0),
                       u_range=(-1.0, 1.0), device="cuda"):
    """Uniformly sample (x, u) from ``generator`` and evaluate the
    ground-truth batched step function ``truth_fn(x, u) -> y`` on
    ``device``."""
    def uniform(shape, lo, hi):
        r = torch.rand(shape, generator=generator, device=generator.device)
        return (lo + (hi - lo) * r).to(device)

    X = uniform((n, x_dim), *x_range)
    U = uniform((n, u_dim), *u_range)
    return X, U, truth_fn(X, U)


def fit_surrogate(model: MLPDynamics, X, U, Y, steps: int = 2000,
                  lr: float = 1e-3, batch: Optional[int] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[list, float]:
    """Fit ``model`` params to (X, U) -> Y by Adam; returns (params, mse).

    Params are initialised from ``generator`` (seed 0 when None) and the
    minibatch indices of every step are drawn up front from a second
    generator (seed 1), so the loop itself never waits on the host.
    """
    device = X.device
    init_gen = _generator(0) if generator is None else generator
    params = model.init_params(init_gen, device=device)
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=lr)
    n = X.shape[0]
    batch = n if batch is None else min(batch, n)
    idx_all = torch.randint(0, n, (steps, batch),
                            generator=_generator(1)).to(device)

    loss = None
    for i in range(steps):
        idx = idx_all[i]
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(X[idx], U[idx], params=params)
                           - Y[idx]) ** 2)
        loss.backward()
        opt.step()
    params = [{k: v.detach() for k, v in layer.items()} for layer in params]
    return params, float(loss.detach())
