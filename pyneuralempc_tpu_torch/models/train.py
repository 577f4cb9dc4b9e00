"""Surrogate fitting: train an MLP dynamics model on a ground-truth system.

PyTorch counterpart of ``pyneuralempc_tpu/models/train.py``: sample
transitions from any ground-truth step function, fit the MLP by Adam
(:func:`fit_surrogate`, or :func:`fit_normalized_surrogate` with
standardised inputs and targets), and get back a params list ready to
thread through the solver.  Random numbers come from explicit
``torch.Generator``s, so the same seed gives the same surrogate.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.problem import Dims
from .base import DynamicsModel
from .mlp import MLPDynamics, mlp_apply, mlp_init

# minibatch index draws per host round trip in fit_normalized_surrogate
_INDEX_CHUNK = 256
# eager Adam steps before a CUDA fit captures one step as a graph
_GRAPH_WARMUP = 3


def adam_steps(leaves, lr: float, steps: int, step_loss: Callable,
               before_step: Optional[Callable] = None) -> float:
    """``steps`` Adam steps on ``leaves`` (tensors that require grad) of the
    scalar ``step_loss()``; ``before_step(i)`` first updates whatever
    inputs step i reads, in place.  Returns the last step's loss.

    On CUDA tensors the first _GRAPH_WARMUP steps run eagerly on a side
    stream, then one step (forward, backward, Adam update) is captured as
    a CUDA graph and replayed for the rest: a small model's step is
    hundreds of tiny kernels, and replaying them spares the host one
    dispatch each.  The CPU runs every step eagerly.
    """
    if not steps:
        return float("nan")
    graph = leaves[0].is_cuda and steps > _GRAPH_WARMUP
    opt = torch.optim.Adam(leaves, lr=lr, capturable=graph)

    def eager(i):
        if before_step is not None:
            before_step(i)
        opt.zero_grad(set_to_none=True)
        loss = step_loss()
        loss.backward()
        opt.step()
        return loss

    if not graph:
        for i in range(steps):
            loss = eager(i)
        return float(loss.detach())
    side = torch.cuda.Stream(device=leaves[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(_GRAPH_WARMUP):
            eager(i)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    if before_step is not None:
        before_step(_GRAPH_WARMUP)
    with torch.cuda.graph(g):
        loss = step_loss()
        loss.backward()
        opt.step()
    # the capture recorded step _GRAPH_WARMUP without running it
    for i in range(_GRAPH_WARMUP, steps):
        if before_step is not None and i > _GRAPH_WARMUP:
            before_step(i)
        g.replay()
    return float(loss.detach())


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
    generator (seed 1), so the loop itself never waits on the host.  The
    steps run eagerly on the card too (not :func:`adam_steps`' graph):
    the LV surrogate that ``chip_smoke.py`` gates on keeps its bits.
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


def fit_normalized_surrogate(truth_fn: Callable, generator: torch.Generator,
                             x_dim: int, u_dim: int, hidden, n: int = 65536,
                             x_range=(-1.0, 1.0), u_range=(-1.0, 1.0),
                             steps: int = 8000, lr: float = 1e-3,
                             batch: int = 4096, feature_map=None,
                             feature_dim=None, activation: str = "tanh",
                             name: str = "mlp_norm", device="cuda"):
    """Train a surrogate with input/output standardisation and an optional
    feature map, the JAX package's ``fit_normalized_surrogate``.

    Samples n transitions uniformly (x in ``x_range``, u in ``u_range``),
    standardises the features ``feature_map(x)`` (T, feature_dim; default
    the identity), the controls and the targets to zero mean and unit
    spread, and fits an MLP ``[features | u] -> target`` by Adam on
    minibatches of ``batch``.  The data, the Glorot init and every
    minibatch's indices come from ``generator``, in that order (indices
    drawn on its device a chunk of steps at a time).

    Returns ``(model, params, rel_mse)``: a
    :class:`~pyneuralempc_tpu_torch.models.base.DynamicsModel` with the
    normalisation constants baked in (params stay a plain layer list),
    and the last step's normalised-target mse (1.0 = predicting the mean).
    """
    X, U, Y = sample_transitions(truth_fn, generator, n, x_dim, u_dim,
                                 x_range=x_range, u_range=u_range,
                                 device=device)
    fmap = (lambda x: x) if feature_map is None else feature_map
    fdim = x_dim if feature_dim is None else feature_dim

    def stats(T):
        return T.mean(0), T.std(0, unbiased=False) + 1e-6

    F = fmap(X)
    (f_mu, f_sd), (u_mu, u_sd), (y_mu, y_sd) = stats(F), stats(U), stats(Y)
    activations = tuple([activation] * len(hidden) + ["linear"])
    params = mlp_init(generator, [fdim + u_dim] + list(hidden) + [x_dim],
                      device=device)
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    FU = torch.cat([(F - f_mu) / f_sd, (U - u_mu) / u_sd], dim=-1)
    Yn = (Y - y_mu) / y_sd
    bsz = min(batch, n)
    idx = torch.empty((bsz,), dtype=torch.int64, device=device)
    chunk = []

    def next_indices(i):
        if i % _INDEX_CHUNK == 0:
            chunk[:] = [torch.randint(
                0, n, (min(_INDEX_CHUNK, steps - i), bsz),
                generator=generator, device=generator.device).to(device)]
        idx.copy_(chunk[0][i % _INDEX_CHUNK])

    def step_loss():
        return torch.mean((mlp_apply(params, FU[idx], activations)
                           - Yn[idx]) ** 2)

    loss = adam_steps(leaves, lr, steps, step_loss, next_indices)
    params = [{k: v.detach() for k, v in layer.items()} for layer in params]

    consts = (f_mu, f_sd, u_mu, u_sd, y_mu, y_sd)

    def fn(x, u, p, tvp, prm):
        # the constants follow the inputs, so one model serves the card
        # and the CPU
        fm, fs, um, us, ym, ys = (c.to(x.device) for c in consts)
        out = mlp_apply(prm, torch.cat([(fmap(x) - fm) / fs, (u - um) / us],
                                       dim=-1), activations)
        return out * ys + ym

    model = DynamicsModel(fn=fn, dims=Dims(x_dim, u_dim), name=name)
    return model, params, loss
