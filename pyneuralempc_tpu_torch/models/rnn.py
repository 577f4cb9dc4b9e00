"""Recurrent (GRU, LSTM) dynamics models via lifted hidden state.

PyTorch counterpart of ``pyneuralempc_tpu/models/rnn.py``.  The recurrent
hidden state joins the MPC state vector,

    z_t = [x_t, h_t],
    z_{t+1} = [ x_t + f_out(h_{t+1}),  h_{t+1} ],
    h_{t+1} = GRU(h_t, [x_t, u_t]),

so the transcription stays first-order Markov, stage sparsity is preserved,
the Riccati backend works unchanged, and every derivative (through the gate
nonlinearities too) comes from ``torch.func``.  Box bounds apply to the
physical block; the hidden block gets loose bounds.

The GRU may read features of x in place of x (``feature_map``, e.g. an
angle as its sine and cosine) and work in standardised units: its input
[features(x) | u] less ``in_mu`` over ``in_sd``, its readout times
``out_sd`` plus ``out_mu`` the state's change, as a surrogate fitted on
standardised data is (:func:`gru_dynamics`).

The cells are plain params-dict implementations (``torch.nn`` modules would
hold their weights as state; here they are runtime data, as the MLP's
are), in the JAX package's layouts, so :func:`.convert.params_from_numpy`
carries weights across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..core.problem import Box, Dims
from .base import DynamicsModel, _call_user_fn
from .train import adam_steps


def _uniform(generator: torch.Generator, shape, scale: float, device):
    """Uniform(-scale, scale) drawn from ``generator`` on its own device,
    then moved to ``device``."""
    r = torch.rand(shape, generator=generator, device=generator.device)
    return ((2.0 * r - 1.0) * scale).to(device)


def _zeros(n: int, device):
    return torch.zeros((n,), dtype=torch.float32, device=device)


def _lift(x0, *blocks):
    """Concatenate ``x0`` (…, x_dim) with recurrent blocks, zeros where a
    block is None; leading axes ride along."""
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    parts = [x0]
    for b, n in blocks:
        parts.append(x0.new_zeros(x0.shape[:-1] + (n,)) if b is None
                     else torch.as_tensor(b, dtype=x0.dtype,
                                          device=x0.device))
    return torch.cat(parts, dim=-1)


class _Lifted:
    """What every lifted bundle shares: ``head`` and ``head_objective``."""

    def head(self, Z):
        """Physical states from a lifted trajectory (…, nz)."""
        return Z[..., : self.x_dim]

    def head_objective(self, fn: Callable) -> Callable:
        """Wrap a physical-coordinates cost J(x, u, p, tvp) to accept the
        lifted state."""
        def wrapped(Z, u, p=None, tvp=None):
            return _call_user_fn(fn, self.head(Z), u, p, tvp)
        return wrapped

    def _box(self, states_constraint, control_constraint, n_hidden,
             hidden_bound):
        hb = [[-hidden_bound, hidden_bound]] * n_hidden
        return Box.make(list(states_constraint) + hb, control_constraint)


# ---- GRU ----


def gru_init(generator: torch.Generator, in_dim: int, hidden: int,
             out_dim: int, device="cuda"):
    """GRU cell + linear readout params: ``wz``, ``wr``, ``wh`` (in + hidden,
    hidden), zero biases, ``wo`` (hidden, out), ``bo``; weights
    Uniform(±1/sqrt(hidden + in))."""
    scale = 1.0 / math.sqrt(hidden + in_dim)
    return {
        "wz": _uniform(generator, (in_dim + hidden, hidden), scale, device),
        "wr": _uniform(generator, (in_dim + hidden, hidden), scale, device),
        "wh": _uniform(generator, (in_dim + hidden, hidden), scale, device),
        "bz": _zeros(hidden, device), "br": _zeros(hidden, device),
        "bh": _zeros(hidden, device),
        "wo": _uniform(generator, (hidden, out_dim), scale, device),
        "bo": _zeros(out_dim, device),
    }


def gru_step(params, h, inp):
    """One GRU update, batched over leading axes: h (…, nh), inp (…, ni).
    h_new = (1 − z)·h + z·h̃."""
    hx = torch.cat([inp, h], dim=-1)
    z = torch.sigmoid(hx @ params["wz"] + params["bz"])
    r = torch.sigmoid(hx @ params["wr"] + params["br"])
    hxr = torch.cat([inp, r * h], dim=-1)
    h_tilde = torch.tanh(hxr @ params["wh"] + params["bh"])
    return (1.0 - z) * h + z * h_tilde


@dataclasses.dataclass(frozen=True)
class GRUDynamics(_Lifted):
    """Lifted GRU dynamics bundle (use ``.model`` with
    integrator="direct").  ``in_dim``: the width of the GRU's input,
    [features(x) | u] (x_dim + u_dim without a feature map);
    ``feature_map`` and the scales are :func:`gru_dynamics`' (None: not
    applied)."""

    model: DynamicsModel
    x_dim: int
    u_dim: int
    hidden: int
    in_dim: Optional[int] = None
    feature_map: Optional[Callable] = None
    in_mu: Optional[torch.Tensor] = None
    in_sd: Optional[torch.Tensor] = None
    out_mu: Optional[torch.Tensor] = None
    out_sd: Optional[torch.Tensor] = None

    def gru_input(self, x, u):
        """The GRU's input from states (…, x_dim) and controls (…, u_dim):
        [features(x) | u], standardised where ``in_mu``/``in_sd`` are
        given."""
        feats = x if self.feature_map is None else self.feature_map(x)
        inp = torch.cat([feats, u], dim=-1)
        if self.in_mu is not None:
            inp = inp - self.in_mu
        if self.in_sd is not None:
            inp = inp / self.in_sd
        return inp

    def readout(self, params, h):
        """The state's change from the GRU's hidden state (…, hidden):
        W_o h + b_o, times ``out_sd`` plus ``out_mu`` where given."""
        dx = h @ params["wo"] + params["bo"]
        if self.out_sd is not None:
            dx = dx * self.out_sd
        if self.out_mu is not None:
            dx = dx + self.out_mu
        return dx

    def lift(self, x0, h0=None):
        """z₀ = [x0, h0] (h0 zeros when None); ``x0`` may carry leading
        batch axes."""
        return _lift(x0, (h0, self.hidden))

    def box(self, states_constraint, control_constraint,
            hidden_bound: float = 10.0) -> Box:
        """Physical bounds + loose symmetric bounds on the hidden block
        (keeps the barrier well-scaled; GRU hiddens live in (-1, 1))."""
        return self._box(states_constraint, control_constraint, self.hidden,
                         hidden_bound)

    def init_params(self, generator: torch.Generator, device="cuda"):
        in_dim = self.in_dim or self.x_dim + self.u_dim
        return gru_init(generator, in_dim, self.hidden, self.x_dim,
                        device=device)


def gru_dynamics(x_dim: int, u_dim: int, hidden: int = 16,
                 p_dim: int = 0, tvp_dim: int = 0,
                 name: str = "gru", feature_map: Optional[Callable] = None,
                 in_mu=None, in_sd=None, out_mu=None,
                 out_sd=None) -> GRUDynamics:
    """Build a lifted GRU dynamics model:

        h_{t+1} = GRU(h_t, ([features(x_t) | u_t] − in_mu) / in_sd),
        x_{t+1} = x_t + (W_o h_{t+1} + b_o) · out_sd + out_mu.

    ``feature_map`` (…, x_dim) -> (…, n_features) defaults to the identity;
    each of the four scales ((n_features + u_dim,) for the input's,
    (x_dim,) for the readout's) is left out where None, so the defaults
    give x_{t+1} = x_t + W_o h_{t+1} + b_o on [x_t | u_t]."""
    nz = x_dim + hidden
    in_dim = None
    if feature_map is not None:
        in_dim = int(feature_map(torch.zeros((1, x_dim))).shape[-1]) + u_dim
    gd = GRUDynamics(model=None, x_dim=x_dim, u_dim=u_dim, hidden=hidden,
                     in_dim=in_dim, feature_map=feature_map, in_mu=in_mu,
                     in_sd=in_sd, out_mu=out_mu, out_sd=out_sd)

    def fn(z, u, p, tvp, params):
        x, h = z[:, :x_dim], z[:, x_dim:]
        h_new = gru_step(params, h, gd.gru_input(x, u))
        return torch.cat([x + gd.readout(params, h_new), h_new], dim=-1)

    lifted = DynamicsModel(fn=fn, dims=Dims(nz, u_dim, p_dim, tvp_dim),
                           name=name)
    return dataclasses.replace(gd, model=lifted)


def _teacher_forced_loss(params, X, U, hidden,
                         gd: Optional[GRUDynamics] = None):
    """Mean over sequences and steps of ‖x̂_{t+1} − x_{t+1}‖² (each entry
    over ``gd.out_sd`` where it is given), the GRU of ``gd`` (None: of
    :func:`gru_dynamics`' defaults) fed the measured x_t and u_t: X (N,
    T+1, nx), U (N, T, nu).  The input halves of the gate products for
    every step are one matmul each (the inputs are known up front); only
    the hidden halves run step by step.  The same sums as
    :func:`gru_step`, grouped otherwise."""
    if gd is None:
        gd = GRUDynamics(model=None, x_dim=X.shape[-1], u_dim=U.shape[-1],
                         hidden=hidden)
    N, T = U.shape[0], U.shape[1]
    inp = gd.gru_input(X[:, :-1], U)                     # (N, T, ni)
    ni = inp.shape[-1]
    w_zr = torch.cat([params["wz"], params["wr"]], dim=1)
    gx_zr = inp @ w_zr[:ni] + torch.cat([params["bz"], params["br"]])
    gx_h = inp @ params["wh"][:ni] + params["bh"]
    wh_zr, wh_h = w_zr[ni:], params["wh"][ni:]
    h = X.new_zeros((N, hidden))
    hs = []
    for t in range(T):
        zr = torch.sigmoid(gx_zr[:, t] + h @ wh_zr)
        z, r = zr[:, :hidden], zr[:, hidden:]
        h_tilde = torch.tanh(gx_h[:, t] + (r * h) @ wh_h)
        h = (1.0 - z) * h + z * h_tilde
        hs.append(h)
    err = X[:, :-1] + gd.readout(params, torch.stack(hs, dim=1)) - X[:, 1:]
    if gd.out_sd is not None:
        err = err / gd.out_sd
    return torch.mean(torch.sum(err ** 2, dim=-1))


def fit_gru_on_sequences(gd: GRUDynamics, X_seqs, U_seqs, steps: int = 2000,
                         lr: float = 1e-3,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[dict, float]:
    """Teacher-forced sequence fitting by Adam of ``gd``'s function (its
    feature map and scales too): X_seqs (N, T+1, x_dim), U_seqs (N, T,
    u_dim), on their device; batched over the N sequences
    with a loop over the T steps (on the card the step is replayed as a
    CUDA graph: :func:`.train.adam_steps`).  The init comes from
    ``generator`` (a CPU generator seeded 0 when None).  Returns (params,
    the last step's mse)."""
    X_seqs = torch.as_tensor(X_seqs, dtype=torch.float32)
    U_seqs = torch.as_tensor(U_seqs, dtype=torch.float32,
                             device=X_seqs.device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = gd.init_params(generator, device=X_seqs.device)
    leaves = [t.requires_grad_() for t in params.values()]
    loss = adam_steps(leaves, lr, steps, lambda: _teacher_forced_loss(
        params, X_seqs, U_seqs, gd.hidden, gd))
    return {k: v.detach() for k, v in params.items()}, loss


# ---- LSTM (Keras cell layout) ----


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              out_dim: int, device="cuda"):
    """LSTM cell + linear readout params in the Keras layout: ``wk`` (in,
    4u), ``wr`` (u, 4u), ``b`` (4u,) with gate order [input, forget, cell,
    output] and a unit forget-gate bias, ``wo``, ``bo``."""
    scale = 1.0 / math.sqrt(hidden + in_dim)
    b = _zeros(4 * hidden, device)
    b[hidden: 2 * hidden] = 1.0
    return {
        "wk": _uniform(generator, (in_dim, 4 * hidden), scale, device),
        "wr": _uniform(generator, (hidden, 4 * hidden), scale, device),
        "b": b,
        "wo": _uniform(generator, (hidden, out_dim), scale, device),
        "bo": _zeros(out_dim, device),
    }


def lstm_step(params, h, c, inp):
    """One LSTM update (Keras gate order and semantics), batched over
    leading axes: h/c (…, nh), inp (…, ni).  Returns (h_new, c_new)."""
    nh = h.shape[-1]
    gates = inp @ params["wk"] + h @ params["wr"] + params["b"]
    i = torch.sigmoid(gates[..., :nh])
    f = torch.sigmoid(gates[..., nh: 2 * nh])
    g = torch.tanh(gates[..., 2 * nh: 3 * nh])
    o = torch.sigmoid(gates[..., 3 * nh:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _check_mode(mode):
    if mode not in ("delta", "direct"):
        raise ValueError(f"unknown readout mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class LSTMDynamics(_Lifted):
    """Lifted LSTM dynamics bundle, z = [x, h, c] (use ``.model`` with
    integrator="direct").  ``mode``: readout x + W_o·h ("delta") or W_o·h
    ("direct")."""

    model: DynamicsModel
    x_dim: int
    u_dim: int
    hidden: int
    mode: str = "delta"

    def lift(self, x0, h0=None, c0=None):
        return _lift(x0, (h0, self.hidden), (c0, self.hidden))

    def box(self, states_constraint, control_constraint,
            hidden_bound: float = 10.0) -> Box:
        return self._box(states_constraint, control_constraint,
                         2 * self.hidden, hidden_bound)

    def init_params(self, generator: torch.Generator, device="cuda"):
        return lstm_init(generator, self.x_dim + self.u_dim, self.hidden,
                         self.x_dim, device=device)


def lstm_dynamics(x_dim: int, u_dim: int, hidden: int = 16,
                  p_dim: int = 0, tvp_dim: int = 0, mode: str = "delta",
                  name: str = "lstm") -> LSTMDynamics:
    """Build a lifted LSTM dynamics model (z = [x, h, c])."""
    _check_mode(mode)
    nz = x_dim + 2 * hidden

    def fn(z, u, p, tvp, params):
        x = z[:, :x_dim]
        h = z[:, x_dim: x_dim + hidden]
        c = z[:, x_dim + hidden:]
        h_new, c_new = lstm_step(params, h, c, torch.cat([x, u], dim=-1))
        out = h_new @ params["wo"] + params["bo"]
        x_next = x + out if mode == "delta" else out
        return torch.cat([x_next, h_new, c_new], dim=-1)

    lifted = DynamicsModel(fn=fn, dims=Dims(nz, u_dim, p_dim, tvp_dim),
                           name=name)
    return LSTMDynamics(model=lifted, x_dim=x_dim, u_dim=u_dim,
                        hidden=hidden, mode=mode)


# ---- Keras-compatible GRU cell ----


def keras_gru_step(params, h, inp, reset_after: bool = True):
    """One GRU update with tf.keras semantics and weight layout: ``wk``
    (in, 3u), ``wr`` (u, 3u), gate order [z, r, h], bias (2, 3u) when
    ``reset_after`` (the reset gate multiplies the post-matmul recurrent
    term) else (3u,).  h_new = z·h + (1 − z)·h̃ (Keras keeps the old state
    through z, the opposite of :func:`gru_step`)."""
    nh = h.shape[-1]
    gx = inp @ params["wk"]
    gh = h @ params["wr"]
    b = params["b"]
    if reset_after:
        bx, bh = b[0], b[1]
    else:
        bx, bh = b, torch.zeros_like(b)
    z = torch.sigmoid(gx[..., :nh] + gh[..., :nh] + bx[..., :nh]
                      + bh[..., :nh])
    r = torch.sigmoid(gx[..., nh:2 * nh] + gh[..., nh:2 * nh]
                      + bx[..., nh:2 * nh] + bh[..., nh:2 * nh])
    if reset_after:
        hh = torch.tanh(gx[..., 2 * nh:] + bx[..., 2 * nh:]
                        + r * (gh[..., 2 * nh:] + bh[..., 2 * nh:]))
    else:
        hh = torch.tanh(gx[..., 2 * nh:] + bx[..., 2 * nh:]
                        + (r * h) @ params["wr"][:, 2 * nh:])
    return z * h + (1.0 - z) * hh


def keras_gru_dynamics(x_dim: int, u_dim: int, hidden: int,
                       mode: str = "delta", reset_after: bool = True,
                       p_dim: int = 0, tvp_dim: int = 0,
                       name: str = "keras_gru") -> GRUDynamics:
    """Lifted GRU dynamics with the Keras cell (z = [x, h]); params
    {"wk", "wr", "b", "wo", "bo"} in the Keras layout."""
    _check_mode(mode)
    nz = x_dim + hidden

    def fn(z, u, p, tvp, params):
        x, h = z[:, :x_dim], z[:, x_dim:]
        h_new = keras_gru_step(params, h, torch.cat([x, u], dim=-1),
                               reset_after=reset_after)
        out = h_new @ params["wo"] + params["bo"]
        x_next = x + out if mode == "delta" else out
        return torch.cat([x_next, h_new], dim=-1)

    lifted = DynamicsModel(fn=fn, dims=Dims(nz, u_dim, p_dim, tvp_dim),
                           name=name)
    return GRUDynamics(model=lifted, x_dim=x_dim, u_dim=u_dim, hidden=hidden)


# ---- stacked LSTM ----


@dataclasses.dataclass(frozen=True)
class StackedLSTMDynamics(_Lifted):
    """Lifted multi-layer LSTM, z = [x, h₁, c₁, …, h_L, c_L]: layer ℓ reads
    layer ℓ−1's new hidden state (layer 1 reads [x, u]), as tf.keras
    ``Sequential([LSTM, …, LSTM, Dense])`` with ``return_sequences=True``
    between layers."""

    model: DynamicsModel
    x_dim: int
    u_dim: int
    hiddens: Tuple[int, ...]
    mode: str = "delta"

    def lift(self, x0, carries=None):
        return _lift(x0, (carries, 2 * sum(self.hiddens)))

    def box(self, states_constraint, control_constraint,
            hidden_bound: float = 10.0) -> Box:
        return self._box(states_constraint, control_constraint,
                         2 * sum(self.hiddens), hidden_bound)


def stacked_lstm_dynamics(x_dim: int, u_dim: int, hiddens,
                          mode: str = "delta", p_dim: int = 0,
                          tvp_dim: int = 0,
                          name: str = "stacked_lstm") -> StackedLSTMDynamics:
    """Build a lifted stacked-LSTM dynamics model.  params:
    {"layers": [{"wk", "wr", "b"}, …], "wo", "bo"} (Keras layouts)."""
    _check_mode(mode)
    hiddens = tuple(int(h) for h in hiddens)
    nz = x_dim + 2 * sum(hiddens)

    def fn(z, u, p, tvp, params):
        x = z[:, :x_dim]
        off = x_dim
        inp = torch.cat([x, u], dim=-1)
        new_carries = []
        for lp, nh in zip(params["layers"], hiddens):
            h = z[:, off: off + nh]
            c = z[:, off + nh: off + 2 * nh]
            off += 2 * nh
            h_new, c_new = lstm_step(lp, h, c, inp)
            new_carries.extend([h_new, c_new])
            inp = h_new
        out = inp @ params["wo"] + params["bo"]
        x_next = x + out if mode == "delta" else out
        return torch.cat([x_next] + new_carries, dim=-1)

    lifted = DynamicsModel(fn=fn, dims=Dims(nz, u_dim, p_dim, tvp_dim),
                           name=name)
    return StackedLSTMDynamics(model=lifted, x_dim=x_dim, u_dim=u_dim,
                               hiddens=hiddens, mode=mode)
