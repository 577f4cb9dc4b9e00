"""The quadrotor MLP fleet's plain reference: the rigid-body ODE (the true
plant), the surrogate's features and forward pass, RK4, the tracking cost,
and the normalised fit that makes the surrogate.

Frozen copies of ``pyneuralempc_tpu_torch/examples/quadrotor.py`` (the ODE,
its constants, the cost, the (sin, cos) attitude features) and of
``models/train.py`` ``fit_normalized_surrogate`` (the fit), in plain
PyTorch.  Every function takes tensors of any float dtype: the benchmark's
correctness check runs them in float64.

State: position p(3), velocity v(3), attitude (roll, pitch, yaw; ZYX
Euler), body rates (3).  Controls: four rotor thrusts (N).
"""

from __future__ import annotations

import math

import torch

M, G = 0.5, 9.81
JX, JY, JZ = 2.3e-3, 2.3e-3, 4.0e-3
ARM, KTAU = 0.17, 0.016   # arm length, yaw-torque/thrust ratio
F_HOVER = M * G / 4.0


def rigid_body_f(x, u):
    """Continuous-time rigid-body dynamics on (T, 12) states and (T, 4)
    thrusts, x configuration."""
    T = torch.sum(u, dim=1, keepdim=True)
    tau_x = ARM * (u[:, 1:2] - u[:, 3:4])
    tau_y = ARM * (u[:, 2:3] - u[:, 0:1])
    tau_z = KTAU * (u[:, 0:1] - u[:, 1:2] + u[:, 2:3] - u[:, 3:4])
    v = x[:, 3:6]
    phi, th, psi = x[:, 6:7], x[:, 7:8], x[:, 8:9]
    p_, q_, r_ = x[:, 9:10], x[:, 10:11], x[:, 11:12]
    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(th), torch.cos(th)
    sps, cps = torch.sin(psi), torch.cos(psi)
    zb = torch.cat([cph * sth * cps + sph * sps,
                    cph * sth * sps - sph * cps,
                    cph * cth], dim=1)
    acc = (T / M) * zb - torch.cat(
        [torch.zeros_like(T), torch.zeros_like(T), torch.full_like(T, G)],
        dim=1)
    tth = sth / torch.clamp(cth, min=1e-3)
    dphi = p_ + sph * tth * q_ + cph * tth * r_
    dth = cph * q_ - sph * r_
    dpsi = (sph * q_ + cph * r_) / torch.clamp(cth, min=1e-3)
    dom = torch.cat([(tau_x - (JZ - JY) * q_ * r_) / JX,
                     (tau_y - (JX - JZ) * p_ * r_) / JY,
                     (tau_z - (JY - JX) * p_ * q_) / JZ], dim=1)
    return torch.cat([v, acc, dphi, dth, dpsi, dom], dim=1)


def rk4(f, x, u, dt):
    """One classic Runge-Kutta step of ``f`` with ``u`` held."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def features(x):
    """The surrogate's input features: the attitude as (sin, cos) per
    Euler angle, the rest as it is (15 features)."""
    ang = x[:, 6:9]
    return torch.cat([x[:, :6], torch.sin(ang), torch.cos(ang), x[:, 9:12]],
                     dim=1)


def mlp(layers, h):
    """tanh hidden layers, linear output; ``layers`` a list of (w, b)."""
    for w, b in layers[:-1]:
        h = torch.tanh(h @ w + b)
    w, b = layers[-1]
    return h @ w + b


def surrogate_f(fit, x, u):
    """The fitted surrogate's continuous-time dynamics: the MLP over the
    standardised features and thrusts, its output de-standardised.
    ``fit`` holds ``layers`` and the constants ``f_mu``, ``f_sd``,
    ``u_mu``, ``u_sd``, ``y_mu``, ``y_sd``, each in the dtype and on the
    device of ``x``."""
    inp = torch.cat([(features(x) - fit["f_mu"]) / fit["f_sd"],
                     (u - fit["u_mu"]) / fit["u_sd"]], dim=1)
    return mlp(fit["layers"], inp) * fit["y_sd"] + fit["y_mu"]


def stage_cost(x, u, ref=None):
    """The example's hover cost with position measured from ``ref`` (the
    origin when None): over the last axis of x (…, 12), u (…, 4), ref
    (…, 3)."""
    e = x[..., :3] if ref is None else x[..., :3] - ref
    return (torch.sum(e ** 2, -1) + 0.1 * torch.sum(x[..., 3:6] ** 2, -1)
            + 0.5 * torch.sum(x[..., 6:8] ** 2, -1) + 0.1 * x[..., 8] ** 2
            + 0.02 * torch.sum(x[..., 9:] ** 2, -1)
            + 0.05 * torch.sum((u - F_HOVER) ** 2, -1))


def terminal_cost(x, ref=None):
    """The example's terminal position and velocity term."""
    e = x[..., :3] if ref is None else x[..., :3] - ref
    return 5.0 * (torch.sum(e ** 2, -1) + torch.sum(x[..., 3:6] ** 2, -1))


def fit_surrogate(fit_cfg: dict, device) -> dict:
    """The example's normalised fit (``fit_quad_mlp``): n transitions of the
    rigid-body ODE drawn uniformly (x in ``x_range``, thrusts in
    ``u_range``) from a CPU generator seeded ``seed``, features, thrusts
    and targets standardised, a [15 + 4] + hidden + [12] tanh MLP
    (Glorot-uniform from the same generator) fitted by Adam on minibatches
    whose indices the generator draws 256 steps at a time.  The matmuls run
    in float32 (TF32 off).  Returns the fit on the CPU: ``layers``, the six
    constants and the last step's normalised mse ``mse``."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _fit(fit_cfg, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _fit(fit_cfg: dict, device) -> dict:
    n, steps = int(fit_cfg["n"]), int(fit_cfg["steps"])
    gen = torch.Generator().manual_seed(int(fit_cfg["seed"]))

    def uniform(shape, lo, hi):
        r = torch.rand(shape, generator=gen)
        return (lo + (hi - lo) * r).to(device)

    X = uniform((n, 12), *fit_cfg["x_range"])
    U = uniform((n, 4), *fit_cfg["u_range"])
    Y = rigid_body_f(X, U)
    F = features(X)

    def stats(T):
        return T.mean(0), T.std(0, unbiased=False) + 1e-6

    (f_mu, f_sd), (u_mu, u_sd), (y_mu, y_sd) = stats(F), stats(U), stats(Y)
    sizes = [15 + 4] + list(fit_cfg["hidden"]) + [12]
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = torch.rand((fan_in, fan_out), generator=gen) * (2.0 * limit) \
            - limit
        layers.append((w.to(device).requires_grad_(),
                       torch.zeros((fan_out,), device=device)
                       .requires_grad_()))
    FU = torch.cat([(F - f_mu) / f_sd, (U - u_mu) / u_sd], dim=-1)
    Yn = (Y - y_mu) / y_sd
    bsz = min(int(fit_cfg["batch"]), n)
    opt = torch.optim.Adam([t for layer in layers for t in layer],
                           lr=float(fit_cfg["lr"]))
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        if i % 256 == 0:
            chunk = torch.randint(0, n, (min(256, steps - i), bsz),
                                  generator=gen).to(device)
        idx = chunk[i % 256]
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((mlp(layers, FU[idx]) - Yn[idx]) ** 2)
        loss.backward()
        opt.step()
    out = {"layers": [(w.detach().cpu(), b.detach().cpu())
                      for w, b in layers],
           "mse": float(loss.detach())}
    for k, v in (("f_mu", f_mu), ("f_sd", f_sd), ("u_mu", u_mu),
                 ("u_sd", u_sd), ("y_mu", y_mu), ("y_sd", y_sd)):
        out[k] = v.detach().cpu()
    return out


def fit_to(fit: dict, dtype, device) -> dict:
    """The fit's tensors in ``dtype`` on ``device``."""
    out = {k: v.to(device=device, dtype=dtype) for k, v in fit.items()
           if isinstance(v, torch.Tensor)}
    out["layers"] = [(w.to(device=device, dtype=dtype),
                      b.to(device=device, dtype=dtype))
                     for w, b in fit["layers"]]
    return out


def stage_flops(hidden) -> int:
    """Operations of one surrogate evaluation at one stage under RK4: four
    MLP passes, 2·in·out a layer (the features, tanh and RK4 sums left
    out)."""
    sizes = [15 + 4] + list(hidden) + [12]
    return 4 * sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
