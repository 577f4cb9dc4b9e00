"""The quadrotor GRU fleet's plain reference: the GRU surrogate's lifted
step z = [x, h] -> [x + Δx, h'], the hidden-state update between
re-plans, the data and the fit that make the surrogate, and its
operations a stage.

The rigid-body ODE (the true plant), RK4, the (sin, cos) attitude
features and the tracking cost are ``reference/quadrotor.py``'s, imported
and not copied.  The GRU is ``pyneuralempc_tpu_torch/models/rnn.py``'s
``gru_step`` with its feature map and scales (``gru_dynamics``), in plain
PyTorch:

    h_{t+1} = GRU(h_t, ([features(x_t) | u_t] − in_mu) / in_sd),
    x_{t+1} = x_t + (W_o h_{t+1} + b_o) · out_sd + out_mu.

Every function takes tensors of any float dtype: the benchmark's
correctness check runs them in float64.
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark.reference import quadrotor as quad

NX, NU, N_FEATURES = 12, 4, 15


def features(x):
    """``quadrotor.features`` over the last axis of x (…, 12)."""
    flat = quad.features(x.reshape(-1, NX))
    return flat.reshape(x.shape[:-1] + (N_FEATURES,))


def gru_cell(w, h, inp):
    """One GRU update, h' = (1 − z)·h + z·h̃, over the last axis: ``w``
    holds wz, wr, wh ((in + hidden, hidden)) and bz, br, bh."""
    hx = torch.cat([inp, h], dim=-1)
    z = torch.sigmoid(hx @ w["wz"] + w["bz"])
    r = torch.sigmoid(hx @ w["wr"] + w["br"])
    h_tilde = torch.tanh(torch.cat([inp, r * h], dim=-1) @ w["wh"]
                         + w["bh"])
    return (1.0 - z) * h + z * h_tilde


def gru_input(fit, x, u):
    """The GRU's standardised input from states (…, 12) and thrusts
    (…, 4)."""
    return (torch.cat([features(x), u], dim=-1) - fit["in_mu"]) \
        / fit["in_sd"]


def hidden_update(fit, h, x, u):
    """The hidden state after one step from h, on the measured state x and
    the applied thrusts u: the filter a deployment runs between
    re-plans."""
    return gru_cell(fit["w"], h, gru_input(fit, x, u))


def lifted_step(fit, z, u):
    """z_{t+1} from z_t = [x_t, h_t] (…, 12 + hidden) and u_t (…, 4)."""
    x, h = z[..., :NX], z[..., NX:]
    h_new = hidden_update(fit, h, x, u)
    dx = (h_new @ fit["w"]["wo"] + fit["w"]["bo"]) * fit["out_sd"] \
        + fit["out_mu"]
    return torch.cat([x + dx, h_new], dim=-1)


def stage_flops(hidden: int) -> int:
    """Operations of one GRU evaluation at one stage under the direct
    integrator: the three gates' products, 2·(19 + hidden)·hidden each,
    and the readout's, 2·hidden·12 (the gates' nonlinearities, the
    features and the scales left out)."""
    return (3 * 2 * (N_FEATURES + NU + hidden) * hidden
            + 2 * hidden * NX)


# ---- the data and the fit ----


def _mix(T, tau):
    """Rotor thrusts (…, 4) giving total thrust T and body torques tau
    (…, 3) (the inverse of ``rigid_body_f``'s mixer)."""
    a = 0.5 * (T + tau[..., 2] / quad.KTAU)     # u1 + u3
    b = 0.5 * (T - tau[..., 2] / quad.KTAU)     # u2 + u4
    return torch.stack([0.5 * (a - tau[..., 1] / quad.ARM),
                        0.5 * (b + tau[..., 0] / quad.ARM),
                        0.5 * (a + tau[..., 1] / quad.ARM),
                        0.5 * (b - tau[..., 0] / quad.ARM)], dim=-1)


def hover_feedback(x, target, gains):
    """A cascaded PD hover loop: the position error asks an acceleration
    (capped at ``amax``), which sets the total thrust and a roll and pitch
    (capped at ``tilt``); attitude PD loops set the torques, yaw held at
    0.  Returns thrusts (N, 4) before any bound."""
    g = gains
    p, v, ang, w = x[:, :3], x[:, 3:6], x[:, 6:9], x[:, 9:12]
    a = torch.clamp(-g["kp"] * (p - target) - g["kd"] * v,
                    -g["amax"], g["amax"])
    phi, th, psi = ang[:, 0], ang[:, 1], ang[:, 2]
    T = quad.M * (quad.G + a[:, 2]) / (torch.cos(phi) * torch.cos(th))
    cps, sps = torch.cos(psi), torch.sin(psi)
    th_d = torch.clamp((a[:, 0] * cps + a[:, 1] * sps) / quad.G,
                       -g["tilt"], g["tilt"])
    ph_d = torch.clamp((a[:, 0] * sps - a[:, 1] * cps) / quad.G,
                       -g["tilt"], g["tilt"])
    err = torch.stack([ph_d - phi, th_d - th, -psi], dim=-1)
    alpha = g["katt"] * err - g["krate"] * w
    inertia = torch.tensor([quad.JX, quad.JY, quad.JZ], dtype=x.dtype,
                           device=x.device)
    return _mix(T, alpha * inertia)


def _uniform(gen, shape, lo, hi, device):
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(device)


def feedback_sequences(c: dict, DT: float, gen, device):
    """``c["n"]`` sequences of ``c["T"]`` steps of the rigid-body ODE under
    RK4 at DT, flown by :func:`hover_feedback` to a target drawn
    U(±``target``) a sequence, with every rotor's thrust moved by
    U(±``excitation``) N each step and bounded to [0, 3] N.  The starts
    are uniform in ``start_low``/``start_high``.  Returns X (n, T+1, 12),
    U (n, T, 4)."""
    n, T = int(c["n"]), int(c["T"])
    x = _uniform(gen, (n, NX), c["start_low"], c["start_high"], device)
    target = _uniform(gen, (n, 3), -c["target"], c["target"], device)
    Xs, Us = [x], []
    for _ in range(T):
        kick = _uniform(gen, (n, NU), -c["excitation"], c["excitation"],
                        device)
        u = torch.clamp(hover_feedback(x, target, c["gains"]) + kick,
                        0.0, 3.0)
        x = quad.rk4(quad.rigid_body_f, x, u, DT)
        Xs.append(x)
        Us.append(u)
    return torch.stack(Xs, dim=1), torch.stack(Us, dim=1)


def teacher_forced_mse(fit, X, U):
    """Mean squared error of the standardised Δx over sequences and steps,
    the GRU fed the measured x_t and u_t from a zero hidden state:
    X (N, T+1, 12), U (N, T, 4)."""
    w = fit["w"]
    h = X.new_zeros((X.shape[0], w["bz"].shape[0]))
    inp = gru_input(fit, X[:, :-1], U)
    preds = []
    for t in range(U.shape[1]):
        h = gru_cell(w, h, inp[:, t])
        preds.append(h @ w["wo"] + w["bo"])
    target = (X[:, 1:] - X[:, :-1] - fit["out_mu"]) / fit["out_sd"]
    return torch.mean((torch.stack(preds, dim=1) - target) ** 2)


def fit_surrogate(fit_cfg: dict, DT: float, device) -> dict:
    """The GRU's fit: :func:`feedback_sequences` of ``fit_cfg["data"]``
    drawn from a CPU generator seeded ``seed``; the input and Δx scales
    over them; a GRU of ``hidden`` units (gru_init's Uniform(±1/sqrt(
    hidden + 19)) weights from the same generator, zero biases) fitted by
    Adam on :func:`teacher_forced_mse`, ``steps`` steps at ``lr`` falling
    on a cosine to ``lr_end``, each on ``batch`` sequences drawn with
    replacement by the generator.  The matmuls run in float32 (TF32 off);
    on a card one step is captured as a CUDA graph after three eager ones
    and replayed.  Returns the fit on the CPU: the weights ``w``, the
    scales ``in_mu``, ``in_sd``, ``out_mu``, ``out_sd``, and ``mse``, the
    final teacher-forced mse over the first 2,048 sequences."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _fit(fit_cfg, DT, torch.device(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _stats(rows):
    return rows.mean(0), rows.std(0, unbiased=False) + 1e-6


def _fit(fit_cfg: dict, DT: float, device) -> dict:
    gen = torch.Generator().manual_seed(int(fit_cfg["seed"]))
    X, U = feedback_sequences(fit_cfg["data"], DT, gen, device)
    fit = {}
    fit["in_mu"], fit["in_sd"] = _stats(
        torch.cat([features(X[:, :-1]), U], dim=-1).reshape(-1, N_FEATURES
                                                            + NU))
    fit["out_mu"], fit["out_sd"] = _stats((X[:, 1:] - X[:, :-1])
                                          .reshape(-1, NX))
    hid, n_in = int(fit_cfg["hidden"]), N_FEATURES + NU
    scale = 1.0 / math.sqrt(hid + n_in)

    def uniform(shape):
        r = torch.rand(shape, generator=gen)
        return ((2.0 * r - 1.0) * scale).to(device).requires_grad_()

    def zeros(n):
        return torch.zeros((n,), device=device).requires_grad_()

    w = {"wz": uniform((n_in + hid, hid)), "wr": uniform((n_in + hid, hid)),
         "wh": uniform((n_in + hid, hid)), "bz": zeros(hid),
         "br": zeros(hid), "bh": zeros(hid), "wo": uniform((hid, NX)),
         "bo": zeros(NX)}
    fit["w"] = w
    steps, batch = int(fit_cfg["steps"]), int(fit_cfg["batch"])
    lr0, lr1 = float(fit_cfg["lr"]), float(fit_cfg["lr_end"])
    graph = device.type == "cuda"
    lr = torch.tensor(lr0, device=device)
    opt = torch.optim.Adam(list(w.values()), lr=lr, capturable=graph)
    idx = torch.zeros((batch,), dtype=torch.long, device=device)

    def before(i):
        """Step i's minibatch and learning rate, in place."""
        idx.copy_(torch.randint(0, X.shape[0], (batch,), generator=gen))
        lr.fill_(lr1 + 0.5 * (lr0 - lr1) * (1.0 + math.cos(math.pi * i
                                                            / steps)))

    def step():
        loss = teacher_forced_mse(fit, X[idx], U[idx])
        loss.backward()
        opt.step()
        return loss

    eager = steps if not graph else min(steps, 3)
    side = torch.cuda.Stream(device) if graph else None
    if graph:
        side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side) if graph else contextlib.nullcontext():
        for i in range(eager):
            before(i)
            opt.zero_grad(set_to_none=True)
            step()
    if graph and steps > eager:
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        opt.zero_grad(set_to_none=True)
        before(eager)
        with torch.cuda.graph(g):
            step()
        # the capture recorded step `eager` without running it
        for i in range(eager, steps):
            if i > eager:
                before(i)
            g.replay()
        torch.cuda.synchronize(device)
    out = {"w": {k: v.detach().cpu() for k, v in w.items()}}
    for k in ("in_mu", "in_sd", "out_mu", "out_sd"):
        out[k] = fit[k].detach().cpu()
    with torch.no_grad():
        out["mse"] = float(teacher_forced_mse(fit, X[:2048], U[:2048]))
    return out


def fit_to(fit: dict, dtype, device) -> dict:
    """The fit's tensors in ``dtype`` on ``device``."""
    out = {k: v.to(device=device, dtype=dtype) for k, v in fit.items()
           if isinstance(v, torch.Tensor)}
    out["w"] = {k: v.to(device=device, dtype=dtype)
                for k, v in fit["w"].items()}
    return out
