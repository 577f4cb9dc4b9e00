"""Builds ``quadrotor_gru`` (``quadrotor_gru.json``): the quadrotor fleet
with a GRU surrogate of 16 units lifted into the state, z = [x, h]
(28 states, 4 thrusts), the direct integrator, H=100.

The surrogate is the benchmark's own input: its weights and standardising
constants come from the reference's fit (``reference/quadrotor_gru.py``),
fitted by the first run in a checkout and loaded from
``benchmark/_cache/fits/`` by every later one.  The port gets them through
its own model API (``gru_dynamics`` with the (sin, cos) attitude features
and the fit's scales); the reference keeps its own copy in float64.  The
plant steps the physical block by the rigid-body ODE under RK4 and the
hidden block by the surrogate's GRU on the measured state and the applied
thrusts, in float32: the filter update a deployment runs between
re-plans.  The control (``control=True``) runs the GRU's matmuls in bf16
in the program's place.

The cold solve starts from the held plan (:class:`HeldStart`): the
physical state held at x0 under hover thrust, the hidden state carried
along it by the controller's own GRU.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

from benchmark.harness.cell import Cell
from benchmark.reference import nlp
from benchmark.reference import quadrotor as quad
from benchmark.reference import quadrotor_gru as ref


def fitted(cfg: dict, cache_dir: Path, device) -> dict:
    """The surrogate's fit: from the cache when a run in this checkout
    made it, else fitted now and written there."""
    fit_cfg = dict(cfg["fit"], hidden=cfg["hidden"])
    key = hashlib.sha256(
        json.dumps([fit_cfg, cfg["DT"]], sort_keys=True).encode()
        + Path(ref.__file__).read_bytes()
        + Path(quad.__file__).read_bytes()).hexdigest()[:16]
    path = Path(cache_dir) / "fits" / f"{cfg['name']}-{key}.pt"
    if path.exists():
        return torch.load(path, weights_only=True)
    fit = ref.fit_surrogate(fit_cfg, cfg["DT"], device)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(fit, tmp)
    os.replace(tmp, path)
    return fit


def _bf16_gru_step(w, h, inp):
    """The port's ``gru_step`` with every matmul in bf16 (the control)."""
    def mm(a, b):
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(a.dtype)
    hx = torch.cat([inp, h], dim=-1)
    z = torch.sigmoid(mm(hx, w["wz"]) + w["bz"])
    r = torch.sigmoid(mm(hx, w["wr"]) + w["br"])
    h_tilde = torch.tanh(mm(torch.cat([inp, r * h], dim=-1), w["wh"])
                         + w["bh"])
    return (1.0 - z) * h + z * h_tilde, mm


class HeldStart:
    """The port's controller, cold-started from the held plan: every
    stage's physical state x0's, its thrusts ``u``, and its hidden state
    the GRU's along that plan from x0's (so the hidden block's defects
    start at zero).  ``next_batch`` passes the plan as ``init_x``/
    ``init_u`` where there is no carry; anything else is the controller's.
    """

    def __init__(self, mpc, nx: int, u):
        self.mpc, self.nx = mpc, nx
        self.u = torch.as_tensor(u, dtype=torch.float32, device=mpc.device)

    def __getattr__(self, name):
        return getattr(self.mpc, name)

    def plan(self, z0, params):
        """(init_x, init_u) of the held plan from z0 (B, nx + hidden)."""
        B, H = z0.shape[0], self.mpc.H
        U = self.u.expand(B, H, self.u.shape[0])
        x, z, zs = z0[:, :self.nx], z0, []
        for t in range(H):
            h = self.mpc.model(z, U[:, t], None, None, params)[:, self.nx:]
            z = torch.cat([x, h], dim=-1)
            zs.append(z)
        return torch.stack(zs, dim=1), U

    def next_batch(self, x0s, p=None, tvp=None, params=None, carry=None):
        init_x = init_u = None
        if carry is None:
            init_x, init_u = self.plan(x0s, params)
        return self.mpc.next_batch(x0s, p=p, tvp=tvp, params=params,
                                   carry=carry, init_x=init_x, init_u=init_u)


def build(cfg: dict, mix: dict, *, device, cache_dir, control=False) -> Cell:
    from pyneuralempc_tpu_torch import (NMPC, DynamicsModel, IPConfig,
                                        StageCost, gru_dynamics)

    H, DT, nu, hid = cfg["H"], cfg["DT"], cfg["u_dim"], cfg["hidden"]
    nx = cfg["x_dim_physical"]
    fit = fitted(cfg, cache_dir, device)
    f32 = ref.fit_to(fit, torch.float32, device)
    gd = gru_dynamics(x_dim=nx, u_dim=nu, hidden=hid,
                      feature_map=ref.features, in_mu=f32["in_mu"],
                      in_sd=f32["in_sd"], out_mu=f32["out_mu"],
                      out_sd=f32["out_sd"], name=cfg["name"])
    model = gd.model
    if control:
        def bf16_fn(z, u, p, tvp, w):
            x, h = z[:, :nx], z[:, nx:]
            h_new, mm = _bf16_gru_step(w, h, gd.gru_input(x, u))
            dx = (mm(h_new, w["wo"]) + w["bo"]) * gd.out_sd + gd.out_mu
            return torch.cat([x + dx, h_new], dim=-1)
        model = DynamicsModel(fn=bf16_fn, dims=model.dims, name=model.name)
    cost = StageCost(
        stage=lambda z, u, p=None, tvp=None: quad.stage_cost(
            gd.head(z), u, tvp),
        terminal=lambda z, p=None: quad.terminal_cost(gd.head(z), p))
    box = gd.box(cfg["box"]["states"], cfg["box"]["controls"],
                 hidden_bound=cfg["box"]["hidden"])
    mpc = HeldStart(NMPC(model, cost, [box], H=H, DT=DT,
                         integrator=cfg["integrator"],
                         config=IPConfig(**cfg["solver"]), device=device),
                    nx, cfg["cold_start"]["u"])

    f64 = ref.fit_to(fit, torch.float64, device)

    def cost64(X, U, tvp, p):
        return (quad.stage_cost(X[..., :nx], U, tvp).sum(-1)
                + quad.terminal_cost(X[:, -1, :nx], p))

    def plant(z, u):
        x, h = z[:, :nx], z[:, nx:]
        return torch.cat([quad.rk4(quad.rigid_body_f, x, u, DT),
                          ref.hidden_update(f32, h, x, u)], dim=-1)

    return Cell(mpc=mpc, params=f32["w"],
                problem=nlp.Problem(H=H, nx=cfg["x_dim"], nu=nu,
                                    phi=lambda z, u: ref.lifted_step(f64, z,
                                                                     u),
                                    cost=cost64, **_bounds(cfg, device)),
                plant=plant,
                lift=lambda x: gd.lift(x),
                stage_flops=ref.stage_flops(hid))


def _bounds(cfg, device):
    """The box over [vec(Z) | vec(U)], float64: the physical states' bounds
    and ±``hidden`` on the hidden block, each stage."""
    H, hb = cfg["H"], cfg["box"]["hidden"]
    xs = cfg["box"]["states"] + [[-hb, hb]] * cfg["hidden"]
    us = cfg["box"]["controls"]
    lo = [b[0] for b in xs] * H + [b[0] for b in us] * H
    hi = [b[1] for b in xs] * H + [b[1] for b in us] * H
    f64 = dict(dtype=torch.float64, device=device)
    return {"lb": torch.tensor(lo, **f64), "ub": torch.tensor(hi, **f64)}
