"""Builds ``quadrotor_mlp`` (``quadrotor_mlp.json``): the quadrotor fleet
with a 2x256 tanh MLP surrogate, RK4, H=50.

The surrogate is the benchmark's own input: its weights and standardising
constants come from the reference's fit (``reference/quadrotor.py``),
fitted by the first run in a checkout and loaded from
``benchmark/_cache/fits/`` by every later one.  The port gets them through
its own model API (``DynamicsModel`` over ``mlp_apply``); the reference
keeps its own copy in float64.  The plant is the rigid-body ODE, stepped
by RK4.  The control (``control=True``) runs the surrogate's matmuls in
bf16, through the port's own ``mlp_apply(compute_dtype=torch.bfloat16)``.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

from benchmark.harness.cell import Cell
from benchmark.reference import nlp
from benchmark.reference import quadrotor as ref


def fitted(cfg: dict, cache_dir: Path, device) -> dict:
    """The surrogate's fit: from the cache when a run in this checkout
    made it, else fitted now and written there."""
    fit_cfg = dict(cfg["fit"], hidden=cfg["hidden"])
    key = hashlib.sha256(json.dumps(fit_cfg, sort_keys=True).encode()
                         + Path(ref.__file__).read_bytes()).hexdigest()[:16]
    path = Path(cache_dir) / "fits" / f"{cfg['name']}-{key}.pt"
    if path.exists():
        return torch.load(path, weights_only=True)
    fit = ref.fit_surrogate(fit_cfg, device)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(fit, tmp)
    os.replace(tmp, path)
    return fit


def build(cfg: dict, mix: dict, *, device, cache_dir, control=False) -> Cell:
    from pyneuralempc_tpu_torch import (NMPC, DomainConstraint,
                                        DynamicsModel, IPConfig, StageCost,
                                        mlp_apply)
    from pyneuralempc_tpu_torch.core.problem import Dims

    H, DT, nx, nu = cfg["H"], cfg["DT"], cfg["x_dim"], cfg["u_dim"]
    fit = fitted(cfg, cache_dir, device)
    f32 = ref.fit_to(fit, torch.float32, device)
    acts = tuple(["tanh"] * len(cfg["hidden"]) + ["linear"])
    dtype = torch.bfloat16 if control else torch.float32

    def surrogate(x, u, p, tvp, prm):
        inp = torch.cat([(ref.features(x) - f32["f_mu"]) / f32["f_sd"],
                         (u - f32["u_mu"]) / f32["u_sd"]], dim=-1)
        return mlp_apply(prm, inp, acts, dtype) * f32["y_sd"] + f32["y_mu"]

    model = DynamicsModel(fn=surrogate, dims=Dims(nx, nu), name=cfg["name"])
    params = [{"w": w, "b": b} for w, b in f32["layers"]]
    cost = StageCost(
        stage=lambda x, u, p=None, tvp=None: ref.stage_cost(x, u, tvp),
        terminal=lambda x, p=None: ref.terminal_cost(x, p))
    box = DomainConstraint(states_constraint=cfg["box"]["states"],
                           control_constraint=cfg["box"]["controls"])
    mpc = NMPC(model, cost, [box], H=H, DT=DT, integrator=cfg["integrator"],
               config=IPConfig(**cfg["solver"]), device=device)

    f64 = ref.fit_to(fit, torch.float64, device)

    def phi(x, u):
        return ref.rk4(lambda a, b: ref.surrogate_f(f64, a, b), x, u, DT)

    def cost64(X, U, tvp, p):
        return (ref.stage_cost(X, U, tvp).sum(-1)
                + ref.terminal_cost(X[:, -1], p))

    return Cell(mpc=mpc, params=params,
                problem=nlp.Problem(H=H, nx=nx, nu=nu, phi=phi, cost=cost64,
                                    **_bounds(cfg, device)),
                plant=lambda x, u: ref.rk4(ref.rigid_body_f, x, u, DT),
                lift=lambda x: x,
                stage_flops=ref.stage_flops(cfg["hidden"]))


def _bounds(cfg, device):
    """The box over [vec(X) | vec(U)], float64."""
    H = cfg["H"]
    xs, us = cfg["box"]["states"], cfg["box"]["controls"]
    lo = [b[0] for b in xs] * H + [b[0] for b in us] * H
    hi = [b[1] for b in xs] * H + [b[1] for b in us] * H
    f64 = dict(dtype=torch.float64, device=device)
    return {"lb": torch.tensor(lo, **f64), "ub": torch.tensor(hi, **f64)}
