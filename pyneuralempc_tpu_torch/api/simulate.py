"""Closed-loop simulation harness.

PyTorch counterpart of ``pyneuralempc_tpu/api/simulate.py``.  Plant
stepping, re-plan cadence, convergence accounting and the failure policy
(a member whose re-plan fails keeps playing its previous plan) are handled
once, for single plants (:func:`closed_loop`) and for batched fleets
(:func:`closed_loop_batch`).

The JAX package runs the fleet loop as one ``lax.scan`` under ``jit``;
here it is a host loop over the batch-first :meth:`NMPC.next_batch`: a cold
solve, then one warm re-plan a round.  The plant step, the failure policy's
``where`` and the stale plan's shift are tensor operations on the
controller's device, so a round fetches nothing to the host beyond the
solver's own synchronisations, and the trajectories stay on the device
until they are returned.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.integrators import step_fn


class ClosedLoopResult(NamedTuple):
    x: Any            # (T+1, x_dim) plant trajectory
    u: Any            # (T, u_dim) applied controls
    converged: Any    # (n_solves,) per-solve flags
    iterations: Any   # (n_solves,)
    objective: Any    # (n_solves,) planned objective at each solve


def closed_loop(mpc, plant_step: Callable, x0, steps: int,
                replan_every: int = 1, p=None, tvp_fn: Optional[Callable] = None,
                params=None, plant_params=None) -> ClosedLoopResult:
    """Run receding-horizon MPC against a plant.

    ``plant_step(x, u) -> x_next`` operates on single states (vectors).
    ``tvp_fn(t) -> (H, tvp_dim)`` supplies the look-ahead tvp window at
    plant step t (or None).  The MPC re-plans every ``replan_every`` steps
    and plays the remaining plan in between; if a solve fails, the previous
    plan keeps playing (and the warm carry keeps improving next re-plan).
    """
    x = torch.as_tensor(x0, device=mpc.device)
    mpc.reset()
    xs, us = [x], []
    conv, iters, objs = [], [], []
    plan, k = None, 0
    for t in range(steps):
        if t % replan_every == 0 or k >= mpc.H:
            tvp = None if tvp_fn is None else tvp_fn(t)
            res = mpc.next(x, p=p, tvp=tvp, params=params)
            conv.append(bool(res.converged))
            iters.append(int(res.iterations))
            objs.append(float(res.objective))
            if plan is None or bool(res.converged):
                plan, k = res, 0
            else:
                k = min(k, mpc.H - 1)   # keep playing the old plan
        u = plan.u[k]
        k += 1
        x = plant_step(x, u) if plant_params is None else plant_step(
            x, u, plant_params)
        xs.append(x)
        us.append(u)
    return ClosedLoopResult(
        x=torch.stack(xs), u=torch.stack(us),
        converged=np.asarray(conv), iterations=np.asarray(iters),
        objective=np.asarray(objs))


class FleetLoopResult(NamedTuple):
    """Batched closed-loop rollout: leading axes are (n_solves|steps, B)."""
    x: Any            # (steps+1, B, x_dim) plant trajectories
    u: Any            # (steps, B, u_dim) applied controls
    converged: Any    # (n_solves, B) per-solve flags
    iterations: Any   # (n_solves, B)
    objective: Any    # (n_solves, B) planned objective at each solve
    theta: Any        # (n_solves, B) constraint violation at each solve


def closed_loop_batch(mpc, plant_step: Callable, x0s, steps: int,
                      replan_every: int = 1, p=None, params=None,
                      plant_params=None, tvp_seq=None) -> FleetLoopResult:
    """Batched closed-loop MPC on the controller's device.

    Each round plays ``replan_every`` controls of every member's plan on
    the plant, then re-plans the whole fleet warm from the states reached:
    ``n_replans = steps // replan_every`` rounds after the cold solve.
    ``plant_step(x, u[, plant_params]) -> x_next`` works on single vectors
    and is vmapped here.  ``p``/``params`` are shared across the batch or
    per member, as :meth:`NMPC.next_batch` takes them (``p`` (B, p_dim),
    every tensor of ``params`` leading with B).  ``tvp_seq`` optionally
    supplies the time-varying-parameter look-ahead window for every solve:
    shape (n_replans+1, H, tvp_dim) — index 0 feeds the cold solve, index
    j+1 the j-th warm re-plan.  Failure policy matches :func:`closed_loop`:
    a member whose re-plan did not converge keeps playing its previous plan
    (shifted to stay aligned in time) while its warm carry keeps improving.

    The per-solve statistics have n_replans+1 rows: the cold solve and
    every warm re-plan, the last of which is never played.
    ``steps`` must be a multiple of ``replan_every`` (the reference
    example's cadence re-plans every 2 steps).
    """
    if steps % replan_every:
        raise ValueError("steps must be a multiple of replan_every")
    if replan_every > mpc.H:
        raise ValueError("replan_every cannot exceed the horizon H")
    n_replans = steps // replan_every
    x0s = torch.as_tensor(x0s, device=mpc.device)
    if tvp_seq is not None:
        tvp_seq = torch.as_tensor(tvp_seq, device=mpc.device)
        if tvp_seq.shape[0] != n_replans + 1:
            raise ValueError(
                f"tvp_seq must supply n_replans+1 = {n_replans + 1} "
                f"windows, got {tvp_seq.shape[0]}")

    def plant_one(xx, uu):
        return (plant_step(xx, uu) if plant_params is None
                else plant_step(xx, uu, plant_params))

    vplant = torch.func.vmap(plant_one)

    def window(j):
        return None if tvp_seq is None else tvp_seq[j]

    def stats(res):
        return res.converged, res.iterations, res.objective, res.theta

    carry, res = mpc.next_batch(x0s, p=p, tvp=window(0), params=params)
    solves = [stats(res)]
    x, plan_u = x0s, res.u
    xs, us = [x0s], []
    for j in range(n_replans):
        for k in range(replan_every):
            u_k = plan_u[:, k]
            x = vplant(x, u_k)
            xs.append(x)
            us.append(u_k)
        carry, res = mpc.next_batch(x, p=p, tvp=window(j + 1), params=params,
                                    carry=carry)
        # failure policy: non-converged members keep playing their
        # previous plan, shifted by the controls just consumed
        stale = torch.cat([plan_u[:, replan_every:],
                           plan_u[:, -1:].repeat(1, replan_every, 1)], dim=1)
        plan_u = torch.where(res.converged[:, None, None], res.u, stale)
        solves.append(stats(res))
    conv, iters, objs, theta = (torch.stack(s) for s in zip(*solves))
    return FleetLoopResult(x=torch.stack(xs), u=torch.stack(us),
                           converged=conv, iterations=iters, objective=objs,
                           theta=theta)


def plant_from_model(model, integrator: str, dt: float,
                     params=None) -> Callable:
    """Wrap a dynamics model as a single-state plant step function."""
    phi = step_fn(model, integrator, dt)

    def step(x, u, prm=params):
        return phi(x[None, :], u[None, :], None, None, prm)[0]

    return step
