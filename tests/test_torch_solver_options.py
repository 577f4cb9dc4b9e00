"""The solver options (ROADMAP Queue 1 #5b): ``mu_strategy`` "adaptive"
and "mehrotra", ``hessian`` "objective" and "gauss_newton", and
``polish_fresh``, each held against the JAX package on the CPU.

* ``IPConfig`` has every field of the JAX package's, with its default.
* The LV MLP fleet (bench.py's problem, H=12) at B=8 members with differing
  starts, cold and one warm re-plan, and the same fleet with a nonlinear
  stage row x1 + x0²/2 ≥ −0.6 (near enough to the plans that its barrier
  adds an iteration to two members): converged masks and per-member
  iteration counts equal, |u_port − u_jax|∞ ≤ 1e-4.  (``tests/test_stage_constraints.py``'s
  raw-LV ellipse case sits at the f32 floor of its KKT error at tol=1e-4:
  there the JAX package's own plans move by up to 0.2 under ±1e-7 on the
  start, and a member whose JAX plan does not move converges in 14
  iterations there and in 15 in the port, with plans 1.1e-6 apart.)
* Each member's μ after every iteration (the warm carry's) is what it is
  when the member is solved alone, to MU_RTOL relative: μ is reduced over
  a member's own entries, never over the batch.  The batched iterates
  differ from the lone ones in their last bits (a batched product rounds
  apart from one member's), so μ is not held bit for bit: over every k
  and both rules the largest measured spread is 3.8e-7 (adaptive, k=2),
  while the members' own μ differ from each other by 18% to 999x.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T

import _torch_threads  # noqa: F401  (one torch thread)
from _torch_lv import (BENCH_CFG, BOX, REG, glorot_params, jax_mpc,
                       jax_params, torch_mpc, x0_batch)

H, B = 12, 8
DU_TOL = 1e-4
# a member's batched μ against its μ solved alone, relative: 26x the
# largest spread measured on the CPU (3.8e-7)
MU_RTOL = 1e-5
OPTIONS = {
    "adaptive": dict(mu_strategy="adaptive"),
    "mehrotra": dict(mu_strategy="mehrotra"),
    "objective": dict(hessian="objective"),
    "gauss_newton": dict(hessian="gauss_newton"),
    "polish_fresh": dict(polish_fresh=True),
}


def test_ipconfig_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(J.IPConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.IPConfig)}
    assert jf == tf
    for kw in OPTIONS.values():
        T.IPConfig(**kw)              # ported: no raise
    with pytest.raises(ValueError):
        T.IPConfig(mu_strategy="nope")
    with pytest.raises(ValueError):
        T.IPConfig(hessian="nope")


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_lv_fleet_matches_jax(option):
    cfg = dict(BENCH_CFG, **OPTIONS[option])
    P = glorot_params(0)
    jp, tp = jax_params(P), T.mlp_params_from_numpy(P, device="cpu")
    jm, tm = jax_mpc(H, cfg), torch_mpc(H, cfg)
    xs = x0_batch(B, seed=1)
    jc, jres = jm.next_batch(jnp.asarray(xs), params=jp)
    tc, tres = tm.next_batch(torch.as_tensor(xs), params=tp)
    _compare(jres, tres)
    xs = np.array(jres.x[:, 0], np.float32)
    _, jres = jm.next_batch(jnp.asarray(xs), params=jp, carry=jc)
    _, tres = tm.next_batch(torch.as_tensor(xs), params=tp, carry=tc)
    _compare(jres, tres)


ROW_LB = -0.6


def _row_mpcs(option):
    """The LV MLP problem with a nonlinear stage row x1 + x0²/2 ≥ ROW_LB in
    both packages, with the option set."""
    cfg = dict(BENCH_CFG, **OPTIONS[option])
    jrow = J.stage_interval(
        lambda x, u: jnp.array([x[1] + 0.5 * x[0] ** 2]), dim=1,
        lb=ROW_LB, ub=np.inf)
    trow = T.stage_interval(
        lambda x, u: torch.stack([x[1] + 0.5 * x[0] ** 2]), dim=1,
        lb=ROW_LB, ub=np.inf)
    jm = J.NMPC(J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u),
                [J.DomainConstraint(**BOX), jrow], H=H, DT=0.1,
                integrator="rk4", config=J.IPConfig(**cfg))
    tm = T.NMPC(T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u),
                [T.DomainConstraint(**BOX), trow], H=H, DT=0.1,
                integrator="rk4", config=T.IPConfig(**cfg), device="cpu")
    return jm, tm


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_stage_constrained_case_matches_jax(option):
    P = glorot_params(0)
    jm, tm = _row_mpcs(option)
    assert tm.kkt_backend == "riccati"
    xs = x0_batch(B, seed=1)
    _, jres = jm.next_batch(jnp.asarray(xs), params=jax_params(P))
    _, tres = tm.next_batch(torch.as_tensor(xs),
                            params=T.mlp_params_from_numpy(P, device="cpu"))
    _compare(jres, tres)
    # every plan converged and holds the row
    assert bool(tres.converged.all())
    g = tres.x[..., 1] + 0.5 * tres.x[..., 0] ** 2
    assert float(g.min()) >= ROW_LB - 1e-3


@pytest.mark.parametrize("strategy", ["adaptive", "mehrotra"])
def test_mu_is_each_members_own(strategy):
    """Members with far-apart starts in one batch (the last one never
    converges: its μ stays high): after every iteration k (a solve cut at
    max_iter=k), each member's μ is its μ when solved alone, to MU_RTOL,
    with the same iteration count; and at some k the members' μ differ from
    each other by far more than MU_RTOL (at least 10%), so a member reading
    another's μ would show."""
    P = T.mlp_params_from_numpy(glorot_params(0), device="cpu")
    xs = torch.tensor([[0.75, -0.35], [-0.6, 0.3], [0.9, 0.3]])
    gaps = []
    for k in range(1, 9):
        tm = torch_mpc(H, dict(BENCH_CFG, mu_strategy=strategy,
                               polish_iters=0, max_iter=k))
        c_both, both = tm.next_batch(xs, params=P)
        for i in range(len(xs)):
            c_alone, alone = tm.next_batch(xs[i:i + 1], params=P)
            assert both.iterations[i] == alone.iterations[0]
            torch.testing.assert_close(c_both.mu[i:i + 1], c_alone.mu,
                                       rtol=MU_RTOL, atol=0.0,
                                       msg=f"k={k}, member {i}")
        gaps.append(float(c_both.mu.max() / c_both.mu.min()) - 1.0)
    # the members' μ parted by at least 10% at some iteration
    assert max(gaps) >= 0.1, gaps
