"""The IFT-differentiable solve (ROADMAP Queue 1 #10): the port's
``make_differentiable_solver`` and ``NMPC(differentiable=True)`` against
``jax.grad`` through the JAX package's on the CPU.

The problems are the JAX package's ``tests/test_diff_mpc.py`` ones (raw
Lotka-Volterra, H=8, RK4, a StageCost; an MLP surrogate at H=6, Euler),
solved as a batch in the port and one member at a time in the JAX
package.  Gradients of the same loss with respect to x0 and to the MLP
params, through the Riccati direction and through the dense fallback, are
held to the JAX package's within 1e-3 relative (to the largest entry of
each gradient), and the x0 gradients to the port's own central finite
differences within 5% or 5e-3 (the JAX test's bound).  A member whose
solve did not converge gets a zero gradient, and the shared params
gradient sums the converged members only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.solve.diff import (make_differentiable_solver as
                                         j_make_diff)
from pyneuralempc_tpu.solve.riccati import make_riccati_direction as j_ric
from pyneuralempc_tpu_torch.solve.riccati import make_riccati_direction \
    as t_ric

import _torch_threads  # noqa: F401  (one torch thread)

GRAD_RTOL = 1e-3
X0S = np.array([[0.3, 0.2], [0.1, -0.1]], np.float32)
RAW_BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
               control_constraint=[[-1.0, 1.0]])


def _lv_j(x, u):
    return jnp.concatenate(
        [0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
         -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], axis=1)


def _lv_t(x, u):
    return torch.cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                      -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]],
                     dim=1)


def _close(got, ref, rtol=GRAD_RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= rtol, (err, got, ref)


def _lv_pair(**cfg):
    cfg = dict(dict(max_iter=80, tol=1e-6), **cfg)
    jm = J.NMPC(J.jax_dynamics(_lv_j, 2, 1),
                J.StageCost(stage=lambda x, u: 1.1 * jnp.sum(u)
                            + 0.2 * jnp.sum(x ** 2)),
                [J.DomainConstraint(**RAW_BOX)], H=8, DT=0.1,
                integrator="rk4", config=J.IPConfig(**cfg))
    tm = T.NMPC(T.torch_dynamics(_lv_t, 2, 1),
                T.StageCost(stage=lambda x, u: 1.1 * torch.sum(u)
                            + 0.2 * torch.sum(x ** 2)),
                [T.DomainConstraint(**RAW_BOX)], H=8, DT=0.1,
                integrator="rk4", config=T.IPConfig(**cfg), device="cpu")
    return jm, tm, cfg


def _jax_x0_grads(jm, cfg, riccati, x0s):
    solve = j_make_diff(jm.nlp, J.IPConfig(**cfg),
                        direction=j_ric if riccati else None)

    def loss(x0):
        w0 = jm.cold_start(jax.lax.stop_gradient(x0)).w
        res = solve(J.runtime(x0), w0)
        _, U, _ = jm.nlp.unpack(res.w)
        return jnp.sum(U ** 2) + res.objective
    return np.asarray(jax.jit(jax.vmap(jax.grad(loss)))(jnp.asarray(x0s)))


def _port_loss(tm, solve, x0s):
    """Σ over members of Σ U² + objective, and the result."""
    rt = T.runtime(x0s)
    rt["_per_member"] = ()
    res = solve(rt, tm.cold_start(x0s.detach()).w)
    _, U, _ = tm.nlp.unpack(res.w)
    return (U ** 2).sum() + res.objective.sum(), res


@pytest.mark.parametrize("riccati", [True, False], ids=["riccati", "dense"])
def test_grad_wrt_x0_matches_jax_and_fd(riccati):
    jm, tm, cfg = _lv_pair()
    solve = T.make_differentiable_solver(tm.nlp, T.IPConfig(**cfg),
                                         direction=t_ric if riccati else None)
    x0s = torch.tensor(X0S, requires_grad=True)
    loss, res = _port_loss(tm, solve, x0s)
    assert bool(res.converged.all())
    loss.backward()
    _close(x0s.grad.numpy(), _jax_x0_grads(jm, cfg, riccati, X0S))
    # central differences of the port's own loss, member by member
    eps = 1e-3
    for b in range(len(X0S)):
        fd = np.zeros(2)
        for i in range(2):
            d = torch.zeros(2)
            d[i] = eps
            one = torch.as_tensor(X0S[b:b + 1])
            fd[i] = (float(_port_loss(tm, solve, one + d)[0])
                     - float(_port_loss(tm, solve, one - d)[0])) / (2 * eps)
        np.testing.assert_allclose(x0s.grad[b].numpy(), fd, rtol=0.05,
                                   atol=5e-3)


def test_grad_with_polish_matches_jax():
    """Polish moves the returned point to μ = polish_mu, and res.mu rides
    with it: the gradients stay the JAX package's."""
    jm, tm, cfg = _lv_pair(polish_iters=3, polish_mu=1e-8)
    solve = T.make_differentiable_solver(tm.nlp, T.IPConfig(**cfg),
                                         direction=t_ric)
    x0s = torch.tensor(X0S, requires_grad=True)
    _port_loss(tm, solve, x0s)[0].backward()
    _close(x0s.grad.numpy(), _jax_x0_grads(jm, cfg, True, X0S))


def _mlp_pair(H=6):
    cfg = dict(max_iter=60, tol=1e-6)
    box = dict(states_constraint=[[-2.0, 2.0]] * 2,
               control_constraint=[[-1.0, 1.0]])
    jmodel = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    tmodel = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    jm = J.NMPC(jmodel, J.StageCost(stage=lambda x, u: jnp.sum((x - 0.2) ** 2)
                                    + 0.1 * jnp.sum(u ** 2)),
                [J.DomainConstraint(**box)], H=H, DT=0.2, integrator="euler",
                config=J.IPConfig(**cfg))
    tm = T.NMPC(tmodel, T.StageCost(stage=lambda x, u: torch.sum(
        (x - 0.2) ** 2) + 0.1 * torch.sum(u ** 2)),
        [T.DomainConstraint(**box)], H=H, DT=0.2, integrator="euler",
        config=T.IPConfig(**cfg), device="cpu")
    rng = np.random.default_rng(0)
    P = [{"w": (0.4 * rng.normal(size=(3, 8))).astype(np.float32),
          "b": (0.1 * rng.normal(size=8)).astype(np.float32)},
         {"w": (0.4 * rng.normal(size=(8, 2))).astype(np.float32),
          "b": (0.1 * rng.normal(size=2)).astype(np.float32)}]
    return jm, tm, cfg, P


TARGET_U = 0.15


def _jax_param_grads(jm, cfg, P, riccati, x0s):
    solve = j_make_diff(jm.nlp, J.IPConfig(**cfg),
                        direction=j_ric if riccati else None)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in P]

    def loss(p, x0):
        w0 = jm.cold_start(x0, params=jax.lax.stop_gradient(p)).w
        res = solve(J.runtime(x0, params=p), jax.lax.stop_gradient(w0))
        _, U, _ = jm.nlp.unpack(res.w)
        return jnp.sum((U - TARGET_U) ** 2)
    g = jax.jit(jax.vmap(jax.grad(loss), in_axes=(None, 0)))(
        jp, jnp.asarray(x0s))
    return [jax.tree_util.tree_map(lambda a, b=b: a[b], g)
            for b in range(len(x0s))]


def _port_param_loss(tm, solve, params, x0s, per_member=()):
    rt = T.runtime(torch.as_tensor(x0s), params=params)
    rt["_per_member"] = per_member
    w0 = tm.cold_start(torch.as_tensor(x0s), params=params,
                       per_member=per_member).w
    res = solve(rt, w0)
    _, U, _ = tm.nlp.unpack(res.w)
    return ((U - TARGET_U) ** 2).sum(), res


@pytest.mark.parametrize("riccati", [True, False], ids=["riccati", "dense"])
def test_grad_wrt_shared_params_matches_jax(riccati):
    """A params tree shared by the batch: its gradient is the sum of the
    members' JAX gradients."""
    jm, tm, cfg, P = _mlp_pair()
    solve = T.make_differentiable_solver(tm.nlp, T.IPConfig(**cfg),
                                         direction=t_ric if riccati else None)
    params = [{k: torch.tensor(v, requires_grad=True) for k, v in
               layer.items()} for layer in P]
    x0s = np.array([[0.1, -0.1], [0.3, 0.0]], np.float32)
    loss, res = _port_param_loss(tm, solve, params, x0s)
    assert bool(res.converged.all())
    loss.backward()
    jg = _jax_param_grads(jm, cfg, P, riccati, x0s)
    for li, layer in enumerate(params):
        for k, t in layer.items():
            _close(t.grad.numpy(), sum(np.asarray(g[li][k]) for g in jg))


def test_grad_wrt_per_member_params_matches_jax():
    """Params stacked per member: each member's gradient is its own."""
    jm, tm, cfg, P = _mlp_pair()
    solve = T.make_differentiable_solver(tm.nlp, T.IPConfig(**cfg),
                                         direction=t_ric)
    x0s = np.array([[0.1, -0.1], [0.3, 0.0]], np.float32)
    params = [{k: torch.tensor(np.stack([v, v]), requires_grad=True)
               for k, v in layer.items()} for layer in P]
    _port_param_loss(tm, solve, params, x0s, per_member=("params",))[0] \
        .backward()
    jg = _jax_param_grads(jm, cfg, P, True, x0s)
    for li, layer in enumerate(params):
        for k, t in layer.items():
            for b in range(2):
                _close(t.grad[b].numpy(), np.asarray(jg[b][li][k]))


def test_unconverged_member_gets_no_gradient():
    """A member cut before convergence gets a zero gradient; the shared
    params gradient is then the converged member's alone."""
    jm, tm, cfg, P = _mlp_pair()
    x0s = np.array([[0.1, -0.1], [0.3, 0.0]], np.float32)
    params = [{k: torch.tensor(v, requires_grad=True) for k, v in
               layer.items()} for layer in P]
    full = T.make_differentiable_solver(tm.nlp, T.IPConfig(**cfg),
                                        direction=t_ric)
    _, res = _port_param_loss(tm, full, params, x0s)
    cut_at = int(res.iterations.min())      # member with fewer iterations
    slow = int(res.iterations.argmax())
    assert int(res.iterations[slow]) > cut_at
    cut = T.make_differentiable_solver(
        tm.nlp, T.IPConfig(**dict(cfg, max_iter=cut_at)), direction=t_ric)
    x0 = torch.tensor(x0s, requires_grad=True)
    rt = T.runtime(x0, params=params)
    rt["_per_member"] = ()
    out = cut(rt, tm.cold_start(x0.detach(), params=params).w)
    assert out.converged.tolist() == [i != slow for i in range(2)]
    _, U, _ = tm.nlp.unpack(out.w)
    ((U - TARGET_U) ** 2).sum().backward()
    assert float(x0.grad[slow].abs().max()) == 0.0
    assert float(x0.grad[1 - slow].abs().max()) > 0.0
    jg = _jax_param_grads(jm, cfg, P, True, x0s[1 - slow:2 - slow])[0]
    for li, layer in enumerate(params):
        for k, t in layer.items():
            _close(t.grad.numpy(), np.asarray(jg[li][k]))


def test_controller_differentiable_flag():
    """NMPC(differentiable=True): ``next_batch``'s plan carries a grad_fn,
    and the gradient of Σu² with respect to x0 is the JAX package's through
    its ``_step``."""
    cfg = dict(max_iter=60, tol=1e-6)
    jm = J.NMPC(J.jax_dynamics(_lv_j, 2, 1),
                J.StageCost(stage=lambda x, u: 1.1 * jnp.sum(u)
                            + 0.2 * jnp.sum(x ** 2)),
                [J.DomainConstraint(**RAW_BOX)], H=6, DT=0.1,
                integrator="rk4", config=J.IPConfig(**cfg),
                differentiable=True)
    tm = T.NMPC(T.torch_dynamics(_lv_t, 2, 1),
                T.StageCost(stage=lambda x, u: 1.1 * torch.sum(u)
                            + 0.2 * torch.sum(x ** 2)),
                [T.DomainConstraint(**RAW_BOX)], H=6, DT=0.1,
                integrator="rk4", config=T.IPConfig(**cfg),
                differentiable=True, device="cpu")
    x0s = torch.tensor(X0S, requires_grad=True)
    _, res = tm.next_batch(x0s)
    assert res.u.grad_fn is not None
    (res.u ** 2).sum().backward()

    def loss(x0):
        carry = jm.cold_start(jax.lax.stop_gradient(x0))
        _, r = jm._step(carry, J.runtime(x0))
        return jnp.sum(r.u ** 2)
    jg = np.asarray(jax.jit(jax.vmap(jax.grad(loss)))(jnp.asarray(X0S)))
    _close(x0s.grad.numpy(), jg)
