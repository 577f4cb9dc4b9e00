"""The dense KKT backend (ROADMAP Queue 1 #10): the port's ``kkt_step`` and
``make_dense_direction`` against the JAX package's dense backend and the
port's f64 oracle, and whole solves under ``kkt="dense"`` against the JAX
package, on the CPU.

* ``kkt_step`` on seeded batches of (W, Σ, A, r̃, r_p): against the JAX
  package's own dense ``solve_blocks`` (taken from a JAX solver's closure,
  vmapped) to 1e-5·max(1, |ref|), and against the f64 oracle
  (``csrc/kkt_oracle.cpp`` through the port's binding) at the δ_w the f64
  curvature test picks, to 1e-4·max(1, |ref|).  One case has negative
  curvature along its δ_w = 0 step on some members, so they take δ_w > 0.
  The cases are well conditioned (cond(K) ≤ 5e3, asserted).
* bench.py's LV problem on the plant's own dynamics (the normalised
  Lotka-Volterra ODE, H=10, B=4 starts near the prey bound, so every plan
  feeds) under ``kkt="dense"``, the same problem with a move-suppression cost
  1e-3·Σ(u_{t+1} − u_t)² (stage-coupled, so ``kkt="auto"`` falls to dense)
  and the raw LV problem with 65 trajectory-level rows: converged
  masks and per-member iteration counts equal, |u_port − u_jax|∞ ≤ 1e-4,
  cold and one warm re-plan.  The three Hessian modes too.
* The H ≥ 30 warning of ``kkt="auto"`` on a stage-coupled cost.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.solve.interior_point import make_solver as j_make_solver
from pyneuralempc_tpu_torch.solve import interior_point as tip
from pyneuralempc_tpu_torch.utils.native import solve_kkt_oracle

import _torch_threads  # noqa: F401  (one torch thread)
from _torch_lv import (BENCH_CFG, BOX, REG, glorot_params, lv_true_jax,
                       lv_true_torch, x0_batch)

H, B = 10, 4
DU_TOL = 1e-4
KKT_TOL = 1e-5        # port against JAX, f32 both
ORACLE_TOL = 1e-4     # f32 port against the f64 oracle
# Two f32 LU solves agree to ~cond(K)·ε (one refinement pass): the seeded
# cases keep cond(K) under this at the accepted δ_w (a member of seed 3
# at cond 1.1e3 puts both packages 2e-5 from the oracle and 1.1e-5 apart)
MAX_COND = 5e3
MOVE = 1e-3           # move-suppression weight


def _jax_dense_solve_blocks(n, m):
    """The JAX package's dense ``solve_blocks`` (its ``kkt_step`` on given
    blocks) for n variables and m rows, from the closure of a dense JAX
    solver built for an NLP of those sizes, vmapped."""
    nlp = J.NLP(spec=None, n=n, m=m, objective=lambda w, rt: jnp.sum(w),
                constraints=lambda w, rt: w[:m], lower=jnp.full((n,), -1.0),
                upper=jnp.full((n,), 1.0), pack=None, unpack=None)
    solve = j_make_solver(nlp, J.IPConfig())
    cells = dict(zip(solve.__code__.co_freevars,
                     (c.cell_contents for c in solve.__closure__)))
    sb = cells["direction_fn"].solve_blocks

    def batched(W, Sigma, A, r, c, retry=True):
        return jax.vmap(lambda *a: sb((a[0], a[2]), a[1], a[3], a[4],
                                      retry=retry))(W, Sigma, A, r, c)
    return batched


def _lv_jax(x, u):
    return jnp.concatenate(
        [0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
         -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], axis=1)


def _kkt_case(seed, Bn=6, n=12, m=5, indefinite=False):
    """Seeded (W, Σ, A, r̃, r_p): W symmetric (with negative eigenvalues of
    size ~3 when ``indefinite``, on every other member), Σ positive."""
    rng = np.random.default_rng(seed)
    Wr = rng.normal(size=(Bn, n, n)).astype(np.float32)
    W = 0.5 * (Wr + Wr.transpose(0, 2, 1)) + 4.0 * np.eye(n, dtype=np.float32)
    if indefinite:
        W[::2] -= 9.0 * np.eye(n, dtype=np.float32)
    Sigma = rng.uniform(0.1, 2.0, (Bn, n)).astype(np.float32)
    A = rng.normal(size=(Bn, m, n)).astype(np.float32)
    r = rng.normal(size=(Bn, n)).astype(np.float32)
    c = rng.normal(size=(Bn, m)).astype(np.float32)
    return W, Sigma, A, r, c


def _oracle_at_accepted_delta(W, Sigma, A, r, c, delta_c=1e-8):
    """The f64 oracle's step at the first δ_w of the ladder whose f64 step
    has Δwᵀ(W + Σ + δ_w I)Δw ≥ 1e-10‖Δw‖²: (dw, dlam, δ_w) per member."""
    out = []
    for b in range(W.shape[0]):
        for delta in tip._DELTAS:
            dw, dlam = solve_kkt_oracle(W[b], Sigma[b], A[b], r[b], c[b],
                                        delta_w=delta, delta_c=delta_c)
            Hk = (W[b].astype(np.float64) + np.diag(Sigma[b].astype(
                np.float64)) + delta * np.eye(W.shape[1]))
            if dw @ Hk @ dw >= 1e-10 * (dw @ dw):
                break
        out.append((dw, dlam, delta))
    return out


def _cond(W, Sigma, A, delta, delta_c=1e-8):
    """cond(K) in f64 at the accepted δ_w."""
    n, m = W.shape[0], A.shape[0]
    Hk = (W.astype(np.float64) + np.diag(Sigma.astype(np.float64))
          + delta * np.eye(n))
    return np.linalg.cond(np.block([[Hk, A.T], [A, -delta_c * np.eye(m)]]))


def _scaled(got, ref):
    ref = np.asarray(ref, np.float64)
    return float((np.abs(np.asarray(got, np.float64) - ref)
                  / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize("indefinite", [False, True])
def test_kkt_step_matches_jax_and_the_oracle(indefinite):
    W, Sigma, A, r, c = _kkt_case(5 if indefinite else 2,
                                  indefinite=indefinite)
    dw, dlam, ok = tip.kkt_step(*(torch.as_tensor(a) for a in
                                  (W, Sigma, A, r, c)))
    jdw, jdlam, jok = _jax_dense_solve_blocks(12, 5)(
        *(jnp.asarray(a) for a in (W, Sigma, A, r, c)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert bool(ok.all())
    assert _scaled(dw.numpy(), jdw) <= KKT_TOL
    assert _scaled(dlam.numpy(), jdlam) <= KKT_TOL
    ref = _oracle_at_accepted_delta(W, Sigma, A, r, c)
    deltas = [d for *_, d in ref]
    assert (max(deltas) > 0) == indefinite, deltas
    for b, (odw, odlam, delta) in enumerate(ref):
        assert _cond(W[b], Sigma[b], A[b], delta) <= MAX_COND, b
        assert _scaled(dw[b].numpy(), odw) <= ORACLE_TOL, b
        assert _scaled(dlam[b].numpy(), odlam) <= ORACLE_TOL, b


def test_kkt_step_without_retry_is_delta_zero():
    """``retry=False`` is one δ_w = 0 solve: the indefinite members keep
    their (negative-curvature) step with ok False, as in the JAX package."""
    W, Sigma, A, r, c = _kkt_case(3, indefinite=True)
    dw, _, ok = tip.kkt_step(*(torch.as_tensor(a) for a in
                               (W, Sigma, A, r, c)), retry=False)
    jdw, _, jok = _jax_dense_solve_blocks(12, 5)(
        *(jnp.asarray(a) for a in (W, Sigma, A, r, c)), retry=False)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert not bool(ok.all()) and bool(ok.any())
    assert _scaled(dw.numpy(), jdw) <= KKT_TOL
    odw, _ = solve_kkt_oracle(W, Sigma, A, r, c, delta_c=1e-8)
    assert _scaled(dw.numpy(), odw) <= ORACLE_TOL


def test_singular_system_fails_cleanly():
    """A zero Jacobian row with δ_c = 0 makes K singular at every δ_w: the
    member's ok is False and the others solve."""
    W, Sigma, A, r, c = _kkt_case(4, Bn=3)
    A[1, 0] = 0.0
    dw, dlam, ok = tip.kkt_step(*(torch.as_tensor(a) for a in
                                  (W, Sigma, A, r, c)), delta_c=0.0)
    assert ok.tolist() == [True, False, True]


def _mpcs(H_, cfg, cost_j=None, cost_t=None):
    """The normalised LV plant itself (no surrogate: its plans feed the
    predator at the prey bound) with bench.py's box and cost in both
    packages."""
    cost_j = cost_j or (lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u))
    cost_t = cost_t or (lambda x, u: 1.1 * torch.sum(u)
                        + REG * torch.sum(u * u))
    jm = J.NMPC(J.jax_dynamics(lv_true_jax, 2, 1), cost_j,
                [J.DomainConstraint(**BOX)], H=H_, DT=0.1, integrator="rk4",
                config=J.IPConfig(**cfg))
    tm = T.NMPC(T.torch_dynamics(lv_true_torch, 2, 1), cost_t,
                [T.DomainConstraint(**BOX)], H=H_, DT=0.1, integrator="rk4",
                config=T.IPConfig(**cfg), device="cpu")
    return jm, tm


# starts near the prey bound: every plan feeds the predator early
LV_X0S = np.array([[0.9, -0.5], [0.8, -0.6], [0.7, -0.4], [0.85, -0.45]],
                  np.float32)


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


def _cold_and_warm(jm, tm, xs):
    jc, jres = jm.next_batch(jnp.asarray(xs))
    tc, tres = tm.next_batch(torch.as_tensor(xs))
    _compare(jres, tres)
    xs = np.array(jres.x[:, 0], np.float32)
    _, jres2 = jm.next_batch(jnp.asarray(xs), carry=jc)
    _, tres2 = tm.next_batch(torch.as_tensor(xs), carry=tc)
    _compare(jres2, tres2)
    # the plans are not trivial: they feed
    assert float(tres.u.max()) > 0.1
    return tres, tres2


@pytest.mark.parametrize("hessian", ["exact", "objective", "gauss_newton"])
def test_lv_fleet_dense_matches_jax(hessian):
    jm, tm = _mpcs(H, dict(BENCH_CFG, kkt="dense", hessian=hessian))
    assert tm.kkt_backend == jm.kkt_backend == "dense"
    _cold_and_warm(jm, tm, LV_X0S)


def _moves_j(x, u):
    return (1.1 * jnp.sum(u) + REG * jnp.sum(u * u)
            + MOVE * jnp.sum((u[1:] - u[:-1]) ** 2))


def _moves_t(x, u):
    return (1.1 * torch.sum(u) + REG * torch.sum(u * u)
            + MOVE * torch.sum((u[1:] - u[:-1]) ** 2))


def test_move_suppression_falls_dense_and_matches_jax():
    """A stage-coupled cost probes non-separable: ``kkt="auto"`` takes the
    dense backend in both packages, with the same plans."""
    jm, tm = _mpcs(H, BENCH_CFG, _moves_j, _moves_t)
    assert tm.kkt_backend == jm.kkt_backend == "dense"
    cold, warm = _cold_and_warm(jm, tm, LV_X0S)
    assert bool(cold.converged.all()) and bool(warm.converged.all())


def test_dense_equals_riccati_on_a_separable_problem():
    """The same separable problem (a declared StageCost) under
    kkt="dense" and kkt="riccati" in the port: the same plans (two
    different linear algebras)."""
    P = T.mlp_params_from_numpy(glorot_params(0), device="cpu")
    xs = torch.as_tensor(x0_batch(B, seed=3))
    cost = T.StageCost(stage=lambda x, u: 1.1 * torch.sum(u)
                       + REG * torch.sum(u * u))
    out = {}
    for kkt in ("dense", "riccati"):
        tm = T.NMPC(T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                    cost, [T.DomainConstraint(**BOX)], H=H, DT=0.1,
                    config=T.IPConfig(**dict(BENCH_CFG, kkt=kkt)),
                    device="cpu")
        assert tm.kkt_backend == kkt
        _, out[kkt] = tm.next_batch(xs, params=P)
    assert bool(out["dense"].converged.all())
    assert torch.equal(out["dense"].converged, out["riccati"].converged)
    assert float((out["dense"].u - out["riccati"].u).abs().max()) <= DU_TOL


def test_more_than_64_border_rows_take_dense():
    """65 trajectory-level rows (each control repeated, ≥ −0.5, binding
    where the cost drives u down): past 64 the border stops being low-rank,
    so both packages solve it dense."""
    jrows = J.PathConstraint(fn=lambda x, u: jnp.tile(u.reshape(-1), 9)[:65],
                             dim=65, lb=(-0.5,) * 65, ub=(np.inf,) * 65)
    trows = T.PathConstraint(fn=lambda x, u: u.reshape(-1).repeat(9)[:65],
                             dim=65, lb=(-0.5,) * 65, ub=(np.inf,) * 65)
    box = dict(states_constraint=[[-2.0, 2.0]] * 2,
               control_constraint=[[-1.0, 1.0]])
    jm = J.NMPC(J.jax_dynamics(_lv_jax, 2, 1),
                lambda x, u: 1.1 * jnp.sum(u) + 0.1 * jnp.sum(x ** 2),
                [J.DomainConstraint(**box), jrows], H=8, DT=0.1,
                config=J.IPConfig(tol=1e-6, max_iter=80))
    tm = T.NMPC(T.torch_dynamics(_lv_torch, 2, 1),
                lambda x, u: 1.1 * torch.sum(u) + 0.1 * torch.sum(x ** 2),
                [T.DomainConstraint(**box), trows], H=8, DT=0.1,
                config=T.IPConfig(tol=1e-6, max_iter=80), device="cpu")
    assert tm.kkt_backend == jm.kkt_backend == "dense"
    xs = np.array([[0.3, 0.2], [0.1, -0.1], [0.2, 0.4]], np.float32)
    _, jres = jm.next_batch(jnp.asarray(xs))
    _, tres = tm.next_batch(torch.as_tensor(xs))
    _compare(jres, tres)
    assert bool(tres.converged.all())
    assert float(tres.u.min()) >= -0.5 - 1e-4


def _lv_torch(x, u):
    return torch.cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                      -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]],
                     dim=1)


def test_coupled_cost_warns_at_long_horizons():
    """The JAX package's H ≥ 30 warning on a stage-coupled cost under
    kkt="auto"; short horizons stay silent; kkt="dense" never warns."""
    model = T.torch_dynamics(_lv_torch, x_dim=2, u_dim=1)
    box = T.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                             control_constraint=[[-1.0, 1.0]])

    def coupled(x, u):
        return torch.sum(u ** 2) + torch.sum((u[1:] - u[:-1]) ** 2)

    with pytest.warns(UserWarning, match="dense"):
        mpc = T.NMPC(model, coupled, [box], H=30, DT=0.05, device="cpu")
    assert mpc.kkt_backend == "dense"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        short = T.NMPC(model, coupled, [box], H=6, DT=0.05, device="cpu")
        forced = T.NMPC(model, coupled, [box], H=30, DT=0.05, device="cpu",
                        config=T.IPConfig(kkt="dense"))
    assert short.kkt_backend == forced.kkt_backend == "dense"
    res = short.next(torch.tensor([0.3, 0.2]))
    assert bool(res.converged)
