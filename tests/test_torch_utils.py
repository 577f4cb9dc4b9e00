"""The utilities (ROADMAP Queue 1 #15): checkpoints, the derivative
checker, timing, the build cache, phase profiling and the f64 KKT oracle,
in the port against the JAX package on the CPU.

* Checkpoints: the same ``.npz`` layout, so a params tree and a
  ``WarmStart`` the JAX package saves load into the port's structures and
  the reverse, bit for bit; a restored carry resumes the re-plan.
* ``check_model`` / ``check_problem``: on the same points, the port's
  reports agree with the JAX package's (the errors within 1e-3 absolute of
  each other: both are f32 autodiff against f64-stepped differences of an
  f32 function, and their errors are the f32 rounding of the differences)
  and catch a kink the same way.
* The oracle (``csrc/kkt_oracle.cpp``, built by the port's own binding):
  f64 residuals of a solved system under 1e-10, batched equal to single,
  equal to the JAX package's binding; ``refine_kkt_point`` polishes a
  solve of the port to the JAX package's refined point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.utils import check as jcheck
from pyneuralempc_tpu.utils import checkpoint as jckpt
from pyneuralempc_tpu.utils import native as jnative
from pyneuralempc_tpu_torch.ops.cuda import build
from pyneuralempc_tpu_torch.utils import native, profiling, timing

import _torch_threads  # noqa: F401  (one torch thread)

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


def _mpcs(H=8, jcost=None, tcost=None):
    jm = J.NMPC(J.jax_dynamics(_lv_j, 2, 1),
                jcost or (lambda x, u: jnp.sum(u * 1.1)),
                [J.DomainConstraint(**RAW_BOX)], H=H, DT=0.1)
    tm = T.NMPC(T.torch_dynamics(_lv_t, 2, 1),
                tcost or (lambda x, u: torch.sum(u * 1.1)),
                [T.DomainConstraint(**RAW_BOX)], H=H, DT=0.1, device="cpu")
    return jm, tm


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(3, 8)).astype(np.float32),
             "b": rng.normal(size=8).astype(np.float32)},
            {"w": rng.normal(size=(8, 2)).astype(np.float32),
             "b": rng.normal(size=2).astype(np.float32)}]


def test_checkpoint_roundtrip_params(tmp_path):
    params = T.mlp_params_from_numpy(_params(), device="cpu")
    path = str(tmp_path / "params.npz")
    T.save_pytree(path, params)
    loaded = T.load_pytree(path, params)
    for a, b in zip(params, loaded):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_checkpoint_params_cross_packages(tmp_path):
    P = _params(1)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in P]
    tp = T.mlp_params_from_numpy(P, device="cpu")
    jckpt.save_pytree(str(tmp_path / "j.npz"), jp)
    T.save_pytree(str(tmp_path / "t.npz"), tp)
    into_port = T.load_pytree(str(tmp_path / "j.npz"), tp)
    into_jax = jckpt.load_pytree(str(tmp_path / "t.npz"), jp)
    for layer, tl, jl in zip(P, into_port, into_jax):
        for k, v in layer.items():
            np.testing.assert_array_equal(tl[k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(jl[k]), v)


def test_checkpoint_warm_start_cross_packages(tmp_path):
    """A batched ``WarmStart`` of the JAX package loads into the port's and
    resumes the port's warm re-plan; the port's loads into the JAX
    package's; the port's own single-problem carry round-trips."""
    jm, tm = _mpcs()
    x0s = np.array([[0.3, 0.2], [0.1, -0.1]], np.float32)
    jcarry, _ = jm.next_batch(jnp.asarray(x0s))
    tcarry, tres = tm.next_batch(torch.as_tensor(x0s))
    jckpt.save_pytree(str(tmp_path / "j.npz"), jcarry)
    T.save_pytree(str(tmp_path / "t.npz"), tcarry)
    into_port = T.load_pytree(str(tmp_path / "j.npz"), tcarry)
    into_jax = jckpt.load_pytree(str(tmp_path / "t.npz"), jcarry)
    for a, b in zip(into_port, jcarry):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(into_jax, tcarry):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, res2 = tm.next_batch(torch.as_tensor(x0s), carry=into_port)
    assert bool(res2.converged.all())
    assert bool((res2.iterations <= tres.iterations).all())
    # next()'s instance carry (a leading axis of 1) round-trips
    tm.next(torch.tensor(x0s[0]))
    T.save_pytree(str(tmp_path / "one.npz"), tm._carry)
    back = T.load_pytree(str(tmp_path / "one.npz"), tm._carry)
    for a, b in zip(back, tm._carry):
        assert (a is None and b is None) or torch.equal(a, b)


def test_checkpoint_shape_validation(tmp_path):
    path = str(tmp_path / "bad.npz")
    T.save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        T.load_pytree(path, {"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        T.load_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(1)})


def _reports_agree(tr, jr, atol=1e-3):
    assert tr.keys() == jr.keys()
    assert tr["ok"] == jr["ok"]
    for k in tr:
        if k != "ok":
            assert abs(tr[k] - jr[k]) <= atol, (k, tr[k], jr[k])


def test_check_model_matches_jax():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.normal(size=(3, 2))).astype(np.float32)
    u = (0.3 * rng.normal(size=(3, 1))).astype(np.float32)
    tr = T.check_model(T.torch_dynamics(_lv_t, 2, 1), x=x, u=u,
                       device="cpu")
    jr = jcheck.check_model(J.jax_dynamics(_lv_j, 2, 1), x=jnp.asarray(x),
                            u=jnp.asarray(u))
    assert tr["ok"]
    _reports_agree(tr, jr)
    # a random point of its own
    assert T.check_model(T.torch_dynamics(_lv_t, 2, 1), device="cpu")["ok"]


def test_check_model_catches_nondifferentiable():
    x = np.array([[1e-5], [-1e-5], [0.0]], np.float32)
    u = np.zeros((3, 1), np.float32)
    tr = T.check_model(T.torch_dynamics(
        lambda x, u: torch.abs(x) * 1000.0 + u * 0, 1, 1), x=x, u=u,
        device="cpu")
    jr = jcheck.check_model(J.jax_dynamics(
        lambda x, u: jnp.abs(x) * 1000.0 + u * 0, 1, 1), x=jnp.asarray(x),
        u=jnp.asarray(u))
    # (the two frameworks' derivative of |x| at exactly 0 differ, 0 in
    # torch and 1 in JAX, so the errors are 990 and 1000)
    assert not tr["ok"] and not jr["ok"]
    assert tr["jac_x_abs_err"] > 900 and jr["jac_x_abs_err"] > 900


def test_check_problem_matches_jax():
    jm, tm = _mpcs(5, lambda x, u: jnp.sum(u * 1.1) + jnp.sum(x ** 2),
                   lambda x, u: torch.sum(u * 1.1) + torch.sum(x ** 2))
    tr = T.check_problem(tm, [0.3, 0.2])
    jr = jcheck.check_problem(jm, jnp.array([0.3, 0.2]))
    assert tr["ok"]
    _reports_agree(tr, jr)


def test_time_fn_reports():
    stats = timing.time_fn(lambda x: x * 2, torch.ones(16), warmup=1,
                           iters=3)
    assert stats["p50"] > 0 and stats["min"] <= stats["p50"]
    assert stats["iters"] == 3


def test_compilation_cache_points_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    default = str(build.BUILD_DIR)
    monkeypatch.delenv("NEMPC_COMPILE_CACHE", raising=False)
    assert T.enable_compilation_cache() == default
    got = T.enable_compilation_cache(str(tmp_path))
    assert got == str(tmp_path) and build.BUILD_DIR == tmp_path
    src = build.CSRC_DIR / "riccati_sweep.cu"
    assert build.library_path(src).parent == tmp_path


def test_profile_solver_phases():
    _, tm = _mpcs(6)
    x0s = torch.tensor([[0.3, 0.2], [0.1, -0.1]])
    prof = profiling.profile_solver(tm, x0s, iters=2)
    assert set(prof) == {"residuals+grad", "stage blocks", "KKT sweep",
                         "direction(blocks+sweep)", "line-search fan",
                         "full warm step"}
    assert all(v > 0 for v in prof.values())


def _kkt(seed, B=None, n=12, m=7):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    Wr = rng.normal(size=lead + (n, n)).astype(np.float32)
    W = (Wr + np.swapaxes(Wr, -1, -2)) / 2
    return (W, rng.uniform(0.1, 2.0, lead + (n,)).astype(np.float32),
            rng.normal(size=lead + (m, n)).astype(np.float32),
            rng.normal(size=lead + (n,)).astype(np.float32),
            rng.normal(size=lead + (m,)).astype(np.float32))


def test_oracle_solves_random_kkt():
    W, S, A, r, c = _kkt(0)
    dw, dlam = native.solve_kkt_oracle(W, S, A, r, c, delta_w=1.0)
    Hk = W.astype(np.float64) + np.diag(S.astype(np.float64)) + np.eye(12)
    assert np.abs(Hk @ dw + A.astype(np.float64).T @ dlam + r).max() < 1e-10
    assert np.abs(A.astype(np.float64) @ dw + c).max() < 1e-10
    jdw, jdlam = jnative.solve_kkt_oracle(W, S, A, r, c, delta_w=1.0)
    np.testing.assert_array_equal(dw, jdw)
    np.testing.assert_array_equal(dlam, jdlam)
    # tensors in, the same answer
    tdw, _ = native.solve_kkt_oracle(*(torch.as_tensor(a) for a in
                                       (W, S, A, r, c)), delta_w=1.0)
    np.testing.assert_array_equal(tdw, dw)


def test_oracle_batched_equals_single():
    W, S, A, r, c = _kkt(1, B=4, n=6, m=3)
    dw, dlam = native.solve_kkt_oracle(W, S, A, r, c, delta_w=2.0)
    for b in range(4):
        dw1, dl1 = native.solve_kkt_oracle(W[b], S[b], A[b], r[b], c[b],
                                           delta_w=2.0)
        np.testing.assert_allclose(dw[b], dw1, rtol=1e-12)
        np.testing.assert_allclose(dlam[b], dl1, rtol=1e-12)


def test_refine_kkt_point_matches_jax():
    """The port's solve of a feeding LV plan, refined by f64 active-set
    Newton steps on the port's own f32 NLP functions, lands where the JAX
    package's ``refine_kkt_point`` takes the same start on its NLP."""
    jm, tm = _mpcs(6, lambda x, u: jnp.sum(u * 1.1) + 0.2 * jnp.sum(x ** 2),
                   lambda x, u: torch.sum(u * 1.1) + 0.2 * torch.sum(x ** 2))
    res = tm.next(torch.tensor([0.3, 0.2]))
    w0 = tm._carry.w[0].numpy()
    trt, jrt = T.runtime(torch.tensor([0.3, 0.2])), J.runtime(
        jnp.array([0.3, 0.2]))
    tn, jn = tm.nlp, jm.nlp
    tw = native.refine_kkt_point(
        w0, lambda w: torch.func.grad(tn.objective)(w, trt),
        lambda w: tn.constraints(w, trt),
        lambda w: torch.func.jacrev(tn.constraints)(w, trt),
        lambda w, lam: torch.func.hessian(
            lambda ww: tn.lagrangian(ww, lam, trt))(w),
        tn.lower.numpy(), tn.upper.numpy())
    jw = jnative.refine_kkt_point(
        w0, lambda w: jax.grad(jn.objective)(jnp.asarray(w), jrt),
        lambda w: jn.constraints(jnp.asarray(w), jrt),
        lambda w: jax.jacrev(jn.constraints)(jnp.asarray(w), jrt),
        lambda w, lam: jax.hessian(
            lambda ww: jn.lagrangian(ww, jnp.asarray(lam), jrt))(
                jnp.asarray(w)),
        np.asarray(jn.lower), np.asarray(jn.upper))
    assert bool(res.converged)
    np.testing.assert_allclose(tw, jw, atol=1e-5)
    c = tn.constraints(torch.as_tensor(tw, dtype=torch.float32), trt)
    assert float(c.abs().max()) <= 1e-5
