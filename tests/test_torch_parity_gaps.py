"""The port's last parity gaps against the JAX package, on the CPU.

* F7: on CUDA, ``kernel_plan`` sends every shape outside the kernels'
  envelope (nx > 32, nu > 16, R > 65, r > nu) to ``"plain_fallback"``,
  naming each cap it exceeds, where the JAX package's plan takes its scan;
  ``riccati_sweep`` / ``riccati_sweep_general`` on such a plan run the
  plain version, count ``FALLBACK_CALLS`` and warn once a shape (the plan
  is asked for "cuda" here, so that the CPU tensors take that route), and
  agree with the JAX package's scan reference within 2e-5.
* F8: ``next_batch(batch_chunk=)`` solves the batch in slices: within
  1e-5 relative of the whole solve (the F6 bound of a member solved in
  another batch), the JAX package's chunked solve within 1e-4 with equal
  masks and iterations, cold and warm, with per-member params; a chunk
  that does not divide the batch raises ``ValueError``.
* F9: ``riccati_sweep_general``'s and ``enable_compilation_cache``'s
  defaults are the JAX package's; at its defaults the general sweep is the
  plain sweep; ``riccati_sweep_general_ref`` is exported; the profiling
  CLI runs on the CPU and fails where it finds no card.
* BASELINE config 1 (the known LV ODE, Euler, H=10, one ``NMPC.next``)
  against the JAX package within 1e-4.
"""

import functools
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.ops.pallas import riccati_kernel as jrk
from pyneuralempc_tpu.solve import riccati as jriccati
from pyneuralempc_tpu.utils import compile_cache as jcache
from pyneuralempc_tpu_torch.examples import lotka_volterra as tlv
from pyneuralempc_tpu_torch.ops.cuda import build
from pyneuralempc_tpu_torch.ops.cuda import riccati_general as rg
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import (general_sweep_case,
                                                         sweep_case)
from pyneuralempc_tpu_torch.solve import riccati as triccati
from pyneuralempc_tpu_torch.utils import compile_cache as tcache
from pyneuralempc_tpu_torch.utils import profiling

from _torch_lv import glorot_params, jax_params
import _torch_threads  # noqa: F401  (one torch thread)

ATOL = 2e-5          # the JAX kernel tests' own sweep tolerance (f32)
DU_TOL = 1e-4
CHUNK_RTOL = 1e-5    # F6: a member's result in another batch
BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
           control_constraint=[[-1.0, 1.0]])

# (H, nx, nu, R, r) outside every CUDA kernel, with the cap each exceeds
OUT_OF_ENVELOPE = (((100, 34, 1, 1, 0), ["nx=34 > 32"]),
                   ((50, 12, 17, 1, 0), ["nu=17 > 16"]),
                   ((20, 2, 1, 66, 0), ["R=66 > 65"]),
                   ((50, 12, 4, 2, 5), ["r=5 > nu=4"]),
                   ((10, 40, 20, 70, 21), ["nx=40 > 32", "nu=20 > 16",
                                           "R=70 > 65", "r=21 > nu=20"]))


@pytest.mark.parametrize("shape,caps", OUT_OF_ENVELOPE)
def test_kernel_plan_falls_back_where_jax_takes_its_scan(shape, caps):
    H, nx, nu, R, r = shape
    plan = rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)
    assert plan["path"] == "plain_fallback"
    for cap in caps:
        assert cap in plan["reason"]
    # a pure function of its arguments
    assert plan == rk.kernel_plan(H, nx, nu, torch.device("cuda:0"), R=R,
                                  r=r)
    assert rk.kernel_plan(H, nx, nu, "cpu", R=R, r=r)["path"] == "plain"
    assert rk.kernel_plan(0, nx, nu, "cuda", R=R, r=r)["path"] == \
        "unsupported"
    assert jrk.kernel_plan(H, nx, nu, R, r)["path"] in ("scan",
                                                        "scan_chunked")


def _plan_as_on_card(monkeypatch):
    """Every plan asked for the CPU answered as for "cuda", so that CPU
    tensors of an out-of-envelope shape take the fallback route."""
    real = rk.kernel_plan

    def plan(H, nx, nu, device, R=1, r=0):
        return real(H, nx, nu, "cuda", R=R, r=r)
    monkeypatch.setattr(rk, "kernel_plan", plan)
    monkeypatch.setattr(rg, "kernel_plan", plan)
    monkeypatch.setattr(rk, "_WARNED", set())


def test_riccati_sweep_falls_back_once_a_shape(monkeypatch):
    """nu=17 and nx=33: the plain sweep, each shape's first call warns,
    FALLBACK_CALLS counts every call, the result is the JAX package's scan
    reference's."""
    _plan_as_on_card(monkeypatch)
    for nx, nu in ((4, 17), (33, 2)):
        args = sweep_case("delta_per_problem", B=3, H=4, nx=nx, nu=nu,
                          seed=nx)
        n0 = rk.FALLBACK_CALLS
        with pytest.warns(UserWarning, match=f"nx={nx}, nu={nu}") as rec:
            out = rk.riccati_sweep(*[torch.as_tensor(a) for a in args])
        assert "outside every CUDA kernel's envelope" in str(rec[0].message)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            again = rk.riccati_sweep(*[torch.as_tensor(a) for a in args])
        assert rk.FALLBACK_CALLS == n0 + 2
        ref = jax.vmap(jriccati.riccati_sweep_ref)(
            *[jnp.asarray(a) for a in args])
        for o, a, r in zip(out, again, ref):
            assert torch.equal(o, a)
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                       rtol=0)


def _jax_general(args):
    """The JAX package's general scan reference, vmapped, on numpy inputs
    in the port's batch-first layout (mx, mu, c, h lead with B, then H)."""
    A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, Jx = [jnp.asarray(a)
                                                      for a in args]
    rhs = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731  (B,H,R,·)->(B,R,H,·)
    out = jax.vmap(jriccati.riccati_sweep_general_ref)(
        A, Bm, G, M, rhs(mx), rhs(mu), rhs(c), delta, dc, E, F, rhs(h), Jx)
    return [np.swapaxes(np.asarray(o), 1, 2) for o in out[:4]] + [
        np.asarray(out[4])]


@pytest.mark.parametrize("shape", [(4, 2, 1, 66, 0), (4, 4, 2, 2, 3)])
def test_riccati_sweep_general_falls_back_once_a_shape(monkeypatch, shape):
    """R=66 right-hand sides and r=3 > nu=2 equality rows: the plain
    general sweep, one warning, every call counted, the JAX package's scan
    reference's result."""
    _plan_as_on_card(monkeypatch)
    H, nx, nu, R, r = shape
    args = general_sweep_case("delta0", B=3, H=H, nx=nx, nu=nu, R=R, r=r,
                              seed=R)
    args[8][:] = 0.1     # δ_c: r > nu rows leave S singular without it
    n0 = rk.FALLBACK_CALLS
    with pytest.warns(UserWarning, match=f"R={R}, r={r}"):
        out = rg.riccati_sweep_general(*[torch.as_tensor(a) for a in args])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rg.riccati_sweep_general(*[torch.as_tensor(a) for a in args])
    assert rk.FALLBACK_CALLS == n0 + 2
    ref = _jax_general(args)
    np.testing.assert_array_equal(out[4].numpy(), ref[4])
    ok = out[4].numpy()
    for o, want in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.numpy()[ok], want[ok], atol=ATOL,
                                   rtol=0)


def test_cho_solve_is_cholesky_solve():
    """The plain sweeps' two triangular solves (capturable in a CUDA graph
    on the card, where ``torch.cholesky_solve`` goes through MAGMA) solve
    L Lᵀ Z = X as ``torch.cholesky_solve`` does."""
    rng = np.random.default_rng(2)
    Q = rng.normal(size=(6, 5, 5)).astype(np.float32)
    Q = torch.as_tensor(Q @ Q.transpose(0, 2, 1)) + 5 * torch.eye(5)
    L = torch.linalg.cholesky(Q)
    X = torch.as_tensor(rng.normal(size=(6, 5, 3)).astype(np.float32))
    torch.testing.assert_close(rk.cho_solve(X, L),
                               torch.cholesky_solve(X, L), rtol=1e-5,
                               atol=1e-6)


def test_inside_the_envelope_nothing_falls_back():
    """Every plan a kernel takes keeps its kernel: no fallback at the
    paths' shapes."""
    for H, nx, nu, R, r in ((20, 2, 1, 1, 0), (50, 12, 4, 1, 0),
                            (100, 18, 1, 1, 0), (100, 28, 4, 1, 0),
                            (100, 32, 16, 1, 0),
                            (50, 12, 4, 2, 1), (20, 2, 1, 2, 0),
                            (10, 32, 16, 65, 16)):
        assert rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)["path"] \
            .startswith("cuda_")


def _chunk_mpcs():
    """A per-member-params MLP fleet (the multi-member tests' problem) in
    both packages."""
    jsur = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    tsur = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    jm = J.NMPC(jsur, J.StageCost(stage=lambda x, u: jnp.sum(u ** 2)
                                  + jnp.sum((x - 0.2) ** 2)),
                [J.DomainConstraint(**BOX)], H=5, DT=0.1, integrator="rk4",
                config=J.IPConfig(tol=1e-5))
    tm = T.NMPC(tsur, T.StageCost(stage=lambda x, u: torch.sum(u ** 2)
                                  + torch.sum((x - 0.2) ** 2)),
                [T.DomainConstraint(**BOX)], H=5, DT=0.1, integrator="rk4",
                config=T.IPConfig(tol=1e-5), device="cpu")
    return jm, tm


def _fields(tup):
    """(name, tensor) of every tensor field of a carry or a result."""
    return [(k, v) for k, v in zip(tup._fields, tup)
            if isinstance(v, torch.Tensor)]


def test_next_batch_batch_chunk_matches_whole_and_jax():
    B, chunk = 16, 4
    jm, tm = _chunk_mpcs()
    sets = [glorot_params(s, (3, 8, 2)) for s in range(B)]
    stacked = [{k: np.stack([t[i][k] for t in sets]) for k in sets[0][i]}
               for i in range(2)]
    jp = jax_params(stacked)
    tp = T.mlp_params_from_numpy(stacked, device="cpu")
    rng = np.random.default_rng(5)
    xs = rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32)
    jc, tc, tc_whole = None, None, None
    for step in range(2):
        jc, jres = jm.next_batch(jnp.asarray(xs), params=jp, carry=jc,
                                 batch_chunk=chunk)
        tc_new, tres = tm.next_batch(torch.as_tensor(xs), params=tp,
                                     carry=tc, batch_chunk=chunk)
        wc, wres = tm.next_batch(torch.as_tensor(xs), params=tp,
                                 carry=tc_whole)
        for got, whole in ((tres, wres), (tc_new, wc)):
            assert [k for k, _ in _fields(got)] == [k for k, _ in
                                                    _fields(whole)]
            for (k, g), (_, w) in zip(_fields(got), _fields(whole)):
                assert g.shape == w.shape, k
                if g.dtype == torch.bool or not g.is_floating_point():
                    assert torch.equal(g, w), k
                else:
                    torch.testing.assert_close(g, w, rtol=CHUNK_RTOL,
                                               atol=1e-7, msg=k)
        np.testing.assert_array_equal(tres.converged.numpy(),
                                      np.asarray(jres.converged))
        np.testing.assert_array_equal(tres.iterations.numpy(),
                                      np.asarray(jres.iterations))
        assert np.abs(tres.u.numpy() - np.asarray(jres.u)).max() <= DU_TOL
        assert bool(tres.converged.all())
        tc, tc_whole = tc_new, wc
        xs = np.array(jres.x[:, 0], np.float32)
    # 0, None and a chunk of at least B are one whole solve
    for whole in (0, None, B, 2 * B):
        _, res = tm.next_batch(torch.as_tensor(xs), params=tp,
                               batch_chunk=whole)
        assert res.u.shape == (B, 5, 1)
    for pkg, mpc, arr in ((J, jm, jnp.asarray), (T, tm, torch.as_tensor)):
        with pytest.raises(ValueError,
                           match="batch 16 not divisible by batch_chunk 5"):
            mpc.next_batch(arr(xs), batch_chunk=5)


def test_next_batch_batch_chunk_slices_shared_inputs_whole():
    """Shared params go to every slice whole; a per-member p is sliced."""
    B = 6
    jm, tm = _chunk_mpcs()
    tp = T.mlp_params_from_numpy(glorot_params(0, (3, 8, 2)), device="cpu")
    xs = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.5, 0.5, (B, 2)).astype(np.float32))
    _, whole = tm.next_batch(xs, params=tp)
    _, chunked = tm.next_batch(xs, params=tp, batch_chunk=3)
    torch.testing.assert_close(chunked.u, whole.u, rtol=CHUNK_RTOL,
                               atol=1e-7)
    assert torch.equal(chunked.converged, whole.converged)


def test_signatures_match_jax():
    def defaults(fn):
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults(triccati.riccati_sweep_general) == defaults(
        jriccati.riccati_sweep_general) == {
        "delta_c": 1e-8, "E": None, "F": None, "h": None, "Jx": None}
    assert defaults(tcache.enable_compilation_cache) == defaults(
        jcache.enable_compilation_cache)
    assert list(inspect.signature(tcache.enable_compilation_cache)
                .parameters) == list(inspect.signature(
                    jcache.enable_compilation_cache).parameters)
    assert triccati.riccati_sweep_general_ref is rg.riccati_sweep_general_plain
    assert "riccati_sweep_general_ref" in triccati.__all__
    assert hasattr(jriccati, "riccati_sweep_general_ref")


def test_enable_compilation_cache_takes_min_compile_time(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert tcache.enable_compilation_cache(str(tmp_path), 30.0) == \
        str(tmp_path)
    assert build.BUILD_DIR == tmp_path


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature"])
def test_general_sweep_at_its_defaults_is_the_plain_sweep(kind):
    """No equality rows (E=None) and one right-hand side: the plain sweep's
    result and ok flags, and the JAX package's general reference at its
    own defaults."""
    args = [torch.as_tensor(a) for a in sweep_case(kind, B=5, H=6, nx=3,
                                                   nu=2, seed=7)]
    A, Bm, G, M, mx, mu, c, delta = args
    rhs = lambda t: t[:, :, None].contiguous()  # noqa: E731
    dX, dU, dLam, dNu, ok = triccati.riccati_sweep_general(
        A, Bm, G, M, rhs(mx), rhs(mu), rhs(c), delta)
    ref = triccati.riccati_sweep_ref(*args)
    assert dNu.shape == (5, 6, 1, 0)
    assert torch.equal(ok, ref[3])
    for o, r in zip((dX, dU, dLam), ref[:3]):
        np.testing.assert_allclose(o[:, :, 0].numpy()[ok.numpy()],
                                   r.numpy()[ok.numpy()], atol=ATOL, rtol=0)
    jout = jax.vmap(jriccati.riccati_sweep_general_ref)(
        *[jnp.asarray(t.numpy()) for t in (A, Bm, G, M)],
        *[jnp.asarray(t.numpy())[:, None] for t in (mx, mu, c)],
        jnp.asarray(delta.numpy()))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jout[4]))
    for o, r in zip((dX, dU, dLam), jout[:3]):
        np.testing.assert_allclose(o[:, :, 0].numpy()[ok.numpy()],
                                   np.asarray(r)[:, 0][ok.numpy()],
                                   atol=ATOL, rtol=0)


def test_profiling_cli_on_the_cpu(monkeypatch, capsys):
    """``python -m pyneuralempc_tpu_torch.utils.profiling --cpu`` at
    PROF_BATCH=8, PROF_H=5, each phase timed once (the CLI's own part is the
    fleet, the device and the table; profile_solver's medians have their
    own test)."""
    monkeypatch.setenv("PROF_BATCH", "8")
    monkeypatch.setenv("PROF_H", "5")
    monkeypatch.setattr(profiling, "profile_solver", functools.partial(
        profiling.profile_solver, iters=1))
    prof = profiling.main(["--cpu"])
    err = capsys.readouterr().err
    assert "profile_solver, B=8, H=5, on CPU" in err
    for phase in ("residuals+grad", "stage blocks", "KKT sweep",
                  "direction(blocks+sweep)", "line-search fan",
                  "full warm step"):
        assert prof[phase] > 0.0 and phase in err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            profiling.main([])


def test_config1_euler_next_matches_jax():
    """BASELINE config 1: the known LV ODE, Euler, H=10, one NMPC.next from
    the example's start, converged in both packages, plans within 1e-4."""
    jm = J.NMPC(J.jax_dynamics(_jax_lv, x_dim=2, u_dim=1),
                lambda x, u: jnp.sum(u * 1.1),
                [J.DomainConstraint(**tlv.BENCH_BOX)], H=10, DT=0.1,
                integrator="euler")
    tm = tlv.make_config1_mpc("cpu")
    x0 = np.asarray(tlv.CONFIG1_X0, np.float32)
    jres = jm.next(jnp.asarray(x0))
    tres = tm.next(torch.as_tensor(x0))
    assert bool(jres.converged) and bool(tres.converged)
    assert int(tres.iterations) == int(jres.iterations)
    assert np.abs(tres.u.numpy() - np.asarray(jres.u)).max() <= DU_TOL
    assert np.abs(tres.x.numpy() - np.asarray(jres.x)).max() <= DU_TOL


def _jax_lv(x, u):
    xr = 30.0 * (x + 1.0)
    ur = 50.0 * u
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
    return jnp.concatenate([d1, d2], axis=1) / 30.0
