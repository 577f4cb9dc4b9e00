"""The port's general Riccati sweep (R right-hand sides, r stage equality
rows): its plain PyTorch version against the JAX package's scan reference
(``jax.vmap(riccati_sweep_general_ref)``) and, at tiny dims, against the
general Pallas kernels run as their own tests run them (interpret mode), on
the shared seeded cases; the dispatch plan; the byte and operation counts
behind the kernels' bounds; and one whole general-path Newton direction
against the JAX package's ``make_riccati_direction``.  The CUDA kernels
themselves are held against the plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.ops.pallas.riccati_kernel import \
    riccati_sweep_general_pallas
from pyneuralempc_tpu.solve.riccati import make_riccati_direction as j_dir
from pyneuralempc_tpu.solve.riccati import riccati_sweep_general_ref
from pyneuralempc_tpu_torch.ops.cuda import riccati_general as rg
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import (general_sweep_case,
                                                         sweep_case)
from pyneuralempc_tpu_torch.solve.riccati import make_riccati_direction

import _torch_threads  # noqa: F401  (one torch thread)

ATOL = 2e-5     # tests/test_pallas_general.py's own tolerance (f32)
KINDS = ["delta0", "delta_per_problem", "negative_curvature", "local_bump"]


def _rhs_major(a):
    """Port layout (B, H, R, ·) -> the JAX functions' (B, R, H, ·)."""
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


def _jax_ref(args):
    A, Bm, G, M, mx, mu_, c, delta, dc, E, F, h, Jx = args
    out = jax.vmap(riccati_sweep_general_ref)(
        *(jnp.asarray(a) for a in (A, Bm, G, M, _rhs_major(mx),
                                   _rhs_major(mu_), _rhs_major(c), delta,
                                   dc, E, F, _rhs_major(h), Jx)))
    return [np.swapaxes(np.asarray(o), 1, 2) for o in out[:4]] + [
        np.asarray(out[4])]


def _plain(args):
    return [o.numpy() for o in
            rg.riccati_sweep_general_plain(*(torch.as_tensor(a)
                                             for a in args))]


def _assert_close(out, ref, ok):
    np.testing.assert_array_equal(out[4], ref[4])
    for o, r in zip(out[:4], ref[:4]):
        assert o.shape == r.shape
        np.testing.assert_allclose(o[ok], r[ok], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("R,r", [(2, 1), (2, 0), (1, 3)])
def test_plain_matches_reference(kind, R, r):
    """(R, r) = (2, 1): the border + stage-EQ shape; (2, 0): border only;
    (1, nu): pure stage EQ (no local_bump there: it decouples a control
    from the equality rows, which needs r < nu)."""
    if kind == "local_bump" and r == 3:
        with pytest.raises(ValueError, match="r < nu"):
            general_sweep_case(kind, nu=3, r=r)
        kind = "delta0"
    args = general_sweep_case(kind, B=4, H=4, nx=4, nu=3, R=R, r=r, seed=3)
    ref = _jax_ref(args)
    out = _plain(args)
    want = ([True, False, True, False] if kind == "negative_curvature"
            else [True] * 4)
    assert out[4].tolist() == want
    _assert_close(out, ref, out[4])


@pytest.mark.parametrize("R,r", [(2, 1), (2, 0)])
def test_plain_matches_interpret_kernel(R, r):
    """At tiny dims, against the Pallas general kernels in interpret mode
    (tests/test_pallas_general.py's shapes), the indefinite case included:
    ok flags equal."""
    args = general_sweep_case("negative_curvature", B=2, H=3, nx=2, nu=2,
                              R=R, r=r, seed=5)
    A, Bm, G, M, mx, mu_, c, delta, dc, E, F, h, Jx = args
    eq = (E, F, _rhs_major(h), Jx) if r else (None,) * 4
    pal = riccati_sweep_general_pallas(
        *(jnp.asarray(a) for a in (A, Bm, G, M, _rhs_major(mx),
                                   _rhs_major(mu_), _rhs_major(c), delta,
                                   dc)),
        *(None if a is None else jnp.asarray(a) for a in eq),
        interpret=True)
    pal = [np.swapaxes(np.asarray(o), 1, 2) for o in pal[:4]] + [
        np.asarray(pal[4])]
    out = _plain(args)
    assert out[4].tolist() == [True, False]
    _assert_close(out, pal, out[4])


@pytest.mark.parametrize("kind", KINDS)
def test_general_at_one_rhs_is_the_plain_sweep(kind):
    """R=1, r=0 is the plain sweep: same outputs as riccati_sweep_plain on
    the same case, an empty dNu."""
    nx, nu = 4, 2
    args = general_sweep_case(kind, B=4, H=5, nx=nx, nu=nu, R=1, r=0,
                              seed=7)
    plain = rk.riccati_sweep_plain(*(torch.as_tensor(a) for a in
                                     sweep_case(kind, B=4, H=5, nx=nx, nu=nu,
                                                seed=7)))
    out = rg.riccati_sweep_general_plain(*(torch.as_tensor(a) for a in args))
    assert torch.equal(out[4], plain[3])
    assert out[3].shape == (4, 5, 1, 0)
    for o, p in zip(out[:3], plain[:3]):
        torch.testing.assert_close(o[:, :, 0][plain[3]], p[plain[3]],
                                   rtol=0, atol=1e-6)


def test_gains_layout_and_halves():
    """The halves compose to the sweep bit for bit; each stage's gains are
    [K | k | Pbar | pbar | Mxu | Knu | knu] with Mxu M's state-control
    block and pbar = mx at the last stage, per right-hand side."""
    nx, nu, R, r = 4, 2, 3, 1
    args = [torch.as_tensor(a) for a in general_sweep_case(
        "delta_per_problem", B=4, H=3, nx=nx, nu=nu, R=R, r=r, seed=2)]
    n0 = rk.PLAIN_CALLS
    gains, ok = rg.riccati_general_backward_plain(*args[:12])
    out = rg.riccati_general_forward_plain(args[0], args[1], args[6],
                                           args[12], gains)
    assert rk.PLAIN_CALLS == n0 + 2
    assert gains.shape == (4, 3, rk.gain_width(nx, nu, R, r))
    for a, b in zip(out + (ok,), rg.riccati_sweep_general_plain(*args)):
        assert torch.equal(a, b)
    K, k, Pbar, pbar, Mxu, Knu, knu = rg._split_gains(gains[:, -1], nx, nu,
                                                      R, r)
    assert torch.equal(Mxu, args[3][:, -1, :nx, nx:])
    assert torch.equal(pbar, args[4][:, -1])
    assert Knu.shape == (4, r, nx) and knu.shape == (4, R, r)


def test_kernel_plan_general_is_pinned():
    for shape in ((50, 12, 4, 2, 1), (20, 2, 1, 65, 0), (50, 12, 4, 1, 4),
                  (3, 32, 16, 65, 16), (50, 12, 4, 2, 0)):
        H, nx, nu, R, r = shape
        assert (rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)["path"]
                == "cuda_streamed_general")
        assert rk.kernel_plan(H, nx, nu, "cpu", R=R, r=r)["path"] == "plain"
    # outside the general kernels' envelope the card runs the plain
    # version (the JAX package's scan fallback); H=0 has no plan on the card
    for H, nx, nu, R, r in ((50, 12, 4, 66, 0), (50, 12, 4, 2, 5),
                            (50, 33, 4, 2, 1), (50, 12, 17, 2, 1),
                            (0, 12, 4, 2, 1)):
        p = rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)
        assert p["path"] == ("plain_fallback" if H else "unsupported")
        assert "R <= 65" in p["reason"] and "r <= nu" in p["reason"]
    # the LV stage's instantiated shapes take the fused general kernel
    for H, nx, nu, R, r in ((20, 2, 1, 2, 0), (20, 2, 1, 2, 1),
                            (10, 2, 1, 1, 1), (20, 2, 1, 3, 0)):
        assert (rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)["path"]
                == "cuda_fused_general")
    # (R, r) = (1, 0) stays the plain sweep's plan
    assert rk.kernel_plan(50, 12, 4, "cuda", R=1, r=0)["path"] == \
        "cuda_streamed"
    assert rk.kernel_plan(20, 2, 1, "cuda")["path"] == "cuda_fused"


def test_bound_counts():
    """At the EQ/border quadrotor fleet (B=4096, H=50, nx=12, nu=4, R=2,
    r=1): the backward kernel reads 538 floats a stage (A 144, B 48, the G
    and M triangles 136 each, mx 24, mu 8, c 24, h 2, E 4, F 12) and δ, δ_c
    a problem, writes 286 gain floats a stage (K 48, k 8, Pbar 144, pbar
    24, Mxu 48, Knu 12, knu 2) and an ok byte; the forward kernel reads A,
    B, c, Jx and the gains (514) and writes dX, dU, dLam, dNu (58)."""
    dims = (4096, 50, 12, 4, 2, 1)
    assert rk.gain_width(12, 4, 2, 1) == 286
    assert rg.general_backward_bytes(1, 1, 12, 4, 2, 1) == 4 * (538 + 2 +
                                                                286) + 1
    assert rg.general_forward_bytes(1, 1, 12, 4, 2, 1) == 4 * (514 + 58)
    assert rg.general_backward_bytes(*dims) == 675_057_664    # 675.06 MB
    assert rg.general_forward_bytes(*dims) == 468_582_400     # 468.58 MB
    assert rg.general_backward_flops(1, 1, 12, 4, 2, 1) == 16_098
    assert rg.general_forward_flops(1, 1, 12, 4, 2, 1) == 1_882
    # R=1, r=0 gives the plain pair's counts
    for fn, plain in ((rg.general_backward_bytes, rk.backward_bytes),
                      (rg.general_forward_bytes, rk.forward_bytes),
                      (rg.general_backward_flops, rk.backward_flops),
                      (rg.general_forward_flops, rk.forward_flops)):
        assert fn(7, 3, 12, 4, 1, 0) == plain(7, 3, 12, 4)


@pytest.mark.parametrize("kind", KINDS)
def test_general_cases(kind):
    """The shared general cases: float32, contiguous, the first right-hand
    side and A, B, G, M, δ those of the plain case, E identity dominant,
    and each kind's change where its docstring puts it."""
    nx, nu, R, r = 4, 3, 3, 2
    args = general_sweep_case(kind, B=8, H=3, nx=nx, nu=nu, R=R, r=r,
                              seed=11)
    base = sweep_case(kind, B=8, H=3, nx=nx, nu=nu, seed=11)
    for a in args:
        assert a.dtype == np.float32 and a.flags.c_contiguous
    for a, b in zip(args[:4] + [args[7]], base[:4] + [base[7]]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((args[4], args[5], args[6]), (base[4], base[5], base[6])):
        assert a.shape[2] == R
        np.testing.assert_array_equal(a[:, :, 0], b)
    E, dc = args[9], args[8]
    assert E.shape == (8, 3, r, nu) and args[11].shape == (8, 3, R, r)
    if kind == "delta_per_problem":
        np.testing.assert_array_equal(
            dc, np.float32([1e-8, 1e-6, 1e-4, 1e-2] * 2))
    else:
        assert (dc == np.float32(1e-8)).all()
    if kind == "local_bump":
        assert not E[1::2, 1, :, 0].any() and not args[5][1::2, 1, :, 0].any()
        assert (np.abs(E[1::2, 1, :, 1:] - np.eye(r, nu - 1)) < 1.0).all()
    else:
        assert (np.abs(np.diagonal(E, axis1=2, axis2=3) - 1.0) < 1.0).all()


def test_dispatch_and_refusals():
    args = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=4, nu=2, R=2, r=1)]
    n0 = rk.PLAIN_CALLS
    out = rg.riccati_sweep_general(*args)
    assert rk.PLAIN_CALLS == n0 + 1
    for a, b in zip(out, rg.riccati_sweep_general_plain(*args)):
        assert torch.equal(a, b)
    def counts():
        return (rg.BACKWARD_LAUNCHES, rg.BACKWARD_INSTANCE_LAUNCHES,
                rg.BACKWARD_RUNTIME_LAUNCHES, rg.FORWARD_LAUNCHES)

    launches = counts()
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_sweep_general_streamed_cuda(*args)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_general_backward_runtime_cuda(*args[:12])
    gains, _ = rg.riccati_general_backward_plain(*args[:12])
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_general_forward_cuda(args[0], args[1], args[6], args[12],
                                        gains)
    assert counts() == launches


SOURCE = (Path(__file__).resolve().parents[1] / "pyneuralempc_tpu_torch"
          / "csrc" / rk.GENERAL_SOURCE)


def test_backward_instances_match_the_c_entry_point():
    """The backward entry's list of compile-time instances is exactly
    _GENERAL_BACKWARD_INSTANCES: the EQ/border quadrotor fleet's stage."""
    cases = re.findall(r"^\s*RICCATI_GENERAL_BACKWARD_CASE\((\d+), (\d+), "
                       r"(\d+), (\d+)\)\s*$", SOURCE.read_text(), re.M)
    assert {tuple(map(int, t)) for t in cases} == \
        rk._GENERAL_BACKWARD_INSTANCES
    assert len(cases) == len(rk._GENERAL_BACKWARD_INSTANCES)
    assert rk._GENERAL_BACKWARD_INSTANCES == {(12, 4, 2, 1)}


@pytest.mark.parametrize("shape", [(12, 4, 2, 0), (12, 4, 1, 4),
                                   (12, 4, 1, 0), (12, 4, 3, 1),
                                   (4, 2, 2, 1), (2, 1, 2, 0),
                                   (32, 16, 65, 2)])
def test_backward_dispatch_rule(shape):
    """The instance at (12, 4, 2, 1), the run-time kernel at any other
    shape; both stay on the streamed general path."""
    assert (rk.general_backward_kernel(12, 4, 2, 1)
            == "riccati_general_backward_fixed")
    assert rk.kernel_plan(50, 12, 4, "cuda", R=2, r=1)["path"] == \
        "cuda_streamed_general"
    assert (rk.general_backward_kernel(*shape)
            == "riccati_general_backward_kernel")
    # the names the profiler matches on do not contain one another
    assert ("riccati_general_backward_kernel"
            not in "riccati_general_backward_fixed")


# ---- one whole general-path Newton direction against the JAX package ----

H = 6


def _lv(lib):
    cat = jnp.concatenate if lib is jnp else torch.cat

    def f(x, u):
        return cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                    -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], 1)
    return f


def _mpc(P, lib, order=1):
    box = P.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                             control_constraint=[[-1.0, 1.0]])
    ssum = jnp.sum if lib is jnp else torch.sum
    cost = P.StageCost(stage=lambda x, u: 1.1 * ssum(u) + 0.1 * ssum(x ** 2))
    ineq = P.stage_interval(lambda x, u: (x[0] + x[1]) * ssum(u * 0 + 1),
                            dim=1, lb=-1.5, ub=1.5)
    eqc = P.StageConstraint(stage=lambda x, u: u[0] - 0.2 * x[1] ** 2,
                            dim=1, lb=(0.1,), ub=(0.1,))
    tc = P.PathConstraint(fn=lambda x, u: ssum(u * x[:, :1]).reshape(1),
                          dim=1, lb=(-float("inf"),), ub=(0.5,))
    cons = [box, ineq, eqc, tc][::order]
    model = (J.jax_dynamics(_lv(jnp), 2, 1) if lib is jnp
             else T.torch_dynamics(_lv(torch), 2, 1))
    kw = {} if lib is jnp else {"device": "cpu"}
    return P.NMPC(model, cost, cons, H=H, DT=0.1,
                  config=P.IPConfig(kkt="riccati"), **kw)


def test_general_direction_matches_jax():
    """Stage interval row (slack fold), nonlinear stage EQ row (stage QP
    with its curvature) and a nonlinear border row (Schur border): the
    blocks, the constraint Jacobians and the direction (dw, dlam) at one
    interior point, same numpy inputs."""
    jm, tm = _mpc(J, jnp), _mpc(T, torch)
    jn, tn = jm.nlp, tm.nlp
    rng = np.random.default_rng(4)
    lo, hi = np.asarray(jn.lower), np.asarray(jn.upper)
    w = np.where(np.isfinite(lo) & np.isfinite(hi),
                 rng.uniform(np.maximum(lo, -5) + 0.05,
                             np.minimum(hi, 5) - 0.05),
                 rng.uniform(-1, 1, jn.n)).astype(np.float32)
    lam = rng.normal(0, 0.3, jn.m).astype(np.float32)
    Sigma = rng.uniform(0.01, 2.0, jn.n).astype(np.float32)
    r_tilde = rng.normal(0, 1, jn.n).astype(np.float32)
    c = rng.normal(0, 0.05, jn.m).astype(np.float32)
    x0 = np.asarray([0.3, 0.2], np.float32)
    jrt = J.runtime(jnp.asarray(x0))
    jrt["_s_obj"] = jnp.asarray(0.8, jnp.float32)
    trt = T.runtime(torch.as_tensor(x0)[None])
    trt["_s_obj"] = torch.tensor([0.8])
    jd, td = j_dir(jn, jm.config), make_riccati_direction(tn, tm.config)
    assert td.general
    jb = jd.prepare(jnp.asarray(w), jnp.asarray(lam), jrt)
    tb = td.prepare(torch.as_tensor(w)[None], torch.as_tensor(lam)[None],
                    trt)
    for j, t in list(zip(jb[:4], tb[:4])) + list(zip(jb[4], tb[4])) + list(
            zip(jb[5], tb[5])):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)
    jdw, jdl, jok, _ = jd(jnp.asarray(w), jnp.asarray(lam), jrt,
                          *(jnp.asarray(a) for a in (Sigma, r_tilde, c)))
    tdw, tdl, tok, resolve = td(
        torch.as_tensor(w)[None], torch.as_tensor(lam)[None], trt,
        *(torch.as_tensor(a)[None] for a in (Sigma, r_tilde, c)))
    assert bool(jok) and bool(tok[0])
    for j, t in ((jdw, tdw), (jdl, tdl)):
        j = np.asarray(j)
        err = np.abs(t[0].numpy() - j).max() / max(np.abs(j).max(), 1.0)
        assert err <= 1e-4, err
    rdw, rdl, _ = resolve(torch.as_tensor(r_tilde)[None],
                          torch.as_tensor(c)[None])
    assert torch.equal(rdw, tdw) and torch.equal(rdl, tdl)
    # the zero blocks have prepare's structure (the polish phase carries it)
    zb = td.zero_blocks(2, "cpu")
    assert [t.shape[1:] for t in zb[:4]] == [t.shape[1:] for t in tb[:4]]
    assert [t.shape[1:] for t in zb[4] + zb[5]] == [
        t.shape[1:] for t in tb[4] + tb[5]]


# ---- the forward kernel's compile-time instance ----

def test_forward_instances_match_the_c_entry_point():
    """The forward entry's list of compile-time instances, each with its
    ring depth, is exactly _GENERAL_FORWARD_INSTANCES: the EQ/border
    quadrotor fleet's stage at depth 2; the kernel is defined once, in the
    shared header csrc/riccati_forward_fixed.cuh, and the entry takes no
    depth."""
    text = SOURCE.read_text()
    header = (SOURCE.parent / "riccati_forward_fixed.cuh").read_text()
    cases = re.findall(r"^\s*RICCATI_GENERAL_FORWARD_CASE\((\d+), (\d+), "
                       r"(\d+), (\d+), (\d+)\)\s*$", text, re.M)
    assert {tuple(map(int, t[:4])): int(t[4]) for t in cases} == \
        rk._GENERAL_FORWARD_INSTANCES
    assert len(cases) == len(rk._GENERAL_FORWARD_INSTANCES)
    assert rk._GENERAL_FORWARD_INSTANCES == {(12, 4, 2, 1): 2}
    assert '#include "riccati_forward_fixed.cuh"' in text
    assert "riccati_general_forward_fixed<NX, NU, R, RE, D>" in header
    assert not re.search(r"^riccati_general_forward_fixed\(", text, re.M)
    entry = text[text.index('int riccati_general_forward_f32('):]
    assert "int ring" not in entry[:entry.index("{")]
    assert "int depth" not in entry[:entry.index("{")]
    assert 'extern "C" int riccati_general_forward_runtime_f32(' in text
    assert re.search(r"^riccati_general_forward_fixed\(", header, re.M)
    assert re.search(r"^riccati_general_forward_kernel\(", text, re.M)


@pytest.mark.parametrize("shape", [(12, 4, 2, 1), (12, 4, 2, 0),
                                   (12, 4, 1, 0), (12, 4, 1, 4),
                                   (4, 2, 2, 1), (32, 16, 65, 2)])
def test_general_forward_kernel_rule(shape):
    """The instance, named with its template arguments (its ring depth
    last), at (12, 4, 2, 1); the run-time kernel at any other shape; neither
    name holds the other."""
    name = rk.general_forward_kernel(*shape)
    if shape == (12, 4, 2, 1):
        assert name == "riccati_general_forward_fixed<12, 4, 2, 1, 2>"
    else:
        assert name == "riccati_general_forward_kernel"
    names = ["riccati_general_forward_kernel",
             rk.general_forward_kernel(12, 4, 2, 1)]
    for a in names:
        for b in names:
            assert a == b or a.replace(" ", "") not in b.replace(" ", "")


def test_forward_ring_bytes_hand_worked():
    """One stage slot at (12, 4, 2, 1): A 144, B 48, c 24, Jx 12 and 286
    gain floats, each with 3 floats of room for its source's offset,
    rounded to 16 bytes: 148 + 52 + 28 + 16 + 292 = 536 floats; a block of
    4 warps with rings of 2 slots takes 17,152 B, so 8 blocks (B=4096 in one
    wave on 132 SMs) fit an SM's 228 KB."""
    assert rk.gain_width(12, 4, 2, 1) == 286
    assert rk.forward_slot_floats(12, 4, 2, 1) == 536
    depth = rk._GENERAL_FORWARD_INSTANCES[12, 4, 2, 1]
    assert depth == 2
    assert rk.forward_ring_bytes(12, 4, 2, 1, depth) == 17_152
    assert 8 * (rk.forward_ring_bytes(12, 4, 2, 1, depth) + 1024) <= \
        228 * 1024
    # no Jx at r = 0: its range takes no room
    assert rk.forward_slot_floats(12, 4, 2, 0) == 148 + 52 + 28 + 276


def test_forward_runtime_wrapper_refuses_cpu_tensors():
    """The run-time forward wrapper, like the solver's, launches only on
    CUDA tensors; a refused call moves no counter."""
    args = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=12, nu=4, R=2, r=1)]
    gains, _ = rg.riccati_general_backward_plain(*args[:12])
    ins = (args[0], args[1], args[6], args[12], gains)
    counts = (rg.FORWARD_LAUNCHES, rg.FORWARD_INSTANCE_LAUNCHES,
              rg.FORWARD_RUNTIME_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_general_forward_runtime_cuda(*ins)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_general_forward_cuda(*ins)
    assert (rg.FORWARD_LAUNCHES, rg.FORWARD_INSTANCE_LAUNCHES,
            rg.FORWARD_RUNTIME_LAUNCHES) == counts
