"""The port's Riccati sweep: its plain PyTorch version against the JAX
package's scan reference (``jax.vmap(riccati_sweep_ref)``) and against the
Pallas kernel run as its own tests run it (interpret mode), on the data and
cases of tests/test_pallas_kernel.py; its backward and forward halves (the
plain versions of the streamed pair) against the scan reference at
quadrotor-like stage widths; the dispatch plan; the byte and operation
counts behind each kernel's bound.  The CUDA kernels themselves are held
against the plain versions on a card by tests/test_torch_cuda.py and
chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyneuralempc_tpu.ops.pallas.riccati_kernel import riccati_sweep_pallas
from pyneuralempc_tpu.solve.riccati import riccati_sweep_ref
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import sweep_case, sweep_data

import _torch_threads  # noqa: F401  (one torch thread)

ATOL = 2e-5     # the JAX kernel test's own tolerance (f32)
# one horizon for every case: interpret mode compiles once per shape
B4H4 = dict(B=4, H=4)


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.as_tensor(a) for a in args]


def _check(args, outputs=True):
    """Plain sweep vs scan reference and vs the interpret-mode kernel: ok
    flags exactly equal; outputs within ATOL where ``outputs``."""
    ref = jax.vmap(riccati_sweep_ref)(*_jax(args))
    pal = riccati_sweep_pallas(*_jax(args), interpret=True)
    out = rk.riccati_sweep_plain(*_torch(args))
    for other in (ref, pal):
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(other[3]))
        if outputs:
            for o, r in zip(out[:3], other[:3]):
                np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                           atol=ATOL, rtol=0)
    return out


def test_plain_matches_reference_and_pallas():
    out = _check(sweep_data(**B4H4))
    assert bool(out[3].all())


def test_plain_delta_per_problem():
    args = sweep_data(**B4H4, seed=1)
    args[7] = np.asarray([0.0, 0.1, 1.0, 10.0], np.float32)
    _check(args)


def test_plain_ok_flag_on_negative_curvature():
    args = sweep_data(**B4H4, seed=2)
    args[3][1, :, 2, 2] = -50.0
    out = _check(args, outputs=False)
    assert out[3].tolist() == [True, False, True, True]


def test_plain_local_delta_retry():
    """A marginal pivot inside the nudge-scale bumps is rescued ok=True by
    one sweep, with the same result as the reference and the kernel."""
    args = sweep_data(**B4H4, seed=3)
    Bm, G, M, mu_ = args[1], args[2], args[3], args[5]
    Bm[1, 1] = 0.0
    M[1, 1, 2, 2] = -G[1, 1, 2, 2] - 2e-7
    M[1, 1, :2, 2] = M[1, 1, 2, :2] = 0.0
    G[1, 1, :2, 2] = G[1, 1, 2, :2] = 0.0
    mu_[1, 1] = 0.0
    out = _check(args)
    assert bool(out[3].all())
    assert np.all(np.isfinite(out[0].numpy()))


def test_plain_defers_real_indefiniteness_to_ladder():
    args = sweep_data(**B4H4, seed=3)
    args[3][1, 1, 2, 2] = -0.5
    out = _check(args, outputs=False)
    assert out[3].tolist() == [True, False, True, True]


def test_kernel_plan_is_pinned():
    assert rk.kernel_plan(20, 2, 1, "cuda")["path"] == "cuda_fused"
    assert (rk.kernel_plan(50, 2, 1, torch.device("cuda:0"))["path"]
            == "cuda_fused")
    for shape in ((20, 2, 1), (50, 12, 4), (3, 7, 5), (50, 12, 17)):
        assert rk.kernel_plan(*shape, "cpu")["path"] == "plain"
    for shape in ((50, 12, 4), (20, 4, 2), (50, 12, 10), (1, 32, 16),
                  (5, 1, 1)):
        assert rk.kernel_plan(*shape, "cuda")["path"] == "cuda_streamed"
    # outside every kernel's envelope the card runs the plain version
    # (the JAX package's scan fallback); H=0 has no plan on the card
    for shape, path in (((50, 12, 17), "plain_fallback"),
                        ((50, 33, 4), "plain_fallback"),
                        ((0, 12, 4), "unsupported")):
        p = rk.kernel_plan(*shape, "cuda")
        assert p["path"] == path
        assert "nu <= 16" in p["reason"] and "nx <= 32" in p["reason"]
    assert "nx=12, nu=17" in rk.kernel_plan(50, 12, 17, "cuda")["reason"]
    assert "nu=17 > 16" in rk.kernel_plan(50, 12, 17, "cuda")["reason"]
    assert "nx=33 > 32" in rk.kernel_plan(50, 33, 4, "cuda")["reason"]


def test_kernel_plan_names_the_fused_general_kernel():
    """The fused plans name a kernel of csrc/riccati_general_fused.cu (or
    csrc/riccati_sweep.cu) and the problems of its staged block: the fused
    general plan, and the fused plain one at (2, 1), which takes the staged
    kernel at <2, 1, 1, 0>; the streamed plans name no fused kernel (the
    plain streamed plan names its backward and forward kernels)."""
    plain = rk.kernel_plan(20, 2, 1, "cuda")
    assert (plain["path"], plain["kernel"], plain["block_problems"]) == (
        "cuda_fused", "riccati_general_fused_staged_kernel", 32)
    streamed = rk.kernel_plan(50, 12, 4, "cuda")
    assert set(streamed) == {"path", "backward_kernel", "forward_kernel",
                             "reason"}
    assert (streamed["backward_kernel"], streamed["forward_kernel"]) == (
        rk.backward_kernel(12, 4), rk.forward_kernel(12, 4))
    assert set(rk.kernel_plan(50, 12, 4, "cuda", R=2, r=1)) == {"path",
                                                                "reason"}
    staged = rk.kernel_plan(20, 2, 1, "cuda", R=2, r=0)
    assert (staged["kernel"], staged["block_problems"]) == (
        rk.STAGED_KERNEL, rk.staged_block_problems(20, 2, 1, 2, 0)) == (
        "riccati_general_fused_staged_kernel", 32)
    direct = rk.kernel_plan(5000, 2, 1, "cuda", R=3, r=1)
    assert (direct["kernel"], direct["block_problems"]) == (
        "riccati_general_fused_kernel", 0)
    assert rk.kernel_plan(5000, 2, 1, "cpu", R=3, r=1)["path"] == "plain"


def test_dispatch_sends_cpu_tensors_to_plain():
    args = _torch(sweep_data())
    plain0, launches0 = rk.PLAIN_CALLS, rk.LAUNCHES
    out = rk.riccati_sweep(*args)
    assert rk.PLAIN_CALLS == plain0 + 1 and rk.LAUNCHES == launches0
    ref = rk.riccati_sweep_plain(*args)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_cuda_wrapper_refuses_cpu_tensors():
    launches0 = rk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_sweep_cuda(*_torch(sweep_data()))
    assert rk.LAUNCHES == launches0


def test_bound_counts():
    """Bytes count G and M as their upper triangles (ns(ns+1)/2 floats
    each: all the sweep needs of them, and all the kernels read).  At LV
    size, 23 input and 5 output floats a stage, plus δ and the ok byte per
    problem.  The streamed pair at quadrotor size: the backward kernel reads
    492 floats a stage (A 144, B 48, G 136, M 136, mx 12, mu 4, c 12) and
    writes 256 gain floats; the forward kernel reads A, B, c and the gains
    (460) and writes dX, dU, dLam (28)."""
    assert rk.sweep_bytes(1, 1, 2, 1) == 4 * (23 + 1 + 5) + 1
    assert rk.sweep_bytes(4096, 20, 2, 1) == 4096 * (4 * (20 * 28 + 1) + 1)
    assert rk.sweep_flops(4096, 20, 2, 1) == 20 * rk.sweep_flops(4096, 1, 2,
                                                                  1)
    assert rk.gain_width(2, 1) == 2 + 1 + 4 + 2 + 2
    assert rk.gain_width(12, 4) == 256
    assert rk.backward_bytes(1, 1, 12, 4) == 4 * (492 + 1 + 256) + 1
    assert rk.forward_bytes(1, 1, 12, 4) == 4 * (460 + 28)
    assert rk.backward_flops(1, 1, 12, 4) == 14525
    assert rk.forward_flops(1, 1, 12, 4) == 892
    assert rk.backward_bytes(4096, 50, 12, 4) == 612_782_080   # ~183 us
    assert rk.forward_bytes(4096, 50, 12, 4) == 399_769_600    # ~119 us
    assert rk.backward_flops(4096, 50, 12, 4) == 2_974_720_000
    assert rk.forward_flops(4096, 50, 12, 4) == 182_681_600
    for dims in ((2, 1), (12, 4), (4, 2)):
        assert (rk.backward_flops(7, 3, *dims) + rk.forward_flops(7, 3, *dims)
                == rk.sweep_flops(7, 3, *dims))


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
def test_sweep_cases(kind):
    """The shared cases that chip_smoke.py holds the kernels to: float32,
    contiguous, G and M exactly symmetric (the kernels read their upper
    triangles, the plain version the full matrices), and each case's
    change where its docstring puts it."""
    nx, nu = 4, 2
    args = sweep_case(kind, B=8, H=3, nx=nx, nu=nu, seed=11)
    base = sweep_data(B=8, H=3, nx=nx, nu=nu, seed=11)
    for a in args:
        assert a.dtype == np.float32 and a.flags.c_contiguous
    A, Bm, G, M, mx, mu_, c, delta = args
    for X in (G, M):
        np.testing.assert_array_equal(X, X.transpose(0, 1, 3, 2))
    if kind == "delta_per_problem":
        np.testing.assert_array_equal(
            delta, np.float32([0.0, 0.1, 1.0, 10.0] * 2))
    else:
        assert not delta.any()
    if kind == "negative_curvature":
        assert (M[1::2, :, nx, nx] == -50.0).all()
        np.testing.assert_array_equal(M[::2], base[3][::2])
    if kind == "local_bump":
        for sel, gap in ((slice(1, None, 2), 2e-7), (slice(2, None, 4), 2e-5)):
            assert not Bm[sel, 1].any() and not mu_[sel, 1].any()
            pivot = (M[sel, 1, nx, nx].astype(np.float64)
                     + G[sel, 1, nx, nx])
            # -gap up to one f32 rounding of -G - gap (|G| ~ 0.1)
            np.testing.assert_allclose(pivot, -gap, rtol=0, atol=1e-8)
        np.testing.assert_array_equal(M[0], base[3][0])
    if kind == "delta0":
        for a, b in zip(args, base):
            np.testing.assert_array_equal(a, b)


# ---- the streamed pair's plain halves at quadrotor-like stage widths ----

SPLIT_TOL = 2e-4    # tests/test_pallas_kernel.py's quadrotor-dims tolerance


@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 2), (12, 10), (32, 16),
                                   (10, 1), (4, 1)])
@pytest.mark.parametrize("kind", ["delta_per_problem", "negative_curvature",
                                  "local_bump"])
def test_plain_halves_match_reference(kind, nx, nu):
    """riccati_backward_plain then riccati_forward_plain against the JAX
    package's scan reference (vmapped): ok flags equal, outputs of the ok
    problems within SPLIT_TOL·max(1, |ref|); their composition is
    riccati_sweep_plain, bit for bit."""
    args = sweep_case(kind, B=4, H=5, nx=nx, nu=nu, seed=7)
    t = _torch(args)
    gains, ok = rk.riccati_backward_plain(*t)
    assert gains.shape == (4, 5, rk.gain_width(nx, nu))
    out = rk.riccati_forward_plain(t[0], t[1], t[6], gains) + (ok,)
    ref = jax.vmap(riccati_sweep_ref)(*_jax(args))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[3]))
    want = [True, False, True, False] if kind == "negative_curvature" else [
        True] * 4
    assert ok.tolist() == want
    m = ok.numpy()
    for o, r in zip(out[:3], ref[:3]):
        r = np.asarray(r)[m]
        err = np.abs(o.numpy()[m] - r) / np.maximum(1.0, np.abs(r))
        assert err.max() <= SPLIT_TOL, err.max()
    for o, s in zip(out, rk.riccati_sweep_plain(*t)):
        assert torch.equal(o[m], s[m])


def test_plain_gains_layout():
    """Each stage's gains are [K | k | Pbar | pbar | Mxu]: Mxu is M's
    state-control block, Pbar = Mxx + δI at the last stage (P = 0 there),
    and k = -Quu⁻¹ qu there."""
    nx, nu = 4, 2
    args = sweep_case("delta_per_problem", B=4, H=3, nx=nx, nu=nu, seed=5)
    t = _torch(args)
    gains, _ = rk.riccati_backward_plain(*t)
    M, delta = t[3], t[7]
    o = nu * nx + nu
    Pbar = gains[:, -1, o:o + nx * nx].reshape(4, nx, nx)
    torch.testing.assert_close(
        Pbar, M[:, -1, :nx, :nx] + delta[:, None, None] * torch.eye(nx),
        rtol=0, atol=1e-6)
    torch.testing.assert_close(
        gains[:, 0, -nx * nu:].reshape(4, nx, nu), M[:, 0, :nx, nx:],
        rtol=0, atol=0)
    pbar = gains[:, -1, o + nx * nx:o + nx * nx + nx]
    torch.testing.assert_close(pbar, t[4][:, -1], rtol=0, atol=0)


def test_plain_counters():
    t = _torch(sweep_data(B=2, H=2, nx=4, nu=2))
    n0 = rk.PLAIN_CALLS
    gains, _ = rk.riccati_backward_plain(*t)
    rk.riccati_forward_plain(t[0], t[1], t[6], gains)
    rk.riccati_sweep_plain(*t)
    assert rk.PLAIN_CALLS == n0 + 3
    launches = (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_sweep_streamed_cuda(*t)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_forward_cuda(t[0], t[1], t[6], gains)
    assert (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES) == launches


# ---- the streamed backward kernel's compile-time instance ----

STREAMED_SOURCE = (Path(__file__).resolve().parents[1]
                   / "pyneuralempc_tpu_torch" / "csrc" / rk.STREAMED_SOURCE)


def test_plain_backward_instances_match_the_c_entry_point():
    """The streamed backward entry's list of compile-time instances is
    exactly _BACKWARD_INSTANCES: the quadrotor fleets' stage, the GRU
    fleet's lifted stage, cartpole's, the wide fleet's, the LSTM fleet's
    lifted stage and the quadrotor GRU's lifted stage."""
    cases = re.findall(r"^\s*RICCATI_BACKWARD_CASE\((\d+), (\d+)\)\s*$",
                       STREAMED_SOURCE.read_text(), re.M)
    assert {tuple(map(int, t)) for t in cases} == rk._BACKWARD_INSTANCES
    assert len(cases) == len(rk._BACKWARD_INSTANCES)
    assert rk._BACKWARD_INSTANCES == {(12, 4), (10, 1), (4, 1), (12, 10),
                                      (18, 1), (28, 4)}


@pytest.mark.parametrize("nx,nu", [(12, 4), (10, 1), (4, 1), (4, 2),
                                   (12, 10), (18, 1), (32, 16), (28, 4)])
def test_backward_kernel_rule(nx, nu):
    """The instance (the general template at one right-hand side and no
    equality rows) at (12, 4), (10, 1), (4, 1), (12, 10), (18, 1) and
    (28, 4), the run-time kernel at any other shape; both stay on the
    streamed path."""
    assert rk.kernel_plan(50, nx, nu, "cuda")["path"] == "cuda_streamed"
    name = rk.backward_kernel(nx, nu)
    if (nx, nu) in {(12, 4), (10, 1), (4, 1), (12, 10), (18, 1), (28, 4)}:
        assert name == f"riccati_general_backward_fixed<{nx}, {nu}, 1, 0>"
    else:
        assert name == "riccati_backward_kernel"
    # the profiler names of the backward designs hold none of the others:
    # the instances differ in their template arguments
    names = (rk.backward_kernel(12, 4), rk.backward_kernel(10, 1),
             rk.backward_kernel(4, 1), rk.backward_kernel(12, 10),
             rk.backward_kernel(18, 1), rk.backward_kernel(28, 4),
             "riccati_backward_kernel",
             "riccati_general_backward_fixed<12, 4, 2, 1>",
             "riccati_general_backward_kernel")
    for a in names:
        for b in names:
            assert a == b or a.replace(" ", "") not in b.replace(" ", "")


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
def test_plain_backward_is_the_general_backward_at_one_rhs(kind):
    """The identity the instance stands on: at the quadrotor's (12, 4) and
    H=50, riccati_backward_plain gives the gains and ok flags that
    riccati_general_backward_plain gives at R=1, r=0 on the same case (one
    layout, 256 floats a stage), to 1e-6 scaled."""
    from pyneuralempc_tpu_torch.ops.cuda import riccati_general as rg
    from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import \
        general_sweep_case
    nx, nu = 12, 4
    plain = _torch(sweep_case(kind, B=4, H=50, nx=nx, nu=nu, seed=9))
    general = _torch(general_sweep_case(kind, B=4, H=50, nx=nx, nu=nu, R=1,
                                        r=0, seed=9))
    for i in (4, 5, 6):              # mx, mu, c: one right-hand side
        assert torch.equal(general[i][:, :, 0], plain[i])
    gains, ok = rk.riccati_backward_plain(*plain)
    g_gen, ok_gen = rg.riccati_general_backward_plain(*general[:12])
    assert gains.shape == g_gen.shape == (4, 50, 256)
    assert torch.equal(ok, ok_gen)
    want = [True, False, True, False] if kind == "negative_curvature" else [
        True] * 4
    assert ok.tolist() == want
    err = (gains - g_gen).abs() / gains.abs().clamp(min=1.0)
    assert float(err[ok].max()) <= 1e-6


def test_backward_runtime_wrapper_refuses_cpu_tensors():
    """The run-time backward wrapper launches only on CUDA tensors, and a
    refused call moves no counter."""
    t = _torch(sweep_case("delta0", B=2, H=2, nx=12, nu=4))
    counts = (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
              rk.BACKWARD_RUNTIME_LAUNCHES, rk.PLAIN_CALLS)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_backward_runtime_cuda(*t)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_backward_cuda(*t)
    assert (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
            rk.BACKWARD_RUNTIME_LAUNCHES, rk.PLAIN_CALLS) == counts


# ---- the fused plain sweep through the staged general kernel ----

FUSED_SOURCE = STREAMED_SOURCE.parent / rk.GENERAL_FUSED_SOURCE


@pytest.mark.parametrize("H", [1, 20, 50, 500])
def test_fused_plain_plan_names_the_staged_kernel(H):
    """At (2, 1) the fused plain plan names the staged kernel of
    csrc/riccati_general_fused.cu with the problems a block holds at
    <2, 1, 1, 0> (32 at the LV fleet's H=20)."""
    P = rk.staged_block_problems(H, 2, 1, 1, 0)
    p = rk.kernel_plan(H, 2, 1, "cuda")
    assert P > 0 and p["path"] == "cuda_fused"
    assert (p["kernel"], p["block_problems"]) == (rk.STAGED_KERNEL, P)
    assert f"{P} problems a block" in p["reason"]
    assert {1: 32, 20: 32, 50: 29}.get(H, P) == P


@pytest.mark.parametrize("H", [1500, 2000, 5000])
def test_fused_plain_plan_takes_riccati_sweep_past_shared_memory(H):
    """Where not one problem's horizon fits a staged block, the fused plain
    plan names csrc/riccati_sweep.cu's kernel, with 0 problems."""
    p = rk.kernel_plan(H, 2, 1, "cuda")
    assert rk.staged_block_problems(H, 2, 1, 1, 0) == 0
    assert (p["path"], p["kernel"], p["block_problems"]) == (
        "cuda_fused", "riccati_sweep_kernel", 0)
    assert rk.SOURCE in p["reason"]


def test_staged_block_at_the_plain_shape_hand_worked():
    """<2, 1, 1, 0> at H=20: per problem A 80, B 40, c 40, δ 1, G 180, M
    180, mx 40, mu 20 floats and 220 of gains (11 a stage); 32 problems
    take 102,544 bytes with the mbarrier and the 16-byte rounding."""
    assert rk.gain_width(2, 1) == 11
    assert rk.staged_smem_bytes(32, 20, 2, 1, 1, 0) == 102_544
    assert rk.staged_block_problems(20, 2, 1, 1, 0) == 32


def test_staged_entry_lists_the_plain_shape():
    """The staged entry's C case list holds (2, 1, 1, 0) and equals
    _STAGED_INSTANCES; the direct entry's does not hold it (at (1, 0)
    csrc/riccati_sweep.cu is the direct design)."""
    text = FUSED_SOURCE.read_text()
    staged = re.findall(r"^\s*RICCATI_GENERAL_FUSED_CASE\((\d+), (\d+), "
                        r"(\d+), (\d+)\)\s*$", text, re.M)
    direct = re.findall(r"^\s*RICCATI_GENERAL_FUSED_DIRECT_CASE\((\d+), "
                        r"(\d+), (\d+), (\d+)\)\s*$", text, re.M)
    assert (2, 1, 1, 0) in {tuple(map(int, t)) for t in staged}
    assert {tuple(map(int, t)) for t in staged} == rk._STAGED_INSTANCES
    assert (2, 1, 1, 0) not in {tuple(map(int, t)) for t in direct}
    assert {(nx, nu, 1, 0) for nx, nu in rk._INSTANCES} <= \
        rk._STAGED_INSTANCES


def test_fused_plain_kernel_names_in_the_sources():
    """chip_smoke.py matches both fused plain designs by name in a
    profiler trace: each is defined under its name, and neither name
    holds the other."""
    sweep = (STREAMED_SOURCE.parent / rk.SOURCE).read_text()
    assert re.search(rf"^{rk.SWEEP_KERNEL}\(", sweep, re.M)
    assert re.search(rf"^{rk.STAGED_KERNEL}\(", FUSED_SOURCE.read_text(),
                     re.M)
    assert rk.SWEEP_KERNEL not in rk.STAGED_KERNEL
    assert rk.STAGED_KERNEL not in rk.SWEEP_KERNEL


def test_sweep_direct_wrapper_refuses_cpu_tensors():
    """riccati_sweep_direct_cuda, like riccati_sweep_cuda, launches only
    on CUDA tensors, and a refused call moves no counter."""
    args = _torch(sweep_data())
    counts = (rk.LAUNCHES, rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES,
              rk.PLAIN_CALLS)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_sweep_direct_cuda(*args)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_sweep_cuda(*args)
    assert (rk.LAUNCHES, rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES,
            rk.PLAIN_CALLS) == counts
