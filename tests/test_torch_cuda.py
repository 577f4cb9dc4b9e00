"""Tests of the port that need an NVIDIA card: the CUDA sweeps (the fused
kernel, staged at <2, 1, 1, 0> and direct, the streamed backward/forward
pair and the general pair, each with its backward kernel's compile-time
instance, the general pair's forward instance too, and the fused general
kernels, staged and direct) against their plain versions and each other,
the wrappers' checks and dispatch, the LV, quadrotor, EQ/border
quadrotor and budgeted LV paths on the card against the CPU, the streamed
instances at the GRU fleet's and cartpole's stages, per-member params and
the multi-start's draws, and the backward instance at the quadrotor GRU's
lifted (28, 4).  They skip without a CUDA device.  This file imports no JAX, so on the card it runs
without the JAX package's test configuration:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q
"""

import warnings

import numpy as np
import pytest
import torch

import pyneuralempc_tpu_torch as nempc
from pyneuralempc_tpu_torch.ops.cuda import riccati_general as rg
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import (general_sweep_case,
                                                         sweep_case)

import _torch_threads  # noqa: F401  (one torch thread)

pytestmark = pytest.mark.cuda

SCALED_ATOL = 2e-5     # |kernel − plain| / max(1, |plain|), f32
# the streamed pair at quadrotor widths: tests/test_pallas_kernel.py's own
# tolerance at those dims
STREAMED_ATOL = 2e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _sweep_inputs(B, H, nx=2, nu=1, seed=0, device="cuda"):
    """Seeded sweep inputs; G and M exactly symmetric."""
    rng = np.random.default_rng(seed)
    ns = nx + nu
    A = np.eye(nx) + 0.03 * rng.normal(size=(B, H, nx, nx))
    Bm = 0.1 * rng.normal(size=(B, H, nx, nu))
    G = rng.normal(0, 0.05, (B, H, ns, ns)).astype(np.float32)
    M = rng.normal(0, 0.1, (B, H, ns, ns)).astype(np.float32)
    G = 0.5 * (G + G.transpose(0, 1, 3, 2))
    M = 0.5 * (M + M.transpose(0, 1, 3, 2)) + np.eye(ns, dtype=np.float32)
    mx = rng.normal(size=(B, H, nx))
    mu = rng.normal(size=(B, H, nu))
    c = 0.1 * rng.normal(size=(B, H, nx))
    delta = np.linspace(0.0, 1.0, B)
    return [torch.tensor(np.asarray(a, np.float32), device=device)
            for a in (A, Bm, G, M, mx, mu, c, delta)]


@pytest.mark.parametrize("B,H", [(257, 20), (4096, 1), (33, 50)])
def test_kernel_matches_plain_on_card(B, H):
    _card()
    args = _sweep_inputs(B, H, seed=B + H)
    out = rk.riccati_sweep_cuda(*args)
    ref = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out[3], ref[3]) and bool(ref[3].all())
    for o, r in zip(out[:3], ref[:3]):
        err = ((o - r).abs() / r.abs().clamp(min=1.0)).max()
        assert float(err) <= SCALED_ATOL


def _scaled_err(o, r, mask=None):
    if mask is not None:
        o, r = o[mask], r[mask]
    return float(((o - r).abs() / r.abs().clamp(min=1.0)).max())


@pytest.mark.parametrize("B,H,nx,nu", [(257, 50, 12, 4), (33, 20, 4, 2),
                                       (4096, 1, 12, 4)])
def test_streamed_pair_matches_plain_on_card(B, H, nx, nu):
    """The backward kernel's gains and ok flags against
    riccati_backward_plain; the forward kernel against
    riccati_forward_plain fed the same gains; the pair end to end against
    the plain sweep."""
    _card()
    args = _sweep_inputs(B, H, nx, nu, seed=B + H + nx)
    b0, f0 = rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES
    gains, ok = rk.riccati_backward_cuda(*args)
    out = rk.riccati_forward_cuda(args[0], args[1], args[6], gains)
    torch.cuda.synchronize()
    assert (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES) == (b0 + 1, f0 + 1)
    g_ref, ok_ref = rk.riccati_backward_plain(*args)
    assert torch.equal(ok, ok_ref) and bool(ok_ref.all())
    assert _scaled_err(gains, g_ref) <= STREAMED_ATOL
    same = rk.riccati_forward_plain(args[0], args[1], args[6], gains)
    for o, r in zip(out, same):
        assert _scaled_err(o, r) <= STREAMED_ATOL
    pair = rk.riccati_sweep_streamed_cuda(*args)
    ref = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[3], ref[3])
    for o, r in zip(pair[:3], ref[:3]):
        assert _scaled_err(o, r) <= STREAMED_ATOL


def test_streamed_pair_widest_stage_on_card():
    """nx=32, nu=16, the widest stage the pair takes: both kernels ask for
    more than the default 48 KB of shared memory a block."""
    _card()
    args = _sweep_inputs(9, 3, 32, 16, seed=5)
    pair = rk.riccati_sweep_streamed_cuda(*args)
    ref = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[3], ref[3]) and bool(ref[3].any())
    for o, r in zip(pair[:3], ref[:3]):
        assert _scaled_err(o, r, ref[3]) <= STREAMED_ATOL


def test_streamed_pair_matches_fused_kernel():
    """Both CUDA designs on one function, at the LV fleet's stage."""
    _card()
    args = _sweep_inputs(257, 20, seed=1)
    fused = rk.riccati_sweep_cuda(*args)
    pair = rk.riccati_sweep_streamed_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(fused[3], pair[3])
    for o, r in zip(pair[:3], fused[:3]):
        assert _scaled_err(o, r) <= SCALED_ATOL


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
def test_backward_instance_matches_plain_and_runtime(kind):
    """At the quadrotor's stage (12, 4) the streamed backward entry launches
    the compile-time instance riccati_general_backward_fixed<12, 4, 1, 0>:
    its gains and ok flags against riccati_backward_plain and against the
    run-time kernel on the same inputs.  At (4, 2) the entry takes the
    run-time kernel."""
    _card()
    args = [torch.as_tensor(a, device="cuda") for a in sweep_case(
        kind, B=257, H=50, nx=12, nu=4, seed=11)]
    def counts():
        return (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
                rk.BACKWARD_RUNTIME_LAUNCHES)

    n0 = counts()
    gains, ok = rk.riccati_backward_cuda(*args)
    g_rt, ok_rt = rk.riccati_backward_runtime_cuda(*args)
    torch.cuda.synchronize()
    assert counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    g_ref, ok_ref = rk.riccati_backward_plain(*args)
    want = (torch.arange(257, device="cuda") % 2 == 0
            if kind == "negative_curvature"
            else torch.ones(257, dtype=torch.bool, device="cuda"))
    assert torch.equal(ok_ref, want)
    assert torch.equal(ok, ok_ref) and torch.equal(ok_rt, ok_ref)
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL
    assert _scaled_err(gains, g_rt, ok_ref) <= STREAMED_ATOL
    n1 = counts()
    rk.riccati_backward_cuda(*_sweep_inputs(8, 3, nx=4, nu=2))
    assert counts() == (n1[0] + 1, n1[1], n1[2])


def test_backward_instance_reads_upper_triangles_only():
    """NaN in the strict lower triangles of G and M changes no gain: the
    instance reads their upper triangles in place."""
    _card()
    args = [torch.as_tensor(a, device="cuda") for a in sweep_case(
        "delta_per_problem", B=65, H=20, nx=12, nu=4)]
    gains, ok = rk.riccati_backward_cuda(*args)
    lower = torch.ones(16, 16, dtype=torch.bool, device="cuda").tril(-1)
    for i in (2, 3):
        args[i] = args[i].masked_fill(lower, float("nan"))
    g_nan, ok_nan = rk.riccati_backward_cuda(*args)
    torch.cuda.synchronize()
    assert bool(ok.all()) and torch.equal(ok_nan, ok)
    assert torch.equal(g_nan, gains)


def test_dispatch_and_checks_on_card():
    _card()
    args = _sweep_inputs(64, 5)
    launches, plain = rk.LAUNCHES, rk.PLAIN_CALLS
    bwd, fwd = rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES
    rk.riccati_sweep(*args)                             # (2, 1): fused
    assert (rk.LAUNCHES, rk.PLAIN_CALLS) == (launches + 1, plain)
    rk.riccati_sweep(*_sweep_inputs(8, 3, nx=4, nu=2))  # (4, 2): the pair
    assert (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES) == (bwd + 1, fwd + 1)
    # nu=17 is outside every kernel: the dispatch runs the plain sweep on
    # the card, warns once and counts the fallback; the kernel entry raises
    wide = _sweep_inputs(8, 3, nx=4, nu=17)
    rk._WARNED.discard(("plain", 3, 4, 17, 1, 0))
    fallback = rk.FALLBACK_CALLS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = rk.riccati_sweep(*wide)
        rk.riccati_sweep(*wide)
    ref = rk.riccati_sweep_plain(*wide)
    assert sum("nx=4, nu=17" in str(w.message) for w in caught) == 1
    assert rk.FALLBACK_CALLS == fallback + 2
    assert rk.PLAIN_CALLS == plain + 3     # two fallbacks, one reference
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    with pytest.raises(NotImplementedError, match="nx=4, nu=17"):
        rk.riccati_backward_cuda(*wide)
    with pytest.raises(NotImplementedError, match="nx=4, nu=2"):
        rk.riccati_sweep_cuda(*_sweep_inputs(8, 3, nx=4, nu=2))
    with pytest.raises(TypeError, match="float32"):
        rk.riccati_sweep_cuda(*[a.double() for a in args])
    with pytest.raises(TypeError, match="float32"):
        rk.riccati_backward_cuda(*[a.double() for a in args])
    bad = list(args)
    bad[0] = args[0].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        rk.riccati_sweep_cuda(*bad)
    with pytest.raises(ValueError, match="gains"):
        rk.riccati_forward_cuda(args[0], args[1], args[6],
                                torch.zeros(64, 5, 3, device="cuda"))
    assert rk.LAUNCHES == launches + 1 and rk.PLAIN_CALLS == plain + 3
    assert (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES) == (bwd + 1, fwd + 1)


def _lv(x, u):
    xr = 30.0 * (x + 1.0)
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + 50.0 * u + 0.005 * xr[:, :1] * xr[:, 1:]
    return torch.cat([d1, d2], dim=1) / 30.0


def test_main_path_on_card_matches_cpu():
    """NMPC.next_batch on the card goes through the kernel only and agrees
    with the CPU port (plain sweep) to bench.py's 1e-4 in u."""
    _card()
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, 64), rng.uniform(-0.9, -0.3, 64)],
                   axis=1).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        mpc = nempc.NMPC(
            nempc.torch_dynamics(_lv, 2, 1),
            lambda x, u: 1.1 * torch.sum(u) + 1e-4 * torch.sum(u * u),
            [nempc.DomainConstraint(states_constraint=[[-1.0, 1.0],
                                                       [-1.0, 0.35]],
                                    control_constraint=[[0.0, 1.2]])],
            H=10, DT=0.1, config=nempc.IPConfig(tol=1e-5, polish_iters=5),
            device=dev)
        launches, plain = rk.LAUNCHES, rk.PLAIN_CALLS
        carry, r = mpc.next_batch(torch.tensor(x0s, device=dev))
        carry, r = mpc.next_batch(torch.tensor(x0s, device=dev),
                                  carry=carry)
        if dev == "cuda":
            assert rk.LAUNCHES > launches and rk.PLAIN_CALLS == plain
        res[dev] = r
    assert torch.equal(res["cuda"].converged.cpu(), res["cpu"].converged)
    assert float((res["cuda"].u.cpu() - res["cpu"].u).abs().max()) <= 1e-4


def test_quadrotor_on_card_matches_cpu():
    """The quadrotor fleet (H=50) on the card goes through the streamed
    pair only and agrees with the CPU port to 1e-4 in u."""
    _card()
    from pyneuralempc_tpu_torch.examples.quadrotor import (
        make_quadrotor_mpc, quad_x0s)
    x0s = quad_x0s(np.random.default_rng(0), 16)
    res = {}
    for dev in ("cuda", "cpu"):
        mpc = make_quadrotor_mpc(dev)
        counts = (rk.LAUNCHES, rk.BACKWARD_LAUNCHES, rk.PLAIN_CALLS)
        _, res[dev] = mpc.next_batch(torch.tensor(x0s, device=dev))
        if dev == "cuda":
            assert rk.BACKWARD_LAUNCHES > counts[1]
            assert (rk.LAUNCHES, rk.PLAIN_CALLS) == (counts[0], counts[2])
    assert torch.equal(res["cuda"].converged.cpu(), res["cpu"].converged)
    assert bool(res["cpu"].converged.all())
    assert float((res["cuda"].u.cpu() - res["cpu"].u).abs().max()) <= 1e-4


def _general(kind, B, H, nx, nu, R, r, seed=0):
    return [torch.as_tensor(a, device="cuda") for a in general_sweep_case(
        kind, B=B, H=H, nx=nx, nu=nu, R=R, r=r, seed=seed)]


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
@pytest.mark.parametrize("B,H,nx,nu,R,r", [(257, 50, 12, 4, 2, 1),
                                           (65, 20, 12, 4, 2, 0),
                                           (33, 10, 4, 2, 1, 0),
                                           (9, 3, 32, 16, 65, 2)])
def test_general_pair_matches_plain_on_card(kind, B, H, nx, nu, R, r):
    """The general backward kernel's gains and ok flags against
    riccati_general_backward_plain, the forward kernel against the plain
    forward fed the same gains, the pair against the plain sweep; the
    widest shape asks for more than 48 KB of shared memory a block."""
    _card()
    args = _general(kind, B, H, nx, nu, R, r, seed=B + r)
    b0, f0 = rg.BACKWARD_LAUNCHES, rg.FORWARD_LAUNCHES
    gains, ok = rg.riccati_general_backward_cuda(*args[:12])
    out = rg.riccati_general_forward_cuda(args[0], args[1], args[6],
                                          args[12], gains)
    torch.cuda.synchronize()
    assert (rg.BACKWARD_LAUNCHES, rg.FORWARD_LAUNCHES) == (b0 + 1, f0 + 1)
    g_ref, ok_ref = rg.riccati_general_backward_plain(*args[:12])
    assert torch.equal(ok, ok_ref)
    want = (torch.arange(B, device="cuda") % 2 == 0
            if kind == "negative_curvature"
            else torch.ones(B, dtype=torch.bool, device="cuda"))
    assert torch.equal(ok_ref, want)
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL
    same = rg.riccati_general_forward_plain(args[0], args[1], args[6],
                                            args[12], gains)
    for o, q in zip(out, same):
        if q.numel():
            assert _scaled_err(o, q, ok_ref) <= STREAMED_ATOL
    pair = rg.riccati_sweep_general_streamed_cuda(*args)
    ref = rg.riccati_sweep_general_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[4], ref[4])
    for o, q in zip(pair[:4], ref[:4]):
        if q.numel():
            assert _scaled_err(o, q, ref[4]) <= STREAMED_ATOL


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
def test_general_backward_instance_matches_plain_and_runtime(kind):
    """At the EQ/border fleet's stage (12, 4, 2, 1) the backward entry
    launches the compile-time instance: its gains and ok flags against
    riccati_general_backward_plain and against the run-time kernel on the
    same inputs."""
    _card()
    args = _general(kind, 257, 50, 12, 4, 2, 1, seed=11)[:12]
    n0 = (rg.BACKWARD_LAUNCHES, rg.BACKWARD_INSTANCE_LAUNCHES,
          rg.BACKWARD_RUNTIME_LAUNCHES)
    gains, ok = rg.riccati_general_backward_cuda(*args)
    g_rt, ok_rt = rg.riccati_general_backward_runtime_cuda(*args)
    torch.cuda.synchronize()
    assert (rg.BACKWARD_LAUNCHES, rg.BACKWARD_INSTANCE_LAUNCHES,
            rg.BACKWARD_RUNTIME_LAUNCHES) == (n0[0] + 1, n0[1] + 1,
                                              n0[2] + 1)
    g_ref, ok_ref = rg.riccati_general_backward_plain(*args)
    assert torch.equal(ok, ok_ref) and torch.equal(ok_rt, ok_ref)
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL
    assert _scaled_err(gains, g_rt, ok_ref) <= STREAMED_ATOL


def test_general_backward_instance_reads_upper_triangles_only():
    """NaN in the strict lower triangles of G and M changes nothing: the
    instance reads their upper triangles in place."""
    _card()
    args = _general("delta_per_problem", 65, 20, 12, 4, 2, 1)[:12]
    gains, ok = rg.riccati_general_backward_cuda(*args)
    lower = torch.ones(16, 16, dtype=torch.bool, device="cuda").tril(-1)
    for i in (2, 3):
        args[i] = args[i].masked_fill(lower, float("nan"))
    g_nan, ok_nan = rg.riccati_general_backward_cuda(*args)
    torch.cuda.synchronize()
    assert bool(ok.all()) and torch.equal(ok_nan, ok)
    assert torch.equal(g_nan, gains)


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature"])
def test_general_pair_pure_eq_matches_plain_on_card(kind):
    """r = nu: as many equality rows as controls, so the 4x4 Schur
    complement fixes each stage's control (short horizon: nothing steers
    the states, see sweep_cases.general_sweep_case)."""
    _card()
    args = _general(kind, 129, 10, 12, 4, 1, 4, seed=3)
    pair = rg.riccati_sweep_general_streamed_cuda(*args)
    ref = rg.riccati_sweep_general_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[4], ref[4])
    for o, q in zip(pair[:4], ref[:4]):
        assert _scaled_err(o, q, ref[4]) <= STREAMED_ATOL


def test_general_pair_at_one_rhs_matches_streamed_pair():
    """R=1, r=0: the general pair computes the plain streamed pair's
    function."""
    _card()
    args = _general("delta_per_problem", 257, 50, 12, 4, 1, 0)
    gen = rg.riccati_sweep_general_streamed_cuda(*args)
    plain = rk.riccati_sweep_streamed_cuda(
        *[a[:, :, 0].contiguous() if a.dim() == 4 and i in (4, 5, 6) else a
          for i, a in enumerate(args[:8])])
    torch.cuda.synchronize()
    assert torch.equal(gen[4], plain[3])
    for o, q in zip(gen[:3], plain[:3]):
        assert _scaled_err(o[:, :, 0], q) <= STREAMED_ATOL


def test_general_refusals_on_card():
    """Shapes outside the kernels' range: the dispatch runs the plain
    general sweep on the card (its outputs bit for bit, NaN where the plain
    version's are, one plain call each), the kernel entry raises; malformed
    tensors raise on CUDA tensors, and a refused call launches nothing."""
    _card()
    counts = (rg.BACKWARD_LAUNCHES, rg.FORWARD_LAUNCHES)
    plain = rk.PLAIN_CALLS
    for shape in ((4, 3, 6, 2, 2, 2), (4, 3, 6, 2, 66, 1)):
        B, H, nx, nu, R, r = shape
        rng = np.random.default_rng(0)
        args = [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                device="cuda") for s in (
            (B, H, nx, nx), (B, H, nx, nu), (B, H, nx + nu, nx + nu),
            (B, H, nx + nu, nx + nu), (B, H, R, nx), (B, H, R, nu),
            (B, H, R, nx), (B,), (B,), (B, H, r + 1, nu), (B, H, r + 1, nx),
            (B, H, R, r + 1), (B, H, r + 1, nx))]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = rg.riccati_sweep_general(*args)
        ref = rg.riccati_sweep_general_plain(*args)
        assert all(bool(((o == e) | (o.isnan() & e.isnan())).all())
                   for o, e in zip(out, ref))
        with pytest.raises(NotImplementedError, match="R <= 65"):
            rg.riccati_general_backward_cuda(*args[:12])
    args = _general("delta0", 8, 3, 4, 2, 2, 1)
    with pytest.raises(TypeError, match="float32"):
        rg.riccati_general_backward_cuda(*[a.double() for a in args[:12]])
    bad = list(args)
    bad[4] = args[4].transpose(1, 2)
    with pytest.raises(ValueError, match="mx"):
        rg.riccati_general_backward_cuda(*bad[:12])
    with pytest.raises(ValueError, match="gains"):
        rg.riccati_general_forward_cuda(args[0], args[1], args[6], args[12],
                                        torch.zeros(8, 3, 5, device="cuda"))
    assert (rg.BACKWARD_LAUNCHES, rg.FORWARD_LAUNCHES) == counts
    assert rk.PLAIN_CALLS == plain + 4     # two fallbacks, two references


def test_fleet_eq_on_card_matches_cpu():
    """The EQ/border quadrotor fleet on the card goes through the general
    pair only and agrees with the CPU port to 1e-4 in u."""
    _card()
    from pyneuralempc_tpu_torch.examples.fleet_eq import (make_fleet_eq_mpc,
                                                          yaw_residual)
    from pyneuralempc_tpu_torch.examples.quadrotor import quad_x0s
    x0s = quad_x0s(np.random.default_rng(0), 16)
    res = {}
    for dev in ("cuda", "cpu"):
        mpc = make_fleet_eq_mpc(dev)
        counts = (rk.LAUNCHES, rk.BACKWARD_LAUNCHES, rk.PLAIN_CALLS,
                  rg.BACKWARD_LAUNCHES)
        _, res[dev] = mpc.next_batch(torch.tensor(x0s, device=dev))
        if dev == "cuda":
            assert rg.BACKWARD_LAUNCHES > counts[3]
            assert (rk.LAUNCHES, rk.BACKWARD_LAUNCHES,
                    rk.PLAIN_CALLS) == counts[:3]
    assert torch.equal(res["cuda"].converged.cpu(), res["cpu"].converged)
    assert bool(res["cpu"].converged.all())
    assert float(yaw_residual(res["cuda"].u).max()) <= 1e-4
    assert float((res["cuda"].u.cpu() - res["cpu"].u).abs().max()) <= 1e-4


# ---- the fused general kernel (csrc/riccati_general_fused.cu) ----

KINDS = ["delta0", "delta_per_problem", "negative_curvature", "local_bump"]
# odd batches, H=1, every instantiated (R, r); local_bump needs r < nu and
# a second stage
FUSED_CASES = [(kind, B, H, R, r)
               for B, H, R, r in ((257, 20, 2, 0), (33, 20, 2, 1),
                                  (65, 20, 3, 0), (129, 10, 1, 1),
                                  (4096, 1, 3, 1), (31, 7, 3, 1))
               for kind in KINDS
               if kind != "local_bump" or (r == 0 and H > 1)]


@pytest.mark.parametrize("kind,B,H,R,r", FUSED_CASES)
def test_fused_general_matches_plain_on_card(kind, B, H, R, r):
    """The fused general kernel against riccati_sweep_general_plain, its
    ok flags as expected, and its gains scratch against
    riccati_general_backward_plain's gains."""
    _card()
    args = _general(kind, B, H, 2, 1, R, r, seed=B + H + r)
    n0 = rg.FUSED_LAUNCHES
    *out, gains = rg.riccati_sweep_general_fused_cuda(*args,
                                                      return_gains=True)
    torch.cuda.synchronize()
    assert rg.FUSED_LAUNCHES == n0 + 1
    ref = rg.riccati_sweep_general_plain(*args)
    g_ref, ok_ref = rg.riccati_general_backward_plain(*args[:12])
    want = (torch.arange(B, device="cuda") % 2 == 0
            if kind == "negative_curvature"
            else torch.ones(B, dtype=torch.bool, device="cuda"))
    assert torch.equal(out[4], ref[4]) and torch.equal(ref[4], want)
    for o, q in zip(out[:4], ref[:4]):
        if q.numel():
            assert _scaled_err(o, q, ref[4]) <= STREAMED_ATOL
    assert gains.shape == g_ref.shape
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL


@pytest.mark.parametrize("R,r", [(2, 0), (2, 1), (3, 0)])
def test_fused_general_matches_general_pair(R, r):
    """Both CUDA designs of the general sweep on one function."""
    _card()
    args = _general("delta_per_problem", 257, 20, 2, 1, R, r, seed=4)
    fused = rg.riccati_sweep_general_fused_cuda(*args)
    pair = rg.riccati_sweep_general_streamed_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(fused[4], pair[4]) and bool(pair[4].all())
    for o, q in zip(fused[:4], pair[:4]):
        if q.numel():
            assert _scaled_err(o, q) <= STREAMED_ATOL


def test_fused_general_dispatch_and_refusals_on_card():
    """At an instantiated shape the dispatch launches the fused general
    kernel and nothing else; other shapes and malformed tensors raise and
    launch nothing."""
    _card()
    args = _general("delta0", 64, 5, 2, 1, 2, 0)
    counts = (rk.LAUNCHES, rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES,
              rk.PLAIN_CALLS, rg.BACKWARD_LAUNCHES, rg.FORWARD_LAUNCHES)
    n0 = rg.FUSED_LAUNCHES
    rg.riccati_sweep_general(*args)
    torch.cuda.synchronize()
    assert rg.FUSED_LAUNCHES == n0 + 1
    with pytest.raises(NotImplementedError, match="instantiates"):
        rg.riccati_sweep_general_fused_cuda(
            *_general("delta0", 8, 3, 4, 2, 2, 1))
    with pytest.raises(TypeError, match="float32"):
        rg.riccati_sweep_general_fused_cuda(*[a.double() for a in args])
    bad = list(args)
    bad[6] = args[6].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rg.riccati_sweep_general_fused_cuda(*bad)
    assert rg.FUSED_LAUNCHES == n0 + 1
    assert (rk.LAUNCHES, rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES,
            rk.PLAIN_CALLS, rg.BACKWARD_LAUNCHES,
            rg.FORWARD_LAUNCHES) == counts


# ---- the staged fused general kernel against the plain version and the
#      direct (first) kernel ----

STAGED_CASES = [(kind, R, r) for _, _, R, r in sorted(rk._GENERAL_INSTANCES)
                for kind in KINDS if kind != "local_bump" or r == 0]


def _same_bits(a, b):
    """Equal element for element, NaN where the other is NaN (a problem
    whose factorisation failed may carry NaN through its stages)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _staged_vs_plain_and_direct(args):
    """The staged kernel (with and without its gains written) against
    riccati_sweep_general_plain and riccati_general_backward_plain, and
    against the direct kernel on the same inputs; the launch counters."""
    counts = (rg.FUSED_LAUNCHES, rg.FUSED_STAGED_LAUNCHES,
              rg.FUSED_DIRECT_LAUNCHES)
    *out, gains = rg.riccati_sweep_general_fused_cuda(*args,
                                                      return_gains=True)
    bare = rg.riccati_sweep_general_fused_cuda(*args)
    *direct, d_gains = rg.riccati_sweep_general_fused_direct_cuda(
        *args, return_gains=True)
    torch.cuda.synchronize()
    assert (rg.FUSED_LAUNCHES, rg.FUSED_STAGED_LAUNCHES,
            rg.FUSED_DIRECT_LAUNCHES) == (counts[0] + 3, counts[1] + 2,
                                          counts[2] + 1)
    ref = rg.riccati_sweep_general_plain(*args)
    g_ref, _ = rg.riccati_general_backward_plain(*args[:12])
    ok = ref[4]
    assert torch.equal(out[4], ok) and torch.equal(direct[4], ok)
    for o, b, d, q in zip(out[:4], bare[:4], direct[:4], ref[:4]):
        _same_bits(o, b)               # the gains' store changes no sum
        if q.numel():
            assert _scaled_err(o, q, ok) <= STREAMED_ATOL
            assert _scaled_err(o, d, ok) <= STREAMED_ATOL
    assert _scaled_err(gains, g_ref, ok) <= STREAMED_ATOL
    assert _scaled_err(gains, d_gains, ok) <= STREAMED_ATOL
    return out


@pytest.mark.parametrize("kind,R,r", STAGED_CASES)
def test_fused_staged_matches_plain_and_direct(kind, R, r):
    """Every instance at H=20 (32 problems a block, the last block holding
    9): the staged kernel against the plain version and the direct
    kernel."""
    _card()
    B, H = 1001, 20
    plan = rk.kernel_plan(H, 2, 1, "cuda", R=R, r=r)
    assert plan["kernel"] == rk.STAGED_KERNEL and plan["block_problems"] == 32
    _staged_vs_plain_and_direct(_general(kind, B, H, 2, 1, R, r, seed=R + r))


@pytest.mark.parametrize("kind", KINDS)
def test_fused_staged_ragged_blocks_at_h50(kind):
    """At H=50 a block holds 24 problems; B=257 leaves 17 in the last."""
    _card()
    assert rk.staged_block_problems(50, 2, 1, 2, 0) == 24
    _staged_vs_plain_and_direct(_general(kind, 257, 50, 2, 1, 2, 0, seed=7))


def _misaligned(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("R,r", [(2, 0), (3, 1)])
def test_fused_staged_misaligned_inputs(R, r):
    """Inputs 4 bytes off a 16-byte boundary take 4-byte copies: the same
    outputs as the aligned inputs, bit for bit, and the plain version's."""
    _card()
    args = _general("delta_per_problem", 257, 20, 2, 1, R, r, seed=11)
    mis = [_misaligned(a) for a in args]
    mask = rg._aligned_mask(mis)
    for i, a in enumerate(mis):
        if a.numel():       # (E, F, h, Jx are empty at r=0, never read)
            assert a.data_ptr() % 16 == 4 and not (mask >> i) & 1
    out = _staged_vs_plain_and_direct(mis)
    aligned = rg.riccati_sweep_general_fused_cuda(*args)
    torch.cuda.synchronize()
    for o, a in zip(out, aligned):
        _same_bits(o, a)


def test_fused_general_takes_the_direct_kernel_past_shared_memory():
    """At a horizon where not one problem fits in a staged block the
    wrapper launches the direct kernel, and it matches the plain version."""
    _card()
    H = 1300
    assert rk.staged_block_problems(H, 2, 1, 2, 0) == 0
    assert rk.kernel_plan(H, 2, 1, "cuda", R=2, r=0)["kernel"] == \
        rk.DIRECT_KERNEL
    args = _general("delta_per_problem", 5, H, 2, 1, 2, 0, seed=3)
    counts = (rg.FUSED_STAGED_LAUNCHES, rg.FUSED_DIRECT_LAUNCHES)
    out = rg.riccati_sweep_general_fused_cuda(*args)
    torch.cuda.synchronize()
    assert (rg.FUSED_STAGED_LAUNCHES, rg.FUSED_DIRECT_LAUNCHES) == (
        counts[0], counts[1] + 1)
    ref = rg.riccati_sweep_general_plain(*args)
    assert torch.equal(out[4], ref[4]) and bool(ref[4].all())
    for o, q in zip(out[:4], ref[:4]):
        if q.numel():
            assert _scaled_err(o, q) <= STREAMED_ATOL


def test_budget_fleet_on_card_matches_cpu():
    """The budgeted LV fleet (true ODE, H=20) on the card goes through the
    fused general kernel only and agrees with the CPU port: equal masks,
    the floor held, equal objectives to 1e-5, and |Δu|∞ ≤ 1e-4 on every
    member whose CPU plan moves by under 5e-5 when its start moves by
    ±1e-7 (with the floor binding, feed moved between stages at constant
    Σu is tie-broken only by the 1e-4·Σu² term, and f32 does not fix those
    plans to 1e-4: see PERF.md), 1e-4 + 2× that move on the others."""
    _card()
    from pyneuralempc_tpu_torch.examples.lotka_volterra import (
        U_FLOOR, make_budget_mpc, normalized_lv)
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, 16), rng.uniform(-0.9, -0.3, 16)],
                   axis=1).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        mpc = make_budget_mpc(nempc.torch_dynamics(normalized_lv(), 2, 1),
                              device=dev)
        counts = (rk.LAUNCHES, rk.BACKWARD_LAUNCHES, rk.PLAIN_CALLS,
                  rg.BACKWARD_LAUNCHES, rg.FUSED_LAUNCHES,
                  rg.FUSED_STAGED_LAUNCHES, rg.FUSED_DIRECT_LAUNCHES)
        _, res[dev] = mpc.next_batch(torch.tensor(x0s, device=dev))
        if dev == "cuda":
            assert rg.FUSED_LAUNCHES > counts[4]
            assert (rg.FUSED_STAGED_LAUNCHES - counts[5]
                    == rg.FUSED_LAUNCHES - counts[4])
            assert rg.FUSED_DIRECT_LAUNCHES == counts[6]
            assert (rk.LAUNCHES, rk.BACKWARD_LAUNCHES, rk.PLAIN_CALLS,
                    rg.BACKWARD_LAUNCHES) == counts[:4]
        else:
            moved = torch.zeros(16)
            for eps in (1e-7, -1e-7):
                _, r2 = mpc.next_batch(torch.tensor(x0s + np.float32(eps)))
                moved = torch.maximum(moved, (r2.u - res["cpu"].u).abs()
                                      .amax(dim=(1, 2)))
    card, cpu = res["cuda"], res["cpu"]
    assert torch.equal(card.converged.cpu(), cpu.converged)
    assert bool(cpu.converged.all())
    assert float(card.u.sum(dim=(1, 2)).min()) >= U_FLOOR - 1e-3
    assert float((card.objective.cpu() - cpu.objective).abs().max()) <= 1e-5
    determined = moved <= 5e-5
    assert int(determined.sum()) >= 12
    du = (card.u.cpu() - cpu.u).abs().amax(dim=(1, 2))
    assert float(du[determined].max()) <= 1e-4
    # the other members within what f32 leaves open
    assert bool((du <= 1e-4 + 2.0 * moved).all())


# ---- the fused plain sweep through the staged kernel at <2, 1, 1, 0> ----

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,H", [(1001, 20), (257, 50)])
def test_fused_plain_staged_matches_plain_and_direct(kind, B, H):
    """riccati_sweep_cuda takes the staged kernel at <2, 1, 1, 0> (32
    problems a block at H=20, 29 at H=50, the last block ragged): its ok
    flags equal riccati_sweep_plain's and csrc/riccati_sweep.cu's
    (riccati_sweep_direct_cuda), its outputs within SCALED_ATOL of both;
    the launch counters split the fused launches by kernel."""
    _card()
    P = rk.staged_block_problems(H, 2, 1, 1, 0)
    plan = rk.kernel_plan(H, 2, 1, "cuda")
    assert (plan["kernel"], plan["block_problems"]) == (rk.STAGED_KERNEL, P)
    assert P == {20: 32, 50: 29}[H]
    args = [torch.as_tensor(a, device="cuda")
            for a in sweep_case(kind, B=B, H=H, nx=2, nu=1, seed=B + H)]
    n0 = (rk.LAUNCHES, rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES)
    out = rk.riccati_sweep_cuda(*args)
    direct = rk.riccati_sweep_direct_cuda(*args)
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES) == (
        n0[0] + 2, n0[1] + 1, n0[2] + 1)
    ref = rk.riccati_sweep_plain(*args)
    ok = ref[3]
    want = (torch.arange(B, device="cuda") % 2 == 0
            if kind == "negative_curvature"
            else torch.ones(B, dtype=torch.bool, device="cuda"))
    assert torch.equal(ok, want)
    assert torch.equal(out[3], ok) and torch.equal(direct[3], ok)
    for o, d, q in zip(out[:3], direct[:3], ref[:3]):
        assert _scaled_err(o, q, ok) <= SCALED_ATOL
        assert _scaled_err(o, d, ok) <= SCALED_ATOL


def test_fused_plain_staged_misaligned_and_past_shared_memory():
    """Inputs 4 bytes off a 16-byte boundary give the aligned outputs bit
    for bit; at a horizon where not one problem fits a staged block the
    wrapper launches csrc/riccati_sweep.cu, which matches the plain
    sweep."""
    _card()
    args = _sweep_inputs(257, 20, seed=4)
    out = rk.riccati_sweep_cuda(*args)
    mis = [_misaligned(a) for a in args]
    assert rk._aligned_mask(mis) == 0
    n0 = rk.STAGED_LAUNCHES
    moved = rk.riccati_sweep_cuda(*mis)
    torch.cuda.synchronize()
    assert rk.STAGED_LAUNCHES == n0 + 1
    for o, m in zip(out, moved):
        _same_bits(o, m)
    H = 2000
    assert rk.staged_block_problems(H, 2, 1, 1, 0) == 0
    assert rk.kernel_plan(H, 2, 1, "cuda")["kernel"] == rk.SWEEP_KERNEL
    args = _sweep_inputs(5, H, seed=2)
    n0 = (rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES)
    out = rk.riccati_sweep_cuda(*args)
    torch.cuda.synchronize()
    assert (rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES) == (n0[0], n0[1] + 1)
    ref = rk.riccati_sweep_plain(*args)
    assert torch.equal(out[3], ref[3]) and bool(ref[3].all())
    for o, q in zip(out[:3], ref[:3]):
        assert _scaled_err(o, q) <= SCALED_ATOL


# ---- the general forward kernel's compile-time instance ----

def _forward_inputs(kind, B, H, seed):
    """The EQ/border stage's forward inputs and the plain backward's gains
    (so every kernel is fed the same gains), with the ok flags."""
    args = _general(kind, B, H, 12, 4, 2, 1, seed=seed)
    gains, ok = rg.riccati_general_backward_plain(*args[:12])
    return [args[0], args[1], args[6], args[12], gains], ok


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", [50, 7])
def test_general_forward_instance_matches_plain_and_runtime(kind, H):
    """At (12, 4, 2, 1) the forward entry launches the compile-time
    instance: against riccati_general_forward_plain and the run-time
    forward kernel fed the same gains, and the launch counters."""
    _card()
    assert rk.general_forward_kernel(12, 4, 2, 1) == \
        "riccati_general_forward_fixed<12, 4, 2, 1, 2>"
    ins, ok = _forward_inputs(kind, 257, H, seed=H)
    n0 = (rg.FORWARD_LAUNCHES, rg.FORWARD_INSTANCE_LAUNCHES,
          rg.FORWARD_RUNTIME_LAUNCHES)
    outs = [rg.riccati_general_forward_cuda(*ins) for _ in range(2)]
    rt = rg.riccati_general_forward_runtime_cuda(*ins)
    torch.cuda.synchronize()
    n = len(outs)
    assert (rg.FORWARD_LAUNCHES, rg.FORWARD_INSTANCE_LAUNCHES,
            rg.FORWARD_RUNTIME_LAUNCHES) == (n0[0] + n, n0[1] + n, n0[2] + 1)
    ref = rg.riccati_general_forward_plain(*ins)
    for out in outs:
        for o, r, q in zip(out, rt, ref):
            assert _scaled_err(o, q, ok) <= STREAMED_ATOL
            assert _scaled_err(o, r, ok) <= STREAMED_ATOL
        for o, first in zip(out, outs[0]):
            _same_bits(o, first)        # launch to launch, bit for bit


def test_general_forward_instance_misaligned_inputs():
    """Inputs 4 bytes off a 16-byte boundary (and the gains of an odd
    stage 8 bytes off at every other stage) take narrower copies: the
    plain version's outputs, and the aligned inputs' bit for bit."""
    _card()
    ins, ok = _forward_inputs("delta_per_problem", 257, 50, seed=5)
    aligned = rg.riccati_general_forward_cuda(*ins)
    mis = [_misaligned(a) for a in ins]
    assert all(a.data_ptr() % 16 == 4 for a in mis)
    moved = rg.riccati_general_forward_cuda(*mis)
    torch.cuda.synchronize()
    ref = rg.riccati_general_forward_plain(*ins)
    for m, a, q in zip(moved, aligned, ref):
        _same_bits(m, a)
        assert _scaled_err(m, q, ok) <= STREAMED_ATOL


# ---- the new paths' stages, per-member inputs, multi-start ----

KINDS4 = ["delta0", "delta_per_problem", "negative_curvature", "local_bump"]


@pytest.mark.parametrize("kind", KINDS4)
@pytest.mark.parametrize("B,H,nx", [(1024, 100, 10), (1, 50, 4),
                                    (257, 50, 4)])
def test_runtime_pair_at_new_stages(kind, B, H, nx):
    """The streamed pair at the GRU fleet's lifted stage (10, 1), H=100, and
    at cartpole's (4, 1), H=50 (one problem, as the swing-up solves, and a
    batch), where both entries launch their compile-time instances: gains
    and ok flags against the plain backward and the run-time backward
    kernel, the forward instance against the plain forward and the run-time
    forward kernel on the same gains, the pair end to end; the counters."""
    _card()
    assert (nx, 1) in rk._BACKWARD_INSTANCES
    assert rk.backward_kernel(nx, 1).startswith(
        "riccati_general_backward_fixed<")
    assert rk.forward_kernel(nx, 1).startswith(
        "riccati_general_forward_fixed<")
    assert rk.kernel_plan(H, nx, 1, "cuda")["path"] == "cuda_streamed"
    args = [torch.as_tensor(a, device="cuda")
            for a in sweep_case(kind, B=B, H=H, nx=nx, nu=1, seed=nx)]

    def counts():
        return (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
                rk.BACKWARD_RUNTIME_LAUNCHES, rk.FORWARD_LAUNCHES,
                rk.FORWARD_INSTANCE_LAUNCHES, rk.FORWARD_RUNTIME_LAUNCHES)

    n0 = counts()
    gains, ok = rk.riccati_backward_cuda(*args)
    g_rt, ok_rt = rk.riccati_backward_runtime_cuda(*args)
    out = rk.riccati_forward_cuda(args[0], args[1], args[6], gains)
    rt = rk.riccati_forward_runtime_cuda(args[0], args[1], args[6], gains)
    torch.cuda.synchronize()
    assert counts() == tuple(a + 1 for a in n0)
    g_ref, ok_ref = rk.riccati_backward_plain(*args)
    assert torch.equal(ok, ok_ref) and torch.equal(ok_rt, ok_ref)
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL
    assert _scaled_err(gains, g_rt, ok_ref) <= STREAMED_ATOL
    same = rk.riccati_forward_plain(args[0], args[1], args[6], gains)
    for o, r, q in zip(out, same, rt):
        assert _scaled_err(o, r, ok_ref) <= STREAMED_ATOL
        assert _scaled_err(o, q, ok_ref) <= STREAMED_ATOL
    pair = rk.riccati_sweep_streamed_cuda(*args)
    ref = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[3], ref[3])
    for o, r in zip(pair[:3], ref[:3]):
        assert _scaled_err(o, r, ref[3]) <= STREAMED_ATOL


@pytest.mark.parametrize("kind", KINDS4)
def test_backward_instance_at_the_gru_quadrotor_stage(kind):
    """The quadrotor GRU's lifted stage (28, 4) at its cell's B=4096,
    H=100: the backward entry launches riccati_general_backward_fixed<28,
    4, 1, 0> (the tall tiles at nu = 4), the forward entry
    riccati_general_forward_fixed<28, 4, 1, 0, 3>.  Gains and ok flags
    against the plain backward and the run-time backward kernel, the
    forward instance against the plain forward and, on the problems whose
    factorisation held, bit for bit against the run-time forward kernel on
    the same gains, the pair end to end against
    the plain sweep, all within STREAMED_ATOL scaled; the counters."""
    _card()
    assert rk.backward_kernel(28, 4) == (
        "riccati_general_backward_fixed<28, 4, 1, 0>")
    assert rk.forward_kernel(28, 4) == (
        "riccati_general_forward_fixed<28, 4, 1, 0, 3>")
    args = [torch.as_tensor(a, device="cuda")
            for a in sweep_case(kind, B=4096, H=100, nx=28, nu=4, seed=28)]
    n0 = (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
          rk.FORWARD_LAUNCHES, rk.FORWARD_INSTANCE_LAUNCHES)
    gains, ok = rk.riccati_backward_cuda(*args)
    out = rk.riccati_forward_cuda(args[0], args[1], args[6], gains)
    torch.cuda.synchronize()
    assert (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
            rk.FORWARD_LAUNCHES, rk.FORWARD_INSTANCE_LAUNCHES) == (
        n0[0] + 1, n0[1] + 1, n0[2] + 1, n0[3] + 1)
    for o, r in zip(out, rk.riccati_forward_runtime_cuda(
            args[0], args[1], args[6], gains)):
        _same_bits(o[ok], r[ok])
    g_rt, ok_rt = rk.riccati_backward_runtime_cuda(*args)
    g_ref, ok_ref = rk.riccati_backward_plain(*args)
    assert torch.equal(ok, ok_ref) and torch.equal(ok_rt, ok_ref)
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL
    assert _scaled_err(gains, g_rt, ok_ref) <= STREAMED_ATOL
    del g_rt, g_ref
    same = rk.riccati_forward_plain(args[0], args[1], args[6], gains)
    for o, r in zip(out, same):
        assert _scaled_err(o, r, ok_ref) <= STREAMED_ATOL
    del same, out, gains
    pair = rk.riccati_sweep_streamed_cuda(*args)
    ref = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[3], ref[3])
    for o, r in zip(pair[:3], ref[:3]):
        assert _scaled_err(o, r, ref[3]) <= STREAMED_ATOL


@pytest.mark.parametrize("kind", KINDS4)
@pytest.mark.parametrize("H", [50, 7])
def test_streamed_forward_instance_at_the_quadrotor_stage(kind, H):
    """At (12, 4) the streamed forward entry launches its compile-time
    instance: against the plain forward and the run-time forward kernel fed
    the same gains, launch to launch bit for bit, and the counters."""
    _card()
    args = [torch.as_tensor(a, device="cuda")
            for a in sweep_case(kind, B=257, H=H, nx=12, nu=4, seed=H)]
    gains, ok = rk.riccati_backward_plain(*args)
    ins = (args[0], args[1], args[6], gains)
    n0 = (rk.FORWARD_LAUNCHES, rk.FORWARD_INSTANCE_LAUNCHES,
          rk.FORWARD_RUNTIME_LAUNCHES)
    outs = [rk.riccati_forward_cuda(*ins) for _ in range(2)]
    rt = rk.riccati_forward_runtime_cuda(*ins)
    torch.cuda.synchronize()
    assert (rk.FORWARD_LAUNCHES, rk.FORWARD_INSTANCE_LAUNCHES,
            rk.FORWARD_RUNTIME_LAUNCHES) == (n0[0] + 2, n0[1] + 2, n0[2] + 1)
    ref = rk.riccati_forward_plain(*ins)
    for out in outs:
        for o, r, q in zip(out, rt, ref):
            assert _scaled_err(o, q, ok) <= STREAMED_ATOL
            assert _scaled_err(o, r, ok) <= STREAMED_ATOL
        for o, first in zip(out, outs[0]):
            _same_bits(o, first)


@pytest.mark.parametrize("nx,nu", sorted(rk._FORWARD_INSTANCES))
def test_streamed_instances_repeat_at_any_alignment(nx, nu):
    """At each instance's shape the backward instance gives its gains and ok
    flags launch to launch bit for bit, and the forward instance fed inputs
    4 bytes off a 16-byte boundary gives the aligned inputs' outputs."""
    _card()
    H = 100 if nx == 10 else 50
    args = [torch.as_tensor(a, device="cuda") for a in sweep_case(
        "delta_per_problem", B=129, H=H, nx=nx, nu=nu, seed=3)]
    gains, ok = rk.riccati_backward_cuda(*args)
    again, ok2 = rk.riccati_backward_cuda(*args)
    _same_bits(again, gains)
    assert torch.equal(ok2, ok)
    ins = (args[0], args[1], args[6], gains)
    out = rk.riccati_forward_cuda(*ins)
    moved = rk.riccati_forward_cuda(*[_misaligned(a) for a in ins])
    torch.cuda.synchronize()
    for m, q in zip(moved, out):
        _same_bits(m, q)


@pytest.mark.parametrize("kind", KINDS4)
@pytest.mark.parametrize("H", [50, 7])
def test_wide_pair_at_12_10(kind, H):
    """The wide fleet's stage (12, 10): both entries take their
    compile-time instances (the backward one with Quu factored one row a
    lane).  Gains and ok flags against the plain backward and against the
    run-time backward kernel, the forward instance against the plain
    forward and bit for bit against the run-time forward kernel on the same
    gains, the pair end to end, and the counters."""
    _card()
    assert rk.backward_kernel(12, 10) == (
        "riccati_general_backward_fixed<12, 10, 1, 0>")
    assert rk.forward_kernel(12, 10).startswith(
        "riccati_general_forward_fixed<12, 10, 1, 0, ")
    args = [torch.as_tensor(a, device="cuda")
            for a in sweep_case(kind, B=257, H=H, nx=12, nu=10, seed=H)]

    def counts():
        return (rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
                rk.BACKWARD_RUNTIME_LAUNCHES, rk.FORWARD_LAUNCHES,
                rk.FORWARD_INSTANCE_LAUNCHES, rk.FORWARD_RUNTIME_LAUNCHES)

    n0 = counts()
    gains, ok = rk.riccati_backward_cuda(*args)
    g_rt, ok_rt = rk.riccati_backward_runtime_cuda(*args)
    ins = (args[0], args[1], args[6], gains)
    out = rk.riccati_forward_cuda(*ins)
    rt = rk.riccati_forward_runtime_cuda(*ins)
    torch.cuda.synchronize()
    assert counts() == tuple(a + 1 for a in n0)
    g_ref, ok_ref = rk.riccati_backward_plain(*args)
    assert torch.equal(ok, ok_ref) and torch.equal(ok_rt, ok_ref)
    assert _scaled_err(gains, g_ref, ok_ref) <= STREAMED_ATOL
    assert _scaled_err(gains, g_rt, ok_ref) <= STREAMED_ATOL
    ref = rk.riccati_forward_plain(*ins)
    for o, r, q in zip(out, ref, rt):
        assert _scaled_err(o, r, ok_ref) <= STREAMED_ATOL
        _same_bits(o, q)
    pair = rk.riccati_sweep_streamed_cuda(*args)
    plain = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pair[3], plain[3])
    for o, r in zip(pair[:3], plain[:3]):
        assert _scaled_err(o, r, plain[3]) <= STREAMED_ATOL


def test_wide_fleet_card_matches_cpu():
    """Eight wide-fleet problems (12 states, 10 thrusts, H=20) cold and one
    warm re-plan on the card and on the CPU: equal masks and iterations,
    |Δu|∞ ≤ 1e-4, and the card's sweeps through the (12, 10) pair."""
    _card()
    from pyneuralempc_tpu_torch.examples import fleet_wide
    xs = fleet_wide.wide_x0s(np.random.default_rng(0), 8)
    out = {}
    for dev in ("cuda", "cpu"):
        mpc = fleet_wide.make_fleet_wide_mpc(dev, H=20)
        n0 = (rk.FORWARD_INSTANCE_LAUNCHES, rk.BACKWARD_LAUNCHES)
        carry, cold = mpc.next_batch(torch.tensor(xs, device=dev))
        _, warm = mpc.next_batch(cold.x[:, 0].contiguous(), carry=carry)
        if dev == "cuda":
            assert rk.FORWARD_INSTANCE_LAUNCHES > n0[0]
            assert rk.BACKWARD_LAUNCHES > n0[1]
        out[dev] = (cold, warm)
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert bool(cpu.converged.all())
        assert torch.equal(card.converged.cpu(), cpu.converged)
        assert torch.equal(card.iterations.cpu(), cpu.iterations)
        assert float((card.u.cpu() - cpu.u).abs().max()) <= 1e-4


def _decay_mpc(device):
    """ẋ = −params·x + u tracking x = 0.5 with a small control cost (RK4,
    H=10): a strongly convex problem, so f32 rounding stays small."""
    def f(x, u, p, tvp, params):
        return -params * x + u
    return nempc.NMPC(nempc.DynamicsModel(fn=f, dims=nempc.Dims(2, 1, 0, 0)),
                      lambda x, u: torch.sum((x - 0.5) ** 2)
                      + 0.1 * torch.sum(u * u),
                      [nempc.DomainConstraint(
                          states_constraint=[[-2.0, 2.0]] * 2,
                          control_constraint=[[-1.0, 1.0]])],
                      H=10, DT=0.1, integrator="rk4", device=device)


def test_per_member_stacked_params_equal_shared_on_card():
    """Per-member params on the card: one value a member, every member the
    shared value, gives the shared solve's plans (1e-5); distinct values
    agree with the CPU port (1e-4), cold and warm, with equal masks.  (The
    LV surrogate stacked B times: chip_smoke.py phase 4, which holds the
    members f32 fixes only loosely to what a 1e-7 move of their start
    does.)"""
    _card()
    B = 64
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    mpc = _decay_mpc("cuda")
    xs = torch.tensor(x0s, device="cuda")
    _, shared = mpc.next_batch(xs, params=torch.tensor(0.5, device="cuda"))
    _, per = mpc.next_batch(xs, params=torch.full((B,), 0.5, device="cuda"))
    assert bool(shared.converged.all())
    assert torch.equal(per.converged, shared.converged)
    assert float((per.u - shared.u).abs().max()) <= 1e-5
    rates = rng.uniform(0.2, 2.0, B).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        m = _decay_mpc(dev)
        prm = torch.tensor(rates, device=dev)
        carry, cold = m.next_batch(torch.tensor(x0s, device=dev), params=prm)
        _, warm = m.next_batch(cold.x[:, 0].contiguous(), params=prm,
                               carry=carry)
        out[dev] = (cold, warm)
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert torch.equal(card.converged.cpu(), cpu.converged)
        assert bool(cpu.converged.all())
        assert float((card.u.cpu() - cpu.u).abs().max()) <= 1e-4


def test_multi_start_draws_equal_on_card_and_cpu():
    """The multi-start perturbations come from the caller's CPU generator:
    the card and the CPU start from the same numbers, and cartpole's
    multi-start (H=10, 4 starts, cut at 20 iterations) picks the same
    winner with the same plan to 1e-4."""
    _card()
    from pyneuralempc_tpu_torch.api.controller import (
        multi_start_perturbations)
    from pyneuralempc_tpu_torch.examples import cartpole
    a = multi_start_perturbations(torch.Generator().manual_seed(3), 4, 10, 1)
    b = multi_start_perturbations(torch.Generator().manual_seed(3), 4, 10, 1)
    assert a.device.type == "cpu" and torch.equal(a, b)
    out = {}
    for dev in ("cuda", "cpu"):
        mpc = cartpole.make_cartpole_mpc(dev, H=10, max_iter=20)
        out[dev] = mpc.next_multi_start(
            torch.tensor(cartpole.X_HANGING, device=dev), n_starts=4,
            generator=torch.Generator().manual_seed(3), return_index=True)
    (card, i_card), (cpu, i_cpu) = out["cuda"], out["cpu"]
    assert i_card == i_cpu
    assert bool(card.converged.cpu()) == bool(cpu.converged)
    assert float((card.u.cpu() - cpu.u).abs().max()) <= 1e-4


# ---- the tanh layers' tangent kernels (ops/cuda/tanh_dense.py) ----

# Each kernel sums a row's K (K1) or N (K2) products in float32 in another
# order than any library GEMM: held against its plain version in float64
# on the same inputs, to 2e-5 of the output's scale (f32's 6e-8 times a
# few hundred terms, with room).
TANH_ATOL = 2e-5


def _tanh_case(P, T, K, N, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    return {"hd": rand(P, T, K), "gd": rand(P, T, N), "yd": rand(P, T, N),
            "y": torch.tanh(rand(P, N)), "g": rand(P, N),
            "W": rand(K, N) / K ** 0.5}


def _tanh_close(out, ref):
    err = float((out.double() - ref).abs().max())
    assert err <= TANH_ATOL * max(1.0, float(ref.abs().max())), err


def _f64(*ts):
    return [None if t is None else t.double() for t in ts]


@pytest.mark.parametrize("kernel,K,N", [("k1", 19, 256), ("k1", 256, 256),
                                        ("k2", 256, 256), ("k2", 19, 256)])
def test_tanh_kernels_match_plain_at_the_cells_shapes(kernel, K, N):
    """The stage blocks' shapes at B=2048, H=50: 102,400 primal rows of 16
    tangents; K1 into the first layer (19 -> 256) and the second (256 ->
    256), K2 out of the second (256 -> 256) and into the first (256 ->
    19).  One launch a call."""
    _card()
    from pyneuralempc_tpu_torch.ops.cuda import tanh_dense as td
    c = _tanh_case(102_400, 16, K, N)
    launches = (td.K1_LAUNCHES, td.K2_LAUNCHES)
    if kernel == "k1":
        out = td.tangent_fwd_cuda(c["hd"], c["y"], c["W"])
        _tanh_close(out, td.tangent_fwd_plain(*_f64(c["hd"], c["y"],
                                                     c["W"])))
        assert (td.K1_LAUNCHES, td.K2_LAUNCHES) == (launches[0] + 1,
                                                    launches[1])
    else:
        out = td.tangent_vjp_cuda(c["gd"], c["yd"], c["g"], c["y"], c["W"])
        _tanh_close(out, td.tangent_vjp_plain(*_f64(
            c["gd"], c["yd"], c["g"], c["y"], c["W"])))
        assert (td.K1_LAUNCHES, td.K2_LAUNCHES) == (launches[0],
                                                    launches[1] + 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("P,T,K,N", [(37, 5, 19, 33), (1, 1, 3, 32),
                                     (129, 3, 256, 19), (260, 16, 32, 3),
                                     (41, 7, 17, 130)])
def test_tanh_kernels_ragged_and_strided(P, T, K, N):
    """Row counts P·T off every tile, widths off 4 and off the tiles, the
    tangents at other strides (a transposed view, a tangent broadcast over
    T at stride 0) and K2 with either tangent missing (a zero tangent)."""
    _card()
    from pyneuralempc_tpu_torch.ops.cuda import tanh_dense as td
    c = _tanh_case(P, T, K, N, seed=P)
    y, g, W = c["y"], c["g"], c["W"]
    hd_t = c["hd"].transpose(0, 1).contiguous().transpose(0, 1)
    hd_b = c["hd"][:, :1].expand(P, T, K)
    for hd in (c["hd"], hd_t, hd_b):
        _tanh_close(td.tangent_fwd_cuda(hd, y, W),
                    td.tangent_fwd_plain(*_f64(hd, y, W)))
    gd_t = c["gd"].transpose(0, 1).contiguous().transpose(0, 1)
    for gd, yd in ((c["gd"], c["yd"]), (gd_t, c["yd"]), (None, c["yd"]),
                   (c["gd"], None), (c["gd"][:, :1].expand(P, T, N), gd_t)):
        _tanh_close(td.tangent_vjp_cuda(gd, yd, g, y, W),
                    td.tangent_vjp_plain(*_f64(gd, yd, g, y, W)))
    torch.cuda.synchronize()


def test_quadrotor_mlp_goes_through_the_tanh_kernels(monkeypatch):
    """A 2x256 tanh MLP over the quadrotor's (sin, cos) features, RK4, H=20,
    its layers taken as TanhLayers at this size too: on the card every tanh
    layer's tangent passes in the stage blocks are the kernels (K1 and K2
    launch, FUSED_LAYERS counts, no plain tangent pass), and the plans
    agree with the CPU port's to 1e-4 in u."""
    _card()
    from pyneuralempc_tpu_torch.examples.quadrotor import (
        make_quadrotor_mpc, quad_features, quad_x0s)
    from pyneuralempc_tpu_torch.models import mlp
    from pyneuralempc_tpu_torch.ops.cuda import tanh_dense as td
    monkeypatch.setattr(mlp, "FUSED_MIN_ELEMENTS", 0)
    x0s = quad_x0s(np.random.default_rng(0), 16)
    prm = nempc.mlp_init(torch.Generator().manual_seed(0), (19, 256, 256, 12),
                         device="cpu")
    acts = ("tanh", "tanh", "linear")

    def surrogate(x, u, p, tvp, params):
        z = torch.cat([quad_features(x), u - 1.2], dim=-1)
        return 0.1 * nempc.mlp_apply(params, z, acts) + torch.cat(
            [x[:, 3:6], torch.zeros_like(x[:, 3:])], dim=-1)

    model = nempc.DynamicsModel(fn=surrogate, dims=nempc.Dims(12, 4),
                                name="quad_rand_mlp")
    res = {}
    for dev in ("cuda", "cpu"):
        mpc = make_quadrotor_mpc(dev, H=20, model=model)
        before = (td.K1_LAUNCHES, td.K2_LAUNCHES, td.PLAIN_CALLS,
                  mlp.FUSED_LAYERS)
        _, res[dev] = mpc.next_batch(
            torch.tensor(x0s, device=dev),
            params=[{k: v.to(dev) for k, v in layer.items()}
                    for layer in prm])
        if dev == "cuda":
            assert td.K1_LAUNCHES > before[0] and td.K2_LAUNCHES > before[1]
            assert td.PLAIN_CALLS == before[2]
            assert mlp.FUSED_LAYERS > before[3]
    assert torch.equal(res["cuda"].converged.cpu(), res["cpu"].converged)
    assert bool(res["cpu"].converged.any())
    assert float((res["cuda"].u.cpu() - res["cpu"].u).abs().max()) <= 1e-4
