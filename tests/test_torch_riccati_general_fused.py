"""The fused general sweep (``csrc/riccati_general_fused.cu``) on the CPU:
its plain PyTorch version at the LV stage (nx, nu) = (2, 1) against the JAX
package's fused general Pallas kernel, run in interpret mode as
tests/test_pallas_general.py runs it (at these dims
``_riccati_general_pallas_call`` takes its resident branch, :890-970);
the dispatch plan and the instance list the kernel's C entry point
switches on; the byte and operation counts behind its bound; the wrapper's
refusals.  The kernel itself is held against the plain version on a card
by tests/test_torch_cuda.py and chip_smoke.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyneuralempc_tpu.ops.pallas import riccati_kernel as prk
from pyneuralempc_tpu_torch.ops.cuda import riccati_general as rg
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import general_sweep_case

import _torch_threads  # noqa: F401  (one torch thread)

ATOL = 2e-5     # tests/test_pallas_general.py's own tolerance (f32)
SOURCE = (Path(rk.__file__).resolve().parents[2] / "csrc"
          / rk.GENERAL_FUSED_SOURCE)


def _rhs_major(a):
    """Port layout (B, H, R, ·) -> the JAX functions' (B, R, H, ·)."""
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("kind", ["delta_per_problem", "negative_curvature"])
@pytest.mark.parametrize("R,r", [(2, 0), (2, 1), (3, 0)])
def test_plain_matches_fused_pallas_kernel(kind, R, r):
    H = 4
    assert prk._pick_chunk_general(H, 2, 1, R, r) == H
    assert prk._fused_fits_general(H, 2, 1, R, r)     # the resident branch
    args = general_sweep_case(kind, B=3, H=H, nx=2, nu=1, R=R, r=r, seed=R)
    A, Bm, G, M, mx, mu_, c, delta, dc, E, F, h, Jx = args
    eq = (E, F, _rhs_major(h), Jx) if r else (None,) * 4
    pal = prk.riccati_sweep_general_pallas(
        *(jnp.asarray(a) for a in (A, Bm, G, M, _rhs_major(mx),
                                   _rhs_major(mu_), _rhs_major(c), delta,
                                   dc)),
        *(None if a is None else jnp.asarray(a) for a in eq),
        interpret=True)
    pal = [np.swapaxes(np.asarray(o), 1, 2) for o in pal[:4]] + [
        np.asarray(pal[4])]
    rk_out = [o.numpy() for o in rg.riccati_sweep_general_plain(
        *(torch.as_tensor(a) for a in args))]
    want = ([True, False, True] if kind == "negative_curvature"
            else [True] * 3)
    assert rk_out[4].tolist() == want
    np.testing.assert_array_equal(rk_out[4], pal[4])
    ok = rk_out[4]
    for o, p in zip(rk_out[:4], pal[:4]):
        assert o.shape == p.shape
        np.testing.assert_allclose(o[ok], p[ok], atol=ATOL, rtol=0)


def test_kernel_plan_fused_general_is_pinned():
    """Instantiated shapes take the fused general kernel at any horizon,
    every other general shape the streamed pair, shapes past the pair's
    range nothing; (R, r) = (1, 0) stays the plain sweep's plan."""
    assert rk._GENERAL_INSTANCES == {(2, 1, 1, 1), (2, 1, 2, 0),
                                     (2, 1, 2, 1), (2, 1, 3, 0),
                                     (2, 1, 3, 1)}
    for nx, nu, R, r in rk._GENERAL_INSTANCES:
        for H in (1, 20, 500):
            p = rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)
            assert p["path"] == "cuda_fused_general"
            assert rk.GENERAL_FUSED_SOURCE in p["reason"]
        assert rk.kernel_plan(20, nx, nu, "cpu", R=R, r=r)["path"] == "plain"
    for shape in ((20, 2, 1, 4, 0), (20, 2, 1, 65, 1), (20, 2, 2, 2, 1),
                  (20, 3, 1, 2, 0), (50, 12, 4, 2, 1)):
        H, nx, nu, R, r = shape
        assert (rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)["path"]
                == "cuda_streamed_general")
    for shape in ((0, 2, 1, 2, 0), (20, 2, 1, 66, 0), (20, 2, 1, 2, 2)):
        H, nx, nu, R, r = shape
        assert (rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)["path"]
                == "unsupported")
    assert rk.kernel_plan(20, 2, 1, "cuda", R=1, r=0)["path"] == "cuda_fused"


def test_instances_match_the_c_entry_point():
    """The C entry point's switch instantiates exactly _GENERAL_INSTANCES
    (any other shape returns cudaErrorInvalidValue there)."""
    cases = re.findall(r"^\s*RICCATI_GENERAL_FUSED_CASE\((\d+), (\d+), "
                       r"(\d+), (\d+)\)\s*$", SOURCE.read_text(), re.M)
    assert {tuple(map(int, t)) for t in cases} == rk._GENERAL_INSTANCES
    assert len(cases) == len(rk._GENERAL_INSTANCES)


def test_bound_counts():
    """At the budgeted LV fleet (B=4096, H=20, nx=2, nu=1): with (R, r) =
    (2, 0) the kernel reads 28 floats a stage (A 4, B 2, the G and M
    triangles 6 each, mx 4, mu 2, c 4) and δ a problem (δ_c is not read
    without equality rows), writes 10 a stage (dX 4, dU 2, dLam 4) and an
    ok byte: 4·4096·(20·38 + 1) + 4096 = 12,472,320 B, 3.72 µs at 3.35
    TB/s.  With (2, 1) it reads 35 (h 2, E 1, F 2 and Jx 2 more) and δ,
    δ_c, and writes 12 (dNu 2 more): 4·4096·(20·47 + 2) + 4096 =
    15,437,824 B.  The gains scratch never counts."""
    assert rg.general_fused_bytes(1, 1, 2, 1, 2, 0) == 4 * (28 + 10 + 1) + 1
    assert rg.general_fused_bytes(1, 1, 2, 1, 2, 1) == 4 * (35 + 12 + 2) + 1
    assert rg.general_fused_bytes(4096, 20, 2, 1, 2, 0) == 12_472_320
    assert rg.general_fused_bytes(4096, 20, 2, 1, 2, 1) == 15_437_824
    assert rg.general_fused_flops(1, 1, 2, 1, 2, 0) == 245
    assert rg.general_fused_flops(4096, 20, 2, 1, 2, 0) == 20_070_400
    # the backward and forward kernels' operations, bytes without the gains
    for dims in ((4096, 20, 2, 1, 2, 0), (7, 3, 2, 1, 3, 1)):
        assert rg.general_fused_flops(*dims) == (
            rg.general_backward_flops(*dims)
            + rg.general_forward_flops(*dims))
    # (R, r) = (1, 0) gives the fused plain sweep's counts
    assert rg.general_fused_bytes(4096, 20, 2, 1, 1, 0) == rk.sweep_bytes(
        4096, 20, 2, 1) == 9_195_520


def test_wrapper_refusals_and_dispatch_on_cpu():
    """CPU tensors: the dispatch takes the plain version; the kernel's
    wrapper refuses them, and refuses shapes it does not instantiate,
    before launching anything."""
    args = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=2, nu=1, R=2, r=0)]
    n0, p0 = rg.FUSED_LAUNCHES, rk.PLAIN_CALLS
    out = rg.riccati_sweep_general(*args)
    assert rk.PLAIN_CALLS == p0 + 1
    for a, b in zip(out, rg.riccati_sweep_general_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_sweep_general_fused_cuda(*args)
    other = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=4, nu=2, R=2, r=1)]
    with pytest.raises(NotImplementedError, match="instantiates"):
        rg.riccati_sweep_general_fused_cuda(*other)
    assert rg.FUSED_LAUNCHES == n0
