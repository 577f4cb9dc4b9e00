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
    # past R = 65 or r = nu the card runs the plain version; H=0 has no
    # plan on the card
    for shape, path in (((0, 2, 1, 2, 0), "unsupported"),
                        ((20, 2, 1, 66, 0), "plain_fallback"),
                        ((20, 2, 1, 2, 2), "plain_fallback")):
        H, nx, nu, R, r = shape
        assert rk.kernel_plan(H, nx, nu, "cuda", R=R, r=r)["path"] == path
    assert rk.kernel_plan(20, 2, 1, "cuda", R=1, r=0)["path"] == "cuda_fused"


def test_instances_match_the_c_entry_point():
    """The staged C entry point's switch instantiates exactly
    _STAGED_INSTANCES: _GENERAL_INSTANCES and the plain sweep's (2, 1, 1, 0)
    (any other shape returns cudaErrorInvalidValue there)."""
    cases = re.findall(r"^\s*RICCATI_GENERAL_FUSED_CASE\((\d+), (\d+), "
                       r"(\d+), (\d+)\)\s*$", SOURCE.read_text(), re.M)
    assert {tuple(map(int, t)) for t in cases} == rk._STAGED_INSTANCES
    assert len(cases) == len(rk._STAGED_INSTANCES)
    assert rk._STAGED_INSTANCES == rk._GENERAL_INSTANCES | {(2, 1, 1, 0)}


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


# ---- the staged kernel's block (csrc/riccati_general_fused.cu
#      staged_layout / staged_problems) and the direct kernel ----

@pytest.mark.parametrize("H,R,r,P,nbytes", [
    # (2, 1, 2, 0) at H=20, 32 problems: 16 B of mbarrier, then the slabs
    # A 2560 floats, B 1280, c 2560, δ 32, G 5760, M 5760, mx 2560, mu 1280
    # (each a multiple of 4 floats), the gains 32·20·14 = 8960:
    # 4 + 30,752 = 30,756 floats = 123,024 B
    (20, 2, 0, 32, 123_024),
    # at H=50 a problem takes 50·48 + 1 = 2401 floats; 24 problems take
    # 4 + 24·2401 = 57,628 floats = 230,512 B, 25 would take 240,116 B
    # > 232,448
    (50, 2, 0, 24, 230_512),
    # (2, 1, 3, 1) at H=20: 47 input floats a stage, 22 gains, δ and δ_c:
    # 4 + 32·(20·69 + 2) = 44,228 floats = 176,912 B
    (20, 3, 1, 32, 176_912),
    # one problem at H=1200: 4 + 1200·48 + 1 floats and 3 of padding (the
    # δ slab's end rounded up) = 57,608 floats = 230,432 B
    (1200, 2, 0, 1, 230_432),
    # at H=1300 one problem alone needs 1300·48 floats > 232,448 / 4
    (1300, 2, 0, 0, None),
])
def test_staged_block_problems_hand_worked(H, R, r, P, nbytes):
    assert rk.staged_block_problems(H, 2, 1, R, r) == P
    assert rg.staged_block_problems is rk.staged_block_problems
    if P:
        assert rk.staged_smem_bytes(P, H, 2, 1, R, r) == nbytes
        assert rk.staged_smem_bytes(P, H, 2, 1, R, r) <= rk.STAGED_MAX_SMEM
        if P < rk.STAGED_MAX_PROBLEMS:
            assert (rk.staged_smem_bytes(P + 1, H, 2, 1, R, r)
                    > rk.STAGED_MAX_SMEM)
    else:
        assert rk.staged_smem_bytes(1, H, 2, 1, R, r) > rk.STAGED_MAX_SMEM


def test_staged_block_problems_fall_with_the_horizon():
    """Every instance: 32 problems a block up to a horizon, fewer beyond,
    never more as H grows, and 0 (the direct kernel) past ~840-1210
    stages."""
    for _, _, R, r in rk._GENERAL_INSTANCES:
        Ps = [rk.staged_block_problems(H, 2, 1, R, r)
              for H in range(1, 1400, 7)]
        assert Ps[0] == 32 and Ps[-1] == 0
        assert all(a >= b for a, b in zip(Ps, Ps[1:]))
        assert rk.staged_block_problems(20, 2, 1, R, r) == 32
        assert rk.staged_block_problems(10 ** 6, 2, 1, R, r) == 0


def test_kernel_plan_names_staged_or_direct():
    """The fused general plan names its kernel: the staged one while a
    block holds at least one problem, the direct one beyond."""
    for _, _, R, r in rk._GENERAL_INSTANCES:
        for H in (1, 20, 50, 500, 5000):
            p = rk.kernel_plan(H, 2, 1, "cuda", R=R, r=r)
            P = rk.staged_block_problems(H, 2, 1, R, r)
            assert p["path"] == "cuda_fused_general"
            assert p["block_problems"] == P
            assert p["kernel"] == (rk.STAGED_KERNEL if P else
                                   rk.DIRECT_KERNEL)
    p = rk.kernel_plan(20, 2, 1, "cuda", R=2, r=0)
    assert p["kernel"] == "riccati_general_fused_staged_kernel"
    assert p["block_problems"] == 32 and "32 problems a block" in p["reason"]
    p = rk.kernel_plan(1300, 2, 1, "cuda", R=2, r=0)
    assert p["kernel"] == "riccati_general_fused_kernel"
    assert p["block_problems"] == 0


def test_direct_entry_lists_the_instances():
    """The direct entry's switch instantiates exactly _GENERAL_INSTANCES,
    as the staged entry's does."""
    text = SOURCE.read_text()
    cases = re.findall(r"^\s*RICCATI_GENERAL_FUSED_DIRECT_CASE\((\d+), "
                       r"(\d+), (\d+), (\d+)\)\s*$", text, re.M)
    assert {tuple(map(int, t)) for t in cases} == rk._GENERAL_INSTANCES
    assert len(cases) == len(rk._GENERAL_INSTANCES)
    assert 'extern "C" int riccati_general_fused_f32(' in text
    assert 'extern "C" int riccati_general_fused_direct_f32(' in text


def test_kernel_names_and_constants_in_the_source():
    """chip_smoke.py matches profiler events by kernel name: both kernels
    are defined under their names, neither name holds the other; the
    source's block limits are the wrapper's; the bulk-copy primitives come
    from their own header."""
    text = SOURCE.read_text()
    for name in (rk.STAGED_KERNEL, rk.DIRECT_KERNEL):
        assert re.search(rf"^{name}\(", text, re.M), name
    assert rk.STAGED_KERNEL not in rk.DIRECT_KERNEL
    assert rk.DIRECT_KERNEL not in rk.STAGED_KERNEL
    assert f"constexpr int kMaxSmem = {rk.STAGED_MAX_SMEM};" in text
    assert f"constexpr int kThreads = {rk.STAGED_MAX_PROBLEMS};" in text
    assert '#include "bulk_copy.cuh"' in text
    header = (SOURCE.parent / "bulk_copy.cuh").read_text()
    for fn in ("mbar_init", "mbar_arrive_expect_tx", "mbar_wait",
               "bulk_copy_g2s", "copy4_async", "copy4_wait_all"):
        assert re.search(rf"void {fn}\(", header), fn


def test_aligned_mask():
    """Bit i of the copy-width mask is set where input i starts on a
    16-byte boundary; a contiguous view 4 bytes further is not."""
    args = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=2, nu=1, R=2, r=1)]
    assert all(a.data_ptr() % 16 == 0 for a in args)
    assert rg._aligned_mask(args) == (1 << 13) - 1
    buf = torch.empty(args[2].numel() + 1)
    moved = buf[1:].view(args[2].shape)
    assert moved.is_contiguous() and moved.data_ptr() % 16 == 4
    assert rg._aligned_mask(args[:2] + [moved] + args[3:]) == (
        (1 << 13) - 1 - (1 << 2))


def test_direct_wrapper_refuses_cpu_tensors():
    """The direct kernel's wrapper, like the solver's, refuses CPU tensors
    and shapes it does not instantiate, and a refused call moves no
    counter."""
    args = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=2, nu=1, R=2, r=0)]
    counts = (rg.FUSED_LAUNCHES, rg.FUSED_STAGED_LAUNCHES,
              rg.FUSED_DIRECT_LAUNCHES, rk.PLAIN_CALLS)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_sweep_general_fused_direct_cuda(*args)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.riccati_sweep_general_fused_cuda(*args, return_gains=True)
    with pytest.raises(ValueError, match="CUDA device"):
        rg.fused_phase_stamps(*args)
    long = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=1, H=1300, nx=2, nu=1, R=2, r=0)]
    with pytest.raises(ValueError, match="direct kernel"):
        rg.fused_phase_stamps(*long)
    other = [torch.as_tensor(a) for a in general_sweep_case(
        "delta0", B=3, H=2, nx=4, nu=2, R=2, r=1)]
    with pytest.raises(NotImplementedError, match="instantiates"):
        rg.riccati_sweep_general_fused_direct_cuda(*other)
    assert (rg.FUSED_LAUNCHES, rg.FUSED_STAGED_LAUNCHES,
            rg.FUSED_DIRECT_LAUNCHES, rk.PLAIN_CALLS) == counts
