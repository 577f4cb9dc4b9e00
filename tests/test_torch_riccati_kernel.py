"""The port's Riccati sweep: its plain PyTorch version against the JAX
package's scan reference (``jax.vmap(riccati_sweep_ref)``) and against the
Pallas kernel run as its own tests run it (interpret mode), on the data and
cases of tests/test_pallas_kernel.py; and the dispatch plan.  The CUDA
kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyneuralempc_tpu.ops.pallas.riccati_kernel import riccati_sweep_pallas
from pyneuralempc_tpu.solve.riccati import riccati_sweep_ref
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk

from _torch_lv import sweep_data

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
    assert rk.kernel_plan(20, 2, 1, "cuda")["path"] == "cuda"
    assert rk.kernel_plan(50, 2, 1, torch.device("cuda:0"))["path"] == "cuda"
    for shape in ((20, 2, 1), (50, 12, 4), (3, 7, 5)):
        assert rk.kernel_plan(*shape, "cpu")["path"] == "plain"
    p = rk.kernel_plan(50, 12, 4, "cuda")
    assert p["path"] == "unsupported"
    assert "nx=12, nu=4" in p["reason"] and "ROADMAP" in p["reason"]


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
    """Bytes: 29 input and 5 output floats a stage at LV size, plus δ and
    the ok byte per problem."""
    assert rk.sweep_bytes(1, 1, 2, 1) == 4 * (29 + 1 + 5) + 1
    assert rk.sweep_bytes(4096, 20, 2, 1) == 4096 * (4 * (20 * 34 + 1) + 1)
    assert rk.sweep_flops(4096, 20, 2, 1) == 20 * rk.sweep_flops(4096, 1, 2,
                                                                  1)
    assert rk.gain_width(2, 1) == 2 + 1 + 4 + 2 + 2

