"""The LSTM, stacked-LSTM and bf16 fleets of chip_smoke.py's phases 4s-4u
at a small size: the port against the JAX package on the CPU.

* The single LSTM fleet (``lstm_fleet_model("lstm")``, lifted (18, 1))
  and the stacked one (``"stacked_lstm"``, lifted (34, 1)), B=8, H=10,
  from one set of seeded weights carried across by ``params_from_numpy``:
  a cold ``next_batch`` and one warm re-plan from the plan's first lifted
  state, equal converged masks and iterations, |Δu|∞ ≤ 1e-4.  The
  stacked fleet's plans are asked for as on the card, so its sweeps take
  the fallback route (``"plain_fallback"``: nx=34 > 32): every sweep
  counted in ``FALLBACK_CALLS``, one warning for the run.
* The LV MLP fleet with ``compute_dtype=bfloat16`` matmuls (B=8, bench.py's
  2x32 surrogate trained by the JAX package), cold and one warm re-plan:
  the JAX package's bf16 fleet's converged masks, and on the members
  converged its plans within BF16_DU and the port's own float32 plans
  within 2e-2.  bf16 rounds the model's values but not its derivatives,
  so the KKT error floors near 1e-3 and most members stop at max_iter
  above the bench tol, in both packages (2 of these 8 converge).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.models.train import fit_surrogate, sample_transitions
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk

from _torch_lstm import lstm_fleets, starts
from _torch_lv import BENCH_CFG, BOX, REG, jax_params, lv_true_jax, x0_batch
import _torch_threads  # noqa: F401  (one torch thread)

DU_TOL = 1e-4
# bf16 rounds each matmul's inputs to 8 bits of mantissa: the two packages'
# bf16 surrogates part by up to ~4e-3 on the fleet's states (XLA's CPU dot
# and PyTorch's round differently), and the plans follow
BF16_DU = 2e-2
BF16_VS_F32 = 2e-2     # tests/test_torch_multi_member.py's model-level bound


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


@pytest.mark.parametrize("kind", ["lstm", "stacked_lstm"])
def test_lstm_fleet_next_batch_matches_jax(kind, monkeypatch):
    H, B = 10, 8
    jm, jp, tm, tp, tb = lstm_fleets(kind, H)
    nx = tb.model.dims.x
    assert nx == {"lstm": 18, "stacked_lstm": 34}[kind]
    if kind == "stacked_lstm":
        assert rk.kernel_plan(H, nx, 1, "cuda")["path"] == "plain_fallback"
        real = rk.kernel_plan
        monkeypatch.setattr(rk, "kernel_plan", lambda H, nx, nu, device,
                            R=1, r=0: real(H, nx, nu, "cuda", R=R, r=r))
        monkeypatch.setattr(rk, "_WARNED", set())
    else:
        assert rk.kernel_plan(H, nx, 1, "cuda")["path"] == "cuda_streamed"
    z0 = starts(tb, B)
    n0 = rk.FALLBACK_CALLS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jc, jres = jm.next_batch(jnp.asarray(z0), params=jp)
        tc, tres = tm.next_batch(torch.as_tensor(z0), params=tp)
        for _ in range(2):
            _compare(jres, tres)
            z1 = np.array(jres.x[:, 0], np.float32)
            jc, jres = jm.next_batch(jnp.asarray(z1), params=jp, carry=jc)
            tc, tres = tm.next_batch(torch.as_tensor(z1), params=tp,
                                     carry=tc)
    assert int(tres.converged.sum()) >= B // 2
    ours = [w for w in caught
            if "outside every CUDA kernel's envelope" in str(w.message)]
    if kind == "stacked_lstm":
        assert rk.FALLBACK_CALLS > n0 + 2 * 10
        assert len(ours) == 1 and f"nx={nx}, nu=1" in str(ours[0].message)
    else:
        assert rk.FALLBACK_CALLS == n0 and not ours


def _lv_fleets(dtype_t, dtype_j):
    jm = J.NMPC(J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                                   compute_dtype=dtype_j),
                lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u),
                [J.DomainConstraint(**BOX)], H=20, DT=0.1, integrator="rk4",
                config=J.IPConfig(**BENCH_CFG))
    tm = T.NMPC(T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                                   compute_dtype=dtype_t),
                lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u),
                [T.DomainConstraint(**BOX)], H=20, DT=0.1, integrator="rk4",
                config=T.IPConfig(**BENCH_CFG), device="cpu")
    return jm, tm


def test_bf16_lv_fleet_matches_jax():
    """bench.py's surrogate trained by the JAX package (as
    tests/test_torch_controller.py's), its float32 weights in both
    packages' bf16 fleets."""
    B = 8
    model = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    X, U, Y = sample_transitions(lv_true_jax, jax.random.PRNGKey(0), 8192,
                                 2, 1, x_range=(-1.0, 1.2),
                                 u_range=(0.0, 1.2))
    params, _ = fit_surrogate(model, X, U, Y, steps=1500, lr=2e-3,
                              batch=1024)
    weights = [{k: np.asarray(v) for k, v in layer.items()}
               for layer in params]
    jp = jax_params(weights)
    tp = T.mlp_params_from_numpy(weights, device="cpu")
    jm, tm = _lv_fleets(torch.bfloat16, jnp.bfloat16)
    _, tm32 = _lv_fleets(torch.float32, jnp.float32)
    xs = x0_batch(B)
    jc = tc = tc32 = None
    for _ in range(2):
        jc, jres = jm.next_batch(jnp.asarray(xs), params=jp, carry=jc)
        tc, tres = tm.next_batch(torch.as_tensor(xs), params=tp, carry=tc)
        tc32, t32 = tm32.next_batch(torch.as_tensor(xs), params=tp,
                                    carry=tc32)
        np.testing.assert_array_equal(tres.converged.numpy(),
                                      np.asarray(jres.converged))
        assert bool(torch.isfinite(tres.u).all())
        both = (tres.converged & t32.converged).numpy()
        assert both.sum() >= 1
        du_jax = np.abs(tres.u.numpy() - np.asarray(jres.u))[both].max()
        du_f32 = (tres.u - t32.u).abs().numpy()[both].max()
        assert du_jax <= BF16_DU and du_f32 <= BF16_VS_F32
        xs = np.array(jres.x[:, 0], np.float32)
