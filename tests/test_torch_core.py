"""Problem IR, transcription and structure probe: the port against the JAX
package on the LV-MLP problem (H=6), same numpy weights and points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu_torch.core.problem import Dims

from _torch_lv import glorot_params, jax_mpc, jax_params, torch_mpc

RTOL, ATOL = 1e-5, 1e-6
H = 6


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_transcription_matches_jax():
    np_params = glorot_params(0)
    jm, tm = jax_mpc(H), torch_mpc(H)
    jn, tn = jm.nlp, tm.nlp
    assert (jn.n, jn.m) == (tn.n, tn.m) == (H * 3, H * 2)
    np.testing.assert_array_equal(np.asarray(jn.lower), _np(tn.lower))
    np.testing.assert_array_equal(np.asarray(jn.upper), _np(tn.upper))

    rng = np.random.default_rng(1)
    x0 = np.asarray([0.4, -0.6], np.float32)
    jrt = J.runtime(jnp.asarray(x0), params=jax_params(np_params))
    trt = T.runtime(torch.as_tensor(x0),
                    params=T.mlp_params_from_numpy(np_params, device="cpu"))
    for _ in range(3):
        w = rng.uniform(-0.9, 0.9, jn.n).astype(np.float32)
        jw, tw = jnp.asarray(w), torch.as_tensor(w)
        np.testing.assert_allclose(_np(tn.objective(tw, trt)),
                                   np.asarray(jn.objective(jw, jrt)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(tn.constraints(tw, trt)),
                                   np.asarray(jn.constraints(jw, jrt)),
                                   rtol=RTOL, atol=ATOL)
        lam = rng.normal(size=jn.m).astype(np.float32)
        np.testing.assert_allclose(
            _np(tn.lagrangian(tw, torch.as_tensor(lam), trt)),
            np.asarray(jn.lagrangian(jw, jnp.asarray(lam), jrt)),
            rtol=RTOL, atol=ATOL)
        jX, jU, js = jn.unpack(jw)
        tX, tU, ts = tn.unpack(tw)
        for a, b in ((jX, tX), (jU, tU), (js, ts)):
            np.testing.assert_array_equal(np.asarray(a), _np(b))
        np.testing.assert_array_equal(_np(tn.pack(tX, tU, ts)), w)
        np.testing.assert_array_equal(
            _np(tn.init_slacks(tX, tU, trt)),
            np.asarray(jn.init_slacks(jX, jU, jrt)))
        np.testing.assert_array_equal(_np(tn.shift_slacks(ts)),
                                      np.asarray(jn.shift_slacks(js)))


def test_pack_unpack_batched():
    tn = torch_mpc(H).nlp
    w = torch.arange(2 * tn.n, dtype=torch.float32).reshape(2, tn.n)
    X, U, s = tn.unpack(w)
    assert X.shape == (2, H, 2) and U.shape == (2, H, 1) and s.shape == (2, 0)
    assert torch.equal(tn.pack(X, U, s), w)
    assert torch.equal(tn.unpack(w[1])[0], X[1])


@pytest.mark.parametrize("case", ["separable", "coupled", "terminal"])
def test_probe_verdict_matches_jax(case):
    costs = {
        "separable": (lambda x, u: 1.1 * jnp.sum(u) + 1e-4 * jnp.sum(u * u),
                      lambda x, u: 1.1 * torch.sum(u)
                      + 1e-4 * torch.sum(u * u)),
        "coupled": (lambda x, u: jnp.sum(u) + x[0, 0] * x[-1, 0],
                    lambda x, u: torch.sum(u) + x[0, 0] * x[-1, 0]),
        "terminal": (lambda x, u: jnp.sum(u ** 2) + 10.0 * jnp.sum(x[-1] ** 2),
                     lambda x, u: torch.sum(u ** 2)
                     + 10.0 * torch.sum(x[-1] ** 2)),
    }
    jcost, tcost = costs[case]
    want = {"separable": True, "coupled": False, "terminal": True}[case]
    # H=4 as in tests/test_riccati.py: the probe samples two stages, and at
    # H=4 they include an end of the coupled pair (0, H-1)
    got_j = J.probe_stage_separable(jcost, J.Dims(2, 1), 4)
    got_t = T.probe_stage_separable(tcost, Dims(2, 1), 4)
    assert got_j == got_t == want


def test_stage_cost_matches_jax():
    jsc = J.StageCost(stage=lambda x, u: jnp.sum(u) + jnp.sum(x ** 2),
                      terminal=lambda x: 10.0 * jnp.sum(x))
    tsc = T.StageCost(stage=lambda x, u: torch.sum(u) + torch.sum(x ** 2),
                      terminal=lambda x: 10.0 * torch.sum(x))
    X = np.arange(6.0, dtype=np.float32).reshape(3, 2)
    U = np.ones((3, 1), np.float32)
    np.testing.assert_allclose(
        float(tsc(torch.as_tensor(X), torch.as_tensor(U))),
        float(jsc(jnp.asarray(X), jnp.asarray(U))), rtol=1e-6)


def test_box_and_spec_validation():
    with pytest.raises(ValueError):
        T.DomainConstraint(states_constraint=[[1.0, 0.0]],
                           control_constraint=[[0.0, 1.0]])
    with pytest.raises(ValueError):
        T.DomainConstraint(states_constraint=[], control_constraint=[[0, 1]])
    model = T.torch_dynamics(lambda x, u: x, 1, 1)
    with pytest.raises(ValueError, match="integrator"):
        T.MPCSpec(model=model, integrator="rk5", objective=None,
                  box=T.Box.unbounded(1, 1), H=3, DT=0.1)
    lb, ub = T.DomainConstraint(states_constraint=[[0, 1], [2, 3]],
                                control_constraint=[[4, 5]]).tile(
                                    2, device="cpu")
    jlb, jub = J.DomainConstraint(states_constraint=[[0, 1], [2, 3]],
                                  control_constraint=[[4, 5]]).tile(2)
    np.testing.assert_array_equal(lb.numpy(), np.asarray(jlb))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(jub))


def test_runtime_keys():
    rt = T.runtime([0.1, 0.2])
    assert set(rt) == set(J.runtime(jnp.zeros(2)))
    assert rt["p"] is None and rt["tvp"] is None and rt["params"] is None
