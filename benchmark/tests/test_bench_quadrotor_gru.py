"""The quadrotor GRU cell (``quadrotor_gru.track_b4096``): its plain
reference against the package under test, and ``correct`` against its
faults, at a tiny size on the CPU; its control on the card.

* ``reference/quadrotor_gru.py``'s lifted step, in float64 and float32,
  equals the port's ``gru_dynamics`` with the same feature map, scales and
  weights; its hidden-state update is the lifted step's hidden block; its
  features are ``reference/quadrotor.py``'s over any leading axes; its
  operations a stage are 3,744 at 16 units.
* The cold solve starts from the held plan: x0's physical state and
  hover thrust at every stage, the hidden state the reference's hidden
  update along them.
* A sound run reads correct; a perturbed defect (every plan's states
  moved by 2e-3 where they are produced) and a wrong hidden update (the
  program's GRU adding 1e-2 to every new hidden state) read not correct.
* On the card (marked ``cuda``, skipped without one): at the cell's
  widths and horizon, 64 members, the program reads correct and its bf16
  control not.
"""

import time

import pytest
import torch

from benchmark.harness import driver, env
from benchmark.harness.layout import Layout
from benchmark.reference import quadrotor as quad
from benchmark.reference import quadrotor_gru as ref

import pyneuralempc_tpu_torch as port

from conftest import ROOT

CELL = "quadrotor_gru.track_b4096"
TINY = {"config": {"H": 6, "fit": {"data": {"n": 64, "T": 20}, "steps": 40,
                                   "batch": 32}},
        "traffic": {"batch": 4, "lead_in": 1, "check_per_replan": 4,
                    "trace_replans": 1}}
SMALL = {"traffic": {"batch": 64, "lead_in": 2, "check_per_replan": 64}}


def _fit(seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, lo=-0.5, hi=0.5):
        return lo + (hi - lo) * torch.rand(shape, generator=g)
    n_in = ref.N_FEATURES + ref.NU
    w = {"wz": r(n_in + 16, 16), "wr": r(n_in + 16, 16),
         "wh": r(n_in + 16, 16), "bz": r(16), "br": r(16), "bh": r(16),
         "wo": r(16, 12), "bo": r(12)}
    return {"w": w, "in_mu": r(n_in), "in_sd": r(n_in, lo=0.5, hi=2.0),
            "out_mu": r(12, lo=-0.01, hi=0.01),
            "out_sd": r(12, lo=0.01, hi=0.2)}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)])
def test_lifted_step_equals_the_ports(dtype, tol):
    fit = ref.fit_to(_fit(), dtype, "cpu")
    gd = port.gru_dynamics(12, 4, 16, feature_map=ref.features,
                           in_mu=fit["in_mu"], in_sd=fit["in_sd"],
                           out_mu=fit["out_mu"], out_sd=fit["out_sd"])
    g = torch.Generator().manual_seed(1)
    z = (torch.rand((32, 28), generator=g) * 2.0 - 1.0).to(dtype)
    u = (torch.rand((32, 4), generator=g) * 3.0).to(dtype)
    want = gd.model(z, u, None, None, fit["w"])
    got = ref.lifted_step(fit, z, u)
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(ref.hidden_update(fit, z[:, 12:], z[:, :12], u),
                       got[:, 12:])
    x = z[:, :12].reshape(4, 8, 12)
    assert torch.equal(ref.features(x).reshape(32, 15),
                       quad.features(z[:, :12]))
    assert ref.stage_flops(16) == 3 * 2 * (19 + 16) * 16 + 2 * 16 * 12 \
        == 3744


def test_held_plan():
    """The cold plan (the builder's ``HeldStart``): x0's physical state and
    the hover thrusts at every stage, the hidden state the reference's
    hidden update along them from x0's; the cold solve starts there."""
    seen = {}

    def wrap(cell):
        held = cell.mpc
        inner = held.mpc
        real = inner.next_batch

        def spy(x0s, carry=None, init_x=None, init_u=None, **kw):
            if carry is None:
                seen.update(x0=x0s, X=init_x, U=init_u, w=kw["params"])
            else:
                assert init_x is None and init_u is None
            return real(x0s, carry=carry, init_x=init_x, init_u=init_u, **kw)
        inner.next_batch = spy
    res = _run(wrap)
    assert res["correct"], res["checks"]
    x0, X, U = seen["x0"], seen["X"], seen["U"]
    assert torch.equal(U, torch.tensor([1.22625] * 4).expand(U.shape))
    assert torch.equal(X[..., :12],
                       x0[:, None, :12].expand(X.shape[:2] + (12,)))
    lay = Layout(ROOT)
    _, cfg, builder = lay.config("quadrotor_gru")
    cfg = driver._merge(cfg, TINY["config"])
    fit = ref.fit_to(builder.fitted(cfg, env.cache_dir(lay.root), "cpu"),
                     torch.float32, "cpu")
    h = x0[:, 12:]
    for t in range(X.shape[1]):
        h = ref.hidden_update(fit, h, x0[:, :12], U[:, t])
        assert float((X[:, t, 12:] - h).abs().max()) <= 1e-6


def _run(wrap=None):
    return driver.run(Layout(ROOT), CELL, 2 ** 31 + 7, 0.5, False,
                      t_start=time.perf_counter(), device="cpu",
                      overrides=TINY, wrap=wrap)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["compared"]["value"] >= 1


class _Moved:
    """The controller with every warm re-plan's states moved by ``delta``
    where they are produced (the cold solve in set-up stays sound)."""

    def __init__(self, mpc, delta):
        self.mpc, self.delta = mpc, delta

    def next_batch(self, x0s, p=None, tvp=None, params=None, carry=None):
        out, res = self.mpc.next_batch(x0s, p=p, tvp=tvp, params=params,
                                       carry=carry)
        if carry is None:
            return out, res
        X, U, s = self.mpc.nlp.unpack(out.w)
        return (out._replace(w=self.mpc.nlp.pack(X + self.delta, U, s)),
                res._replace(x=X + self.delta))


def test_perturbed_defect_is_not_correct():
    def wrap(cell):
        cell.mpc = _Moved(cell.mpc, 2e-3)
    res = _run(wrap)
    assert not res["correct"], res["checks"]
    assert res["checks"]["defect_max"]["value"] > 1e-3


def test_wrong_hidden_update_is_not_correct():
    def wrap(cell):
        model = cell.mpc.model

        def fn(z, u, p, tvp, w):
            out = model.fn(z, u, p, tvp, w)
            return torch.cat([out[:, :12], out[:, 12:] + 1e-2], dim=-1)
        wrong = port.DynamicsModel(fn=fn, dims=model.dims, name=model.name)
        cell.mpc = type(cell.mpc)(
            port.NMPC(**dict(cell.mpc._args, model=wrong), device="cpu"),
            cell.mpc.nx, cell.mpc.u)
    res = _run(wrap)
    assert not res["correct"], res["checks"]
    assert res["checks"]["defect_max"]["value"] > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_control_fails_where_the_program_passes(control):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    res = driver.run(Layout(ROOT), CELL, 2 ** 32 + 5, 2.0, False,
                     t_start=time.perf_counter(), device="cuda",
                     overrides=SMALL, control=control)
    assert res["correct"] is (not control), res["checks"]
