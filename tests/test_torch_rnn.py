"""Recurrent models (``models/rnn.py``) and the GRU fleet
(``examples/fleet_rnn.py``): the port against the JAX package on the CPU.

* The cells: ``gru_step``, ``lstm_step``, ``keras_gru_step`` (both reset
  conventions) and the stacked LSTM's step, on the same numpy weights and
  inputs (carried across by ``params_from_numpy``), within rtol 1e-5.
* The lifted models (GRU, LSTM in both readout modes, Keras GRU, stacked
  LSTM) through ``step_fn(..., "direct")``, within rtol 1e-5.
* ``fit_gru_on_sequences`` learns the JAX package's linear-system check
  (``tests/test_fleet_rnn.py``: mse < 5e-3).
* The GRU fleet's solve (hidden 4, H=8, B=4, one set of fitted GRU
  weights in both): a cold ``next_batch`` and one warm re-plan, |Δu|∞ ≤
  1e-4 with equal converged masks and iteration counts.
* The port's ``fleet_rnn`` example at a tiny size; ``--mesh`` refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.models import rnn as jrnn
from pyneuralempc_tpu.ops.integrators import step_fn as j_step_fn
from pyneuralempc_tpu_torch.examples import fleet_rnn
from pyneuralempc_tpu_torch.models import rnn as trnn
from pyneuralempc_tpu_torch.ops.integrators import step_fn as t_step_fn

import _torch_threads  # noqa: F401  (one torch thread)

RTOL, ATOL = 1e-5, 1e-6
DU_TOL = 1e-4


def _np(tree):
    """A JAX params tree as numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(np_tree):
    """(JAX params, port params) from one numpy tree."""
    return (jax.tree_util.tree_map(jnp.asarray, np_tree),
            T.params_from_numpy(np_tree, device="cpu"))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _keras_gru_params(rng, ni, nh, no, reset_after):
    return {"wk": _rand(rng, ni, 3 * nh, scale=0.5),
            "wr": _rand(rng, nh, 3 * nh, scale=0.5),
            "b": (_rand(rng, 2, 3 * nh, scale=0.1) if reset_after
                  else _rand(rng, 3 * nh, scale=0.1)),
            "wo": _rand(rng, nh, no, scale=0.5),
            "bo": _rand(rng, no, scale=0.1)}


def _stacked_params(rng, ni, hiddens, no):
    layers, d = [], ni
    for nh in hiddens:
        layers.append({"wk": _rand(rng, d, 4 * nh, scale=0.5),
                       "wr": _rand(rng, nh, 4 * nh, scale=0.5),
                       "b": _rand(rng, 4 * nh, scale=0.1)})
        d = nh
    return {"layers": layers, "wo": _rand(rng, d, no, scale=0.5),
            "bo": _rand(rng, no, scale=0.1)}


def test_cells_match_jax():
    rng = np.random.default_rng(0)
    ni, nh, n = 3, 5, 7
    inp, h, c = _rand(rng, n, ni), _rand(rng, n, nh, scale=0.5), \
        _rand(rng, n, nh, scale=0.5)
    jt = lambda a: jnp.asarray(a)  # noqa: E731
    tt = torch.as_tensor
    gru = _np(jrnn.gru_init(jax.random.PRNGKey(0), ni, nh, 2))
    jp, tp = _both(gru)
    _close(trnn.gru_step(tp, tt(h), tt(inp)),
           jrnn.gru_step(jp, jt(h), jt(inp)))
    lstm = _np(jrnn.lstm_init(jax.random.PRNGKey(1), ni, nh, 2))
    jp, tp = _both(lstm)
    for got, ref in zip(trnn.lstm_step(tp, tt(h), tt(c), tt(inp)),
                        jrnn.lstm_step(jp, jt(h), jt(c), jt(inp))):
        _close(got, ref)
    for reset_after in (True, False):
        jp, tp = _both(_keras_gru_params(rng, ni, nh, 2, reset_after))
        _close(trnn.keras_gru_step(tp, tt(h), tt(inp), reset_after),
               jrnn.keras_gru_step(jp, jt(h), jt(inp), reset_after))
    # the stacked LSTM's step: layer 2 reads layer 1's new hidden state
    jp, tp = _both(_stacked_params(rng, ni, (nh, 4), 2))
    z = np.concatenate([_rand(rng, n, 2 * 5, scale=0.5),
                        _rand(rng, n, 2 * 4, scale=0.5)], axis=1)
    x, u = _rand(rng, n, 2), _rand(rng, n, 1)
    jm = jrnn.stacked_lstm_dynamics(2, 1, (nh, 4)).model
    tm = trnn.stacked_lstm_dynamics(2, 1, (nh, 4)).model
    zz = np.concatenate([x, z], axis=1)
    _close(tm(tt(zz), tt(u), params=tp), jm(jt(zz), jt(u), params=jp))


@pytest.mark.parametrize("kind", ["gru", "lstm_delta", "lstm_direct",
                                  "keras_gru", "keras_gru_v1",
                                  "stacked_lstm"])
def test_lifted_models_match_jax(kind):
    """The lifted z' = Φ(z, u) through the integrator, both packages."""
    rng = np.random.default_rng(1)
    nx, nu, nh = 2, 1, 4
    if kind == "gru":
        jb, tb = jrnn.gru_dynamics(nx, nu, nh), trnn.gru_dynamics(nx, nu, nh)
        prm = _np(jb.init_params(jax.random.PRNGKey(2)))
    elif kind.startswith("lstm"):
        mode = kind.split("_")[1]
        jb = jrnn.lstm_dynamics(nx, nu, nh, mode=mode)
        tb = trnn.lstm_dynamics(nx, nu, nh, mode=mode)
        prm = _np(jb.init_params(jax.random.PRNGKey(3)))
    elif kind.startswith("keras_gru"):
        ra = kind == "keras_gru"
        jb = jrnn.keras_gru_dynamics(nx, nu, nh, reset_after=ra)
        tb = trnn.keras_gru_dynamics(nx, nu, nh, reset_after=ra)
        prm = _keras_gru_params(rng, nx + nu, nh, nx, ra)
    else:
        jb = jrnn.stacked_lstm_dynamics(nx, nu, (nh, 3))
        tb = trnn.stacked_lstm_dynamics(nx, nu, (nh, 3))
        prm = _stacked_params(rng, nx + nu, (nh, 3), nx)
    jd, td = jb.model.dims, tb.model.dims
    assert (jd.x, jd.u, jd.p, jd.tvp) == (td.x, td.u, td.p, td.tvp)
    jp, tp = _both(prm)
    nz = tb.model.dims.x
    z = _rand(rng, 6, nz, scale=0.5)
    u = _rand(rng, 6, nu)
    jphi = j_step_fn(jb.model, "direct", 1.0)
    tphi = t_step_fn(tb.model, "direct", 1.0)
    _close(tphi(torch.as_tensor(z), torch.as_tensor(u), params=tp),
           jphi(jnp.asarray(z), jnp.asarray(u), params=jp))
    # lift, head and box agree too
    x0 = np.array([0.2, -0.1], np.float32)
    _close(tb.lift(torch.as_tensor(x0)), jb.lift(jnp.asarray(x0)))
    assert tb.head(torch.as_tensor(z)).shape == (6, nx)
    tbox = tb.box([[-1.0, 1.0]] * nx, [[-1.0, 1.0]])
    jbox = jb.box([[-1.0, 1.0]] * nx, [[-1.0, 1.0]])
    assert (tbox.x_lb, tbox.x_ub, tbox.u_lb, tbox.u_ub) == (
        jbox.x_lb, jbox.x_ub, jbox.u_lb, jbox.u_ub)


def test_fit_gru_learns_linear_system():
    """The JAX package's check (tests/test_fleet_rnn.py): a GRU fitted
    teacher-forced to a 2-state damped linear system, mse < 5e-3."""
    A = np.array([[0.95, 0.05], [0.0, 0.9]], np.float32)
    Bm = np.array([[0.0], [0.2]], np.float32)
    rng = np.random.default_rng(0)
    N, Tn = 128, 16
    U = rng.uniform(-1, 1, (N, Tn, 1)).astype(np.float32)
    X = np.zeros((N, Tn + 1, 2), np.float32)
    X[:, 0] = rng.uniform(-1, 1, (N, 2))
    for t in range(Tn):
        X[:, t + 1] = X[:, t] @ A.T + U[:, t] @ Bm.T
    gd = T.gru_dynamics(x_dim=2, u_dim=1, hidden=8)
    params, mse = T.fit_gru_on_sequences(gd, torch.as_tensor(X),
                                         torch.as_tensor(U), steps=800,
                                         lr=5e-3)
    assert mse < 5e-3, mse
    assert set(params) == {"wz", "wr", "wh", "bz", "br", "bh", "wo", "bo"}
    # the teacher-forced loss of the returned weights is the reported one's
    # order (one Adam step later)
    loss = float(trnn._teacher_forced_loss(params, torch.as_tensor(X),
                                           torch.as_tensor(U), 8))
    assert loss < 5e-3


def test_gru_fleet_next_batch_matches_jax():
    """The GRU fleet's problem (fleet_rnn.py's plant, cost, box, direct
    integrator) at hidden 4, H=8, B=4, on one set of GRU weights (the
    port's fit, 300 steps on 64 plant sequences, carried to the JAX package
    as numpy): cold and one warm re-plan from the plan's first lifted
    state, every member converged."""
    H, B, nh = 8, 4, 4
    tgd, tp, mse = fleet_rnn.fit_fleet_gru("cpu", hidden=nh, steps=300,
                                           n=64)
    assert mse < 1e-3, mse
    jp = jax.tree_util.tree_map(jnp.asarray,
                                {k: v.numpy() for k, v in tp.items()})
    jgd = jrnn.gru_dynamics(x_dim=2, u_dim=1, hidden=nh)
    jcost = J.StageCost(stage=jgd.head_objective(
        lambda x, u: jnp.sum((x - jnp.array(fleet_rnn.TARGET)) ** 2)))
    jbox = jgd.box(states_constraint=[[-1.0, 1.0], [-1.0, 1.0]],
                   control_constraint=[[-1.0, 1.0]])
    jm = J.NMPC(jgd.model, jcost, [jbox], H=H, DT=1.0, integrator="direct",
                config=J.IPConfig(max_iter=60))
    tm = fleet_rnn.make_fleet_rnn_mpc(tgd, "cpu", H=H)
    z0 = fleet_rnn.fleet_starts(tgd, B, device="cpu").numpy()
    jc, jres = jm.next_batch(jnp.asarray(z0), params=jp)
    tc, tres = tm.next_batch(torch.as_tensor(z0), params=tp)
    for _ in range(2):
        np.testing.assert_array_equal(tres.converged.numpy(),
                                      np.asarray(jres.converged))
        np.testing.assert_array_equal(tres.iterations.numpy(),
                                      np.asarray(jres.iterations))
        du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
        assert du <= DU_TOL, du
        assert bool(tres.converged.all())
        z1 = np.array(jres.x[:, 0], np.float32)
        jc, jres = jm.next_batch(jnp.asarray(z1), params=jp, carry=jc)
        tc, tres = tm.next_batch(torch.as_tensor(z1), params=tp, carry=tc)


def test_fleet_rnn_main(capsys):
    fleet_rnn.main(["--cpu", "--batch", "4", "--H", "8", "--hidden", "4",
                    "--steps", "1", "--fit-steps", "30"])
    out = capsys.readouterr().out
    assert "kkt=riccati  B=4  H=8  lifted state=6" in out
    assert "cold fleet solve" in out and "warm fleet step" in out


def test_fleet_rnn_plant_and_mesh(capsys):
    X, U = fleet_rnn.plant_sequences(0, n=3, T=5)
    assert X.shape == (3, 6, 2) and U.shape == (3, 5, 1)
    # one step by hand: the hidden lag starts at 0
    w = 0.3 * U[:, 0, 0]
    np.testing.assert_allclose(X[:, 1, 0],
                               X[:, 0, 0] + 0.5 * (-0.4 * X[:, 0, 0] + w),
                               rtol=1e-6)
    # --mesh (once refused) shards the fleet over two shards of the CPU
    fleet_rnn.main(["--cpu", "--mesh", "2", "--batch", "4", "--H", "8",
                    "--hidden", "4", "--steps", "1", "--fit-steps", "30"])
    out = capsys.readouterr().out
    assert "scenario-sharded over 2 devices" in out
    assert "warm fleet step" in out and "(converged 4/4)" in out
