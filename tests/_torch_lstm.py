"""The LSTM fleets of ``examples/fleet_rnn.py`` (``lstm_fleet_model``,
the GRU fleet's MPC around a seeded LSTM or stacked LSTM) built in both
packages from one set of weights: the port's seeded tensors as numpy,
carried into the port by ``params_from_numpy`` and into the JAX package
as arrays."""

import jax
import jax.numpy as jnp
import numpy as np

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.models import rnn as jrnn
from pyneuralempc_tpu_torch.examples import fleet_rnn


def numpy_tree(tree):
    """A params tree of tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def lstm_fleets(kind, H, max_iter=60):
    """(JAX NMPC, JAX params, port NMPC on the CPU, port params, port
    bundle) of the ``kind`` LSTM fleet at horizon H."""
    tb, tp = fleet_rnn.lstm_fleet_model(kind, device="cpu")
    weights = numpy_tree(tp)
    hiddens = fleet_rnn.LSTM_HIDDENS[kind]
    if kind == "lstm":
        jb = jrnn.lstm_dynamics(x_dim=2, u_dim=1, hidden=hiddens[0])
    else:
        jb = jrnn.stacked_lstm_dynamics(x_dim=2, u_dim=1, hiddens=hiddens)
    target = jnp.array(fleet_rnn.TARGET)
    jcost = J.StageCost(stage=jb.head_objective(
        lambda x, u: jnp.sum((x - target) ** 2)))
    jbox = jb.box(states_constraint=[[-1.0, 1.0], [-1.0, 1.0]],
                  control_constraint=[[-1.0, 1.0]])
    jm = J.NMPC(jb.model, jcost, [jbox], H=H, DT=fleet_rnn.DT,
                integrator="direct", config=J.IPConfig(max_iter=max_iter))
    tm = fleet_rnn.make_fleet_rnn_mpc(tb, "cpu", H=H, max_iter=max_iter)
    return (jm, jax.tree_util.tree_map(jnp.asarray, weights), tm,
            T.params_from_numpy(weights, device="cpu"), tb)


def starts(tb, B):
    """The fleet's first B lifted starts, numpy."""
    return fleet_rnn.fleet_starts(tb, B, device="cpu").numpy()
