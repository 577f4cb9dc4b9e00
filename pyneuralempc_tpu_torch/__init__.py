"""pyneuralempc_tpu_torch — the economic-MPC engine on PyTorch and CUDA.

The PyTorch port of ``pyneuralempc_tpu`` (the JAX package, which stays the
reference).  Plug a neural network (or any differentiable torch function)
in as the system dynamics; the package transcribes the nonlinear program
(multiple-shooting defects, economic objective, exact derivatives by
``torch.func``) and solves a whole batch of MPC problems with a batched
primal-dual interior-point method.  Its KKT systems go through a
block-tridiagonal Riccati sweep, hand-written CUDA kernels on the card;
stage-equality rows and trajectory-level constraint rows take the general
sweep, and any other problem (a stage-coupled cost, more equality rows a
stage than controls) the dense backend, one batched LU.  An
augmented-Lagrangian solver (:class:`ALMConfig`) and an IFT-differentiable
solve (``NMPC(differentiable=True)``) sit beside the interior point.
:mod:`.examples.quadrotor` is the quadrotor fleet (12 states, 4
thrusts, H=50), :mod:`.examples.fleet_eq` the same fleet with a stage
equality row and a horizon budget row, :mod:`.examples.fleet_rnn` a fleet
with GRU dynamics (the hidden state lifted into the MPC state, H=100) and
:mod:`.examples.cartpole` the cartpole swing-up with a nonlinear
tip-clearance row, and :mod:`.examples.fleet_wide` a 10-rotor fleet (12
states, 10 thrusts).  Trained networks load from Keras .h5 files or torch
state_dicts (:mod:`.models.importers`).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

Quick start::

    import torch
    import pyneuralempc_tpu_torch as nempc

    def f(x, u):  # continuous-time dynamics, batched over the horizon
        return torch.cat([0.5*x[:, :1] - 0.025*x[:, :1]*x[:, 1:],
                          -0.5*x[:, 1:] + u + 0.005*x[:, :1]*x[:, 1:]],
                         dim=1)

    model = nempc.torch_dynamics(f, x_dim=2, u_dim=1)
    cost = lambda x, u: torch.sum(u * 1.1)
    box = nempc.DomainConstraint(states_constraint=[[0., 60.], [0., 40.]],
                                 control_constraint=[[0., 60.]])
    mpc = nempc.NMPC(model, cost, [box], H=25, DT=0.1, integrator="rk4")
    carry, res = mpc.next_batch(torch.tensor([[50., 5.]] * 1024))
    res.u  # planned controls, (1024, H, 1)
"""

from .core.problem import (Box, Dims, MPCSpec, PathConstraint, StageCost,
                           StageConstraint, equality_constraint,
                           inequality_constraint, interval_constraint,
                           runtime, stage_inequality, stage_interval)
from .core.structure import SeparableObjective, probe_stage_separable
from .core.transcription import NLP, transcribe
from .models.base import DynamicsModel, torch_dynamics
from .models.convert import mlp_params_from_numpy, params_from_numpy
from .models.importers import (load_keras_gru_h5, load_keras_h5,
                               load_keras_h5_rolling, load_keras_lstm_h5,
                               load_torch_mlp)
from .models.mlp import MLPDynamics, mlp_apply, mlp_init
from .models.rolling import RollingWindow, rolling_mlp, rolling_window
from .models.rnn import (GRUDynamics, LSTMDynamics, StackedLSTMDynamics,
                         fit_gru_on_sequences, gru_dynamics,
                         keras_gru_dynamics, lstm_dynamics,
                         stacked_lstm_dynamics)
from .models.train import (fit_normalized_surrogate, fit_surrogate,
                           sample_transitions)
from .utils.checkpoint import load_pytree, save_pytree
from .utils.check import check_model, check_problem
from .utils.compile_cache import enable_compilation_cache
from .solve.interior_point import IPConfig, IPResult, make_solver
from .solve.alm import ALMConfig, make_alm_solver
from .solve.diff import make_differentiable_solver
from .api.controller import (NMPC, NMPCResult, WarmStart,
                             multi_start_perturbations)
from .ops.cuda import riccati_general, riccati_kernel

# Reference-compatible alias (pyNeuralEMPC.constraints.DomainConstraint).
DomainConstraint = Box.make

__version__ = "0.1.0"

__all__ = [
    "Box", "Dims", "MPCSpec", "PathConstraint", "StageConstraint",
    "StageCost", "DomainConstraint", "stage_inequality", "stage_interval",
    "equality_constraint", "inequality_constraint", "interval_constraint",
    "runtime",
    "SeparableObjective", "probe_stage_separable", "NLP", "transcribe",
    "DynamicsModel", "torch_dynamics", "mlp_params_from_numpy",
    "params_from_numpy", "MLPDynamics", "mlp_apply", "mlp_init",
    "RollingWindow", "rolling_mlp", "rolling_window", "load_keras_h5",
    "load_keras_lstm_h5", "load_keras_gru_h5", "load_keras_h5_rolling",
    "load_torch_mlp", "GRUDynamics",
    "LSTMDynamics", "StackedLSTMDynamics", "gru_dynamics", "lstm_dynamics",
    "keras_gru_dynamics", "stacked_lstm_dynamics", "fit_gru_on_sequences",
    "fit_surrogate", "fit_normalized_surrogate", "sample_transitions",
    "save_pytree", "load_pytree", "check_model", "check_problem",
    "enable_compilation_cache",
    "IPConfig", "IPResult", "make_solver", "ALMConfig", "make_alm_solver",
    "make_differentiable_solver", "NMPC", "NMPCResult",
    "WarmStart", "multi_start_perturbations", "riccati_kernel",
    "riccati_general",
]
