"""pyneuralempc_tpu_torch — the economic-MPC engine on PyTorch and CUDA.

The PyTorch port of ``pyneuralempc_tpu`` (the JAX package, which stays the
reference).  Plug a neural network (or any differentiable torch function)
in as the system dynamics; the package transcribes the nonlinear program
(multiple-shooting defects, economic objective, exact derivatives by
``torch.func``) and solves a whole batch of MPC problems with a batched
primal-dual interior-point method.  Its KKT systems go through a
block-tridiagonal Riccati sweep, a hand-written CUDA kernel on the card.

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

from .core.problem import Box, Dims, MPCSpec, StageCost, runtime
from .core.structure import SeparableObjective, probe_stage_separable
from .core.transcription import NLP, transcribe
from .models.base import DynamicsModel, torch_dynamics
from .models.convert import mlp_params_from_numpy
from .models.mlp import MLPDynamics, mlp_apply, mlp_init
from .models.train import fit_surrogate, sample_transitions
from .solve.interior_point import IPConfig, IPResult, make_solver
from .api.controller import NMPC, NMPCResult, WarmStart
from .ops.cuda import riccati_kernel

# Reference-compatible alias (pyNeuralEMPC.constraints.DomainConstraint).
DomainConstraint = Box.make

__version__ = "0.1.0"

__all__ = [
    "Box", "Dims", "MPCSpec", "StageCost", "DomainConstraint", "runtime",
    "SeparableObjective", "probe_stage_separable", "NLP", "transcribe",
    "DynamicsModel", "torch_dynamics", "mlp_params_from_numpy",
    "MLPDynamics", "mlp_apply", "mlp_init", "fit_surrogate",
    "sample_transitions", "IPConfig", "IPResult", "make_solver", "NMPC",
    "NMPCResult", "WarmStart", "riccati_kernel",
]
