"""Integrator step transforms Φ(f).

PyTorch counterpart of ``pyneuralempc_tpu/ops/integrators.py``.  Each
integrator lifts the model step function ``f`` into a one-step state map
``Φ(x_t, u_t) -> x_{t+1}``, evaluated batched over all stages at once:

  * ``delta``  — ``x̂ = x + f(x, u)`` (f outputs a state difference);
  * ``euler``  — explicit Euler on a continuous-time f: ``x̂ = x + DT·f``;
  * ``rk4``    — classic 4-stage Runge-Kutta on a continuous-time f;
  * ``direct`` — f outputs the next state directly.

``tvp`` is held constant across the RK4 substeps of a stage.
"""

from __future__ import annotations

from typing import Callable


def _delta(model, dt, x, u, p, tvp, params):
    del dt
    return x + model(x, u, p, tvp, params)


def _euler(model, dt, x, u, p, tvp, params):
    return x + dt * model(x, u, p, tvp, params)


def _rk4(model, dt, x, u, p, tvp, params):
    k1 = model(x, u, p, tvp, params)
    k2 = model(x + 0.5 * dt * k1, u, p, tvp, params)
    k3 = model(x + 0.5 * dt * k2, u, p, tvp, params)
    k4 = model(x + dt * k3, u, p, tvp, params)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _direct(model, dt, x, u, p, tvp, params):
    del dt
    return model(x, u, p, tvp, params)


INTEGRATORS = {
    "delta": _delta,
    "euler": _euler,
    "rk4": _rk4,
    "direct": _direct,
}


def step_fn(model, integrator: str, dt: float) -> Callable:
    """Return ``phi(x, u, p, tvp, params) -> x_next`` batched over time."""
    impl = INTEGRATORS[integrator]

    def phi(x, u, p=None, tvp=None, params=None):
        return impl(model, dt, x, u, p, tvp, params)

    return phi
