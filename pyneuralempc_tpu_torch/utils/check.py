"""Derivative checking: autodiff against central finite differences.

PyTorch counterpart of ``pyneuralempc_tpu/utils/check.py``.  The port's
derivatives come from ``torch.func``, so they cannot be assembled wrong, but
a user's model or cost can still be non-differentiable, discontinuous or
numerically violent at the operating point.  :func:`check_model` and
:func:`check_problem` probe that and report the worst errors.  The finite
differences run in f64 on numpy around the f32 function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.func import grad, jacrev


def _numpy(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float64)


def _fd_jacobian(f, x, eps, device):
    """Central differences of ``f`` (f32 tensors in and out) at ``x``,
    stepped in f64: (out shape) + (x shape)."""
    x = _numpy(x)

    def at(v):
        return _numpy(f(torch.as_tensor(v, dtype=torch.float32,
                                        device=device)))

    y0 = at(x)
    J = np.zeros(y0.shape + x.shape)
    it = np.nditer(x, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        dx = np.zeros_like(x)
        dx[idx] = eps
        J[(Ellipsis,) + idx] = (at(x + dx) - at(x - dx)) / (2 * eps)
    return J


def _errors(ad, fd):
    aerr = float(np.abs(ad - fd).max())
    return aerr, aerr / (float(np.abs(fd).max()) + 1.0)


def check_model(model, x=None, u=None, p=None, tvp=None, params=None,
                T: int = 3, eps: float = 1e-3, seed: int = 0,
                device="cuda") -> Dict:
    """The model's autodiff Jacobian with respect to (x, u) against central
    finite differences at a given or random point (0.3 times standard
    normals from a CPU generator seeded ``seed``; the JAX package draws its
    own).  Returns a report dict of max absolute and relative errors and
    ``ok`` (every relative error under 1e-2); raises nothing."""
    dims = model.dims
    gen = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn((T, dims.x), generator=gen) if x is None
         else torch.as_tensor(x, dtype=torch.float32))
    u = (0.3 * torch.randn((T, dims.u), generator=gen) if u is None
         else torch.as_tensor(u, dtype=torch.float32))
    x, u = x.to(device), u.to(device)

    def f_x(xx):
        return model(xx, u, p, tvp, params)

    def f_u(uu):
        return model(x, uu, p, tvp, params)

    report = {}
    for name, f, v in (("x", f_x, x), ("u", f_u, u)):
        ad = _numpy(jacrev(f)(v))
        aerr, rerr = _errors(ad, _fd_jacobian(f, v, eps, device))
        report[f"jac_{name}_abs_err"] = aerr
        report[f"jac_{name}_rel_err"] = rerr
    report["ok"] = all(report[k] < 1e-2 for k in report
                       if k.endswith("rel_err"))
    return report


def check_problem(mpc, x0, p=None, tvp=None, params=None,
                  eps: float = 1e-3) -> Dict:
    """The transcribed NLP's objective gradient and constraint Jacobian at
    the cold-start point of one problem against finite differences."""
    from ..core.problem import runtime

    nlp, dev = mpc.nlp, mpc.device
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    rt = runtime(x0, p, tvp, params)
    w = mpc.cold_start(x0, p=p, tvp=tvp, params=params).w

    def obj(ww):
        return nlp.objective(ww, rt)

    def cons(ww):
        return nlp.constraints(ww, rt)

    report = {}
    for name, ad, fd in (
            ("grad", grad(obj)(w), _fd_jacobian(obj, w, eps, dev)),
            ("jac", jacrev(cons)(w), _fd_jacobian(cons, w, eps, dev))):
        aerr, rerr = _errors(_numpy(ad), fd)
        report[f"{name}_abs_err"] = aerr
        report[f"{name}_rel_err"] = rerr
    report["ok"] = (report["grad_rel_err"] < 1e-2
                    and report["jac_rel_err"] < 1e-2)
    return report
