"""The parallel-in-time Riccati sweep (``solve/pscan.py``) and
``IPConfig(kkt="riccati_pscan")``: the port against the JAX package on the
CPU.

The sweep's inputs are ``tests/test_pscan.py``'s ``make_data``, one seed a
problem, stacked into a batch; the port's ``riccati_sweep_pscan`` is held
to the JAX package's (vmapped, its matrix-last form on the CPU) and to the
port's plain sequential sweep within 3e-4 of max(1, max|dX|) (the JAX
test's bound up to H=64; it allows 1e-2 at H=256, held here to 3e-4 too),
with equal ok flags.  The controller runs ``test_pscan.py``'s two problems
in both packages (2e-4 and 3e-4, its bounds), the IFT gradients under
pscan are held to the kernel backend's (1e-4 of the largest entry), and
``associative_scan`` to a sequential fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.solve.pscan import riccati_sweep_pscan as jax_pscan
from pyneuralempc_tpu_torch.ops.cuda.riccati_kernel import riccati_sweep_plain
from pyneuralempc_tpu_torch.ops.scan import associative_scan
from pyneuralempc_tpu_torch.solve.pscan import riccati_sweep_pscan
from pyneuralempc_tpu_torch.solve.riccati import make_riccati_direction

from test_pscan import make_data
import _torch_threads  # noqa: F401  (one torch thread)

SWEEP_TOL = 3e-4
GRAD_RTOL = 1e-4


def batch(H, nx, nu, n=3, dt=0.1):
    """``make_data`` of seeds 0..n-1 stacked: numpy (n, H, ...) and δ = 0."""
    datas = [make_data(H=H, nx=nx, nu=nu, seed=s, dt=dt) for s in range(n)]
    return ([np.stack([np.asarray(d[i]) for d in datas]) for i in range(7)]
            + [np.zeros(n, np.float32)])


def both(args):
    """The port's pscan, the JAX package's (vmapped) and the port's plain
    sweep on the same numpy inputs, as numpy."""
    t = [torch.as_tensor(a) for a in args]
    port = [o.numpy() for o in riccati_sweep_pscan(*t)]
    jx = [np.asarray(o) for o in jax.jit(jax.vmap(jax_pscan))(
        *[jnp.asarray(a) for a in args])]
    plain = [o.numpy() for o in riccati_sweep_plain(*t)]
    return port, jx, plain


@pytest.mark.parametrize("H,nx,nu,dt", [(8, 2, 1, 0.1), (16, 3, 2, 0.1),
                                        (33, 4, 1, 0.1), (64, 2, 2, 0.1),
                                        (256, 3, 1, 0.02)])
def test_pscan_matches_jax_and_plain(H, nx, nu, dt):
    port, jx, plain = both(batch(H, nx, nu, dt=dt))
    assert port[3].all() and jx[3].all() and plain[3].all()
    scale = max(1.0, float(np.abs(plain[0]).max()))
    for ref in (jx, plain):
        for r, o in zip(ref[:3], port[:3]):
            np.testing.assert_allclose(o, r, atol=SWEEP_TOL * scale,
                                       rtol=2e-3)


def test_pscan_delta_regularisation():
    """Negative control curvature: the members at δ = 0 fail, those at
    δ = 10 pass, in the port, in the JAX package and in the plain sweep."""
    args = batch(10, 2, 1, n=4)
    args[3][:, :, 2, 2] = -3.0
    args[7] = np.float32([0.0, 10.0, 0.0, 10.0])
    port, jx, plain = both(args)
    want = [False, True, False, True]
    assert port[3].tolist() == want
    assert jx[3].tolist() == want and plain[3].tolist() == want
    scale = max(1.0, float(np.abs(plain[0][1::2]).max()))
    for r, o in zip(plain[:3], port[:3]):
        np.testing.assert_allclose(o[1::2], r[1::2], atol=SWEEP_TOL * scale,
                                   rtol=2e-3)
    # every member at δ = 0 fails
    args[7] = np.zeros(4, np.float32)
    assert not riccati_sweep_pscan(*map(torch.as_tensor, args))[3].any()


@pytest.mark.parametrize("n", [1, 2, 7, 33, 64])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_fold(n, reverse):
    """A non-commutative product (3x3 matrices, float64): forward, the
    prefix products x_i ⋯ x_0; reverse, with fn's first argument the higher
    index, the suffix products; and JAX's scan of the same fn in f32."""
    x = torch.as_tensor(np.random.default_rng(n).normal(size=(2, n, 3, 3)))
    got, = associative_scan(lambda a, b: (b[0] @ a[0],), (x,), dim=1,
                            reverse=reverse)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc, ref = None, {}
    for i in order:
        acc = x[:, i] if acc is None else x[:, i] @ acc
        ref[i] = acc
    ref = torch.stack([ref[i] for i in range(n)], 1)
    assert float((got - ref).abs().max()) <= 1e-9 * float(ref.abs().max())
    jgot = jax.lax.associative_scan(lambda a, b: b @ a,
                                    jnp.asarray(x.numpy(), jnp.float32),
                                    reverse=reverse, axis=1)
    f32, = associative_scan(lambda a, b: (b[0] @ a[0],), (x.float(),), dim=1,
                            reverse=reverse)
    np.testing.assert_allclose(f32.numpy(), np.asarray(jgot), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def _lv_j(x, u):
    return jnp.concatenate(
        [0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
         -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], axis=1)


def _lv_t(x, u):
    return torch.cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                      -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], 1)


BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
           control_constraint=[[-1.0, 1.0]])


def _problem(lib, npx, lv, stage_row):
    """``test_pscan.py``'s controller (H=40, DT=0.05, RK4) in ``lib``,
    with its stage interval row or without."""
    cost = lib.StageCost(stage=lambda x, u: 1.1 * npx.sum(u)
                         + 0.05 * npx.sum(x ** 2))
    cons = [lib.DomainConstraint(**BOX)]
    if stage_row:
        cons.append(lib.stage_interval(
            lambda x, u: npx.stack([x[0] + 0.5 * x[1]]), dim=1, lb=-0.45,
            ub=0.45))
    kw = {} if lib is J else {"device": "cpu"}

    def make(kkt):
        return lib.NMPC(lib.jax_dynamics(lv, 2, 1) if lib is J
                        else lib.torch_dynamics(lv, 2, 1), cost, cons, H=40,
                        DT=0.05, integrator="rk4",
                        config=lib.IPConfig(kkt=kkt), **kw)
    return make


@pytest.mark.parametrize("stage_row,tol", [(False, 2e-4), (True, 3e-4)],
                         ids=["box", "stage_interval"])
def test_nmpc_pscan_matches_jax(stage_row, tol):
    x0 = np.array([0.3, 0.2], np.float32)
    tmake = _problem(T, torch, _lv_t, stage_row)
    tm = tmake("riccati_pscan")
    assert tm.kkt_backend == "riccati_pscan"
    r_par = tm.next(torch.as_tensor(x0))
    r_seq = tmake("riccati").next(torch.as_tensor(x0))
    j_par = _problem(J, jnp, _lv_j, stage_row)("riccati_pscan").next(
        jnp.asarray(x0))
    assert bool(r_par.converged) and bool(r_seq.converged)
    assert bool(j_par.converged)
    np.testing.assert_allclose(r_par.u.numpy(), np.asarray(j_par.u),
                               atol=tol)
    np.testing.assert_allclose(r_par.u.numpy(), r_seq.u.numpy(), atol=tol)


def test_differentiable_pscan_matches_kernel_backend():
    """IFT gradients with respect to x0 of Σ U² + Σ objective: the pscan
    direction against the Riccati kernel backend's (its plain version on
    the CPU), within GRAD_RTOL of the largest entry."""
    grads = {}
    for kkt in ("riccati", "riccati_pscan"):
        mpc = T.NMPC(T.torch_dynamics(_lv_t, 2, 1),
                     T.StageCost(stage=lambda x, u: 1.1 * torch.sum(u)
                                 + 0.2 * torch.sum(x ** 2)),
                     [T.DomainConstraint(**BOX)], H=8, DT=0.1,
                     integrator="rk4", differentiable=True,
                     config=T.IPConfig(max_iter=80, tol=1e-6, kkt=kkt),
                     device="cpu")
        assert mpc.kkt_backend == kkt
        x0s = torch.tensor([[0.3, 0.2], [0.1, -0.1]], requires_grad=True)
        _, res = mpc.next_batch(x0s)
        assert bool(res.converged.all())
        ((res.u ** 2).sum() + res.objective.sum()).backward()
        grads[kkt] = x0s.grad.numpy()
    ref = grads["riccati"]
    err = np.abs(grads["riccati_pscan"] - ref).max() / np.abs(ref).max()
    assert np.abs(ref).max() > 1e-3 and err <= GRAD_RTOL, (err, grads)


def test_general_path_rejects_custom_sweep():
    """A stage equality row takes the general sweep, which no custom sweep
    replaces: both packages raise ValueError."""
    tmake = _problem(T, torch, _lv_t, False)
    eq = T.StageConstraint(stage=lambda x, u: u - 0.1, dim=1, lb=(0.0,),
                           ub=(0.0,))
    mpc = T.NMPC(T.torch_dynamics(_lv_t, 2, 1), tmake("riccati").spec
                 .objective, [T.DomainConstraint(**BOX), eq], H=8, DT=0.1,
                 device="cpu")
    assert mpc.kkt_backend == "riccati"
    with pytest.raises(ValueError, match="only the plain Riccati path"):
        make_riccati_direction(mpc.nlp, mpc.config,
                               sweep_impl=riccati_sweep_pscan)
    with pytest.raises(ValueError, match="only the plain Riccati path"):
        T.NMPC(T.torch_dynamics(_lv_t, 2, 1), mpc.spec.objective,
               [T.DomainConstraint(**BOX), eq], H=8, DT=0.1,
               config=T.IPConfig(kkt="riccati_pscan"), device="cpu")
    jeq = J.StageConstraint(stage=lambda x, u: u - 0.1, dim=1, lb=(0.0,),
                            ub=(0.0,))
    with pytest.raises(ValueError, match="only the plain Riccati path"):
        J.NMPC(J.jax_dynamics(_lv_j, 2, 1),
               J.StageCost(stage=lambda x, u: jnp.sum(u ** 2)),
               [J.DomainConstraint(**BOX), jeq], H=8, DT=0.1,
               config=J.IPConfig(kkt="riccati_pscan"))
