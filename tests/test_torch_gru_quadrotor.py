"""The port's lifted GRU with a feature map and standardising scales (the
quadrotor GRU fleet's model, ``models/rnn.py`` ``gru_dynamics``) against
the plain reference ``tests/_torch_gru_reference.py``, on the CPU:

* the lifted step with and without the feature map and the scales, in
  float64 and float32;
* the stage blocks A, B and G that the Riccati backend's ``prepare``
  derives (jacfwd over the model's vjp), at hidden 16, H=3, B=2, against
  the reference's ``torch.autograd.functional``;
* a seeded solve of B=2, H=6 through ``NMPC.next_batch`` (the direct
  integrator), the GRU's weights scaled so that the uncontrolled head stays
  inside the box, with the exact and the Gauss-Newton Hessian: every
  member converged, and the reference's defects and stationarity at the
  returned point under the benchmark configuration's limits (1e-3 each);
* ``fit_gru_on_sequences`` fits the scaled function: its teacher-forced
  loss is the reference's mean of squared standardised errors;
* ``NMPC.next_batch(init_x=, init_u=)``: the cold start's plan.
"""

import pytest
import torch

import _torch_gru_reference as gref
import _torch_threads  # noqa: F401  (one torch thread)
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu_torch.models import rnn as trnn
from pyneuralempc_tpu_torch.solve.riccati import make_riccati_direction

NX, NU, HID = 12, 4, 16
LIMIT = 1e-3          # benchmark/configs/quadrotor_gru.json check.limits


def features(x):
    """The quadrotor's features over the last axis: position, velocity,
    (sin, cos) of each Euler angle, body rates (15)."""
    ang = x[..., 6:9]
    return torch.cat([x[..., :6], torch.sin(ang), torch.cos(ang),
                      x[..., 9:12]], dim=-1)


def _scales(dtype, seed=1):
    g = torch.Generator().manual_seed(seed)

    def r(n, lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).to(dtype)
    return {"in_mu": r(15 + NU, -0.5, 0.5), "in_sd": r(15 + NU, 0.5, 2.0),
            "out_mu": r(NX, -0.01, 0.01), "out_sd": r(NX, 0.01, 0.2)}


def _bundle(scaled, dtype=torch.float32, seed=0, weight_scale=1.0):
    """(port bundle, its weights, the reference's step) at hidden 16: with
    ``scaled`` the quadrotor features and seeded scales, else neither."""
    sc = _scales(dtype) if scaled else {}
    gd = T.gru_dynamics(NX, NU, hidden=HID,
                        feature_map=features if scaled else None, **sc)
    w = gd.init_params(torch.Generator().manual_seed(seed), device="cpu")
    w = {k: (weight_scale * v if k == "wo" else v).to(dtype)
         for k, v in w.items()}

    def step(z, u):
        return gref.lifted_step(w, z, u, NX, features if scaled else None,
                                sc or None)
    return gd, w, step


def _points(n, dtype, seed=2):
    g = torch.Generator().manual_seed(seed)
    z = torch.cat([torch.rand((n, NX), generator=g) * 2.0 - 1.0,
                   torch.rand((n, HID), generator=g) * 1.6 - 0.8], dim=-1)
    u = torch.rand((n, NU), generator=g) * 3.0
    return z.to(dtype), u.to(dtype)


@pytest.mark.parametrize("scaled", [False, True],
                         ids=["plain", "features_and_scales"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)],
                         ids=["float64", "float32"])
def test_lifted_step_matches_reference(scaled, dtype, tol):
    gd, w, step = _bundle(scaled, dtype)
    assert gd.in_dim == (15 + NU if scaled else None)
    assert w["wz"].shape == (15 + NU + HID if scaled else NX + NU + HID,
                             HID)
    z, u = _points(64, dtype)
    got = gd.model(z, u, None, None, w)
    want = step(z, u)
    assert got.dtype == dtype and got.shape == (64, NX + HID)
    assert float((got - want).abs().max()) <= tol


def _mpc(gd, H, **ip):
    cost = T.StageCost(
        stage=gd.head_objective(lambda x, u: torch.sum(x[..., :3] ** 2)
                                + 0.1 * torch.sum(x[..., 3:] ** 2)
                                + 0.05 * torch.sum((u - 1.2) ** 2)),
        terminal=lambda z, p=None: 5.0 * torch.sum(gd.head(z)[..., :6] ** 2))
    box = gd.box([[-5.0, 5.0]] * 3 + [[-8.0, 8.0]] * 3 + [[-0.8, 0.8]] * 2
                 + [[-3.2, 3.2]] + [[-8.0, 8.0]] * 3, [[0.0, 3.0]] * NU)
    return T.NMPC(gd.model, cost, [box], H=H, DT=0.02, integrator="direct",
                  config=T.IPConfig(**ip), device="cpu")


def test_stage_blocks_match_reference():
    """A, B and the λ-weighted defect Hessian G from the Riccati
    backend's ``prepare`` at a seeded point, B=2, H=3, against the
    reference's autograd in float64 of the same float32 numbers."""
    H, B = 3, 2
    gd, w, step = _bundle(True)
    mpc = _mpc(gd, H)
    nlp = mpc.nlp
    g = torch.Generator().manual_seed(5)
    lo, hi = nlp.lower.clamp(-1.0, 1.0), nlp.upper.clamp(-1.0, 1.0)
    w_pt = lo + (hi - lo) * torch.rand((B, nlp.n), generator=g)
    lam = 0.3 * torch.randn((B, nlp.m), generator=g)
    x0 = _points(B, torch.float32, seed=6)[0]
    rt = T.runtime(x0, params=w)
    A, Bm, G, M, Jg, Jq = make_riccati_direction(nlp, mpc.config).prepare(
        w_pt, lam, rt)
    assert Jg == () and Jq == ()
    nz = NX + HID
    X, U, _ = nlp.unpack(w_pt)
    w64 = {k: v.double() for k, v in w.items()}
    sc64 = {k: v.double() for k, v in _scales(torch.float32).items()}

    def step64(z, u):
        return gref.lifted_step(w64, z, u, NX, features, sc64)
    for b in range(B):
        for t in range(H):
            z = (x0[b] if t == 0 else X[b, t - 1]).double()
            lam_t = lam[b, t * nz:(t + 1) * nz].double()
            rA, rB, rG = gref.stage_blocks(step64, z, U[b, t].double(),
                                           lam_t)
            for got, want in ((A[b, t], rA), (Bm[b, t], rB),
                              (G[b, t], rG)):
                err = (got.double() - want).abs().max()
                assert float(err) <= 1e-4 * max(1.0, float(
                    want.abs().max())), (b, t)


def _kkt_residuals(step, cost, z0, w, lam, zl, zu, lb, ub, H, nz, nu):
    """The defects (and bound violation) and the scaled stationarity and
    complementarity of the NLP min J s.t. step(z_{t-1}, u_t) − z_t = 0,
    lb ≤ w ≤ ub, at (w, λ, z_l, z_u), float64, the objective unscaled
    (the solve runs with auto_scale off); the dual scales are the
    benchmark judge's (``benchmark/reference/nlp.py``)."""
    w = w.double().detach().requires_grad_(True)
    Z = w[:, :H * nz].reshape(-1, H, nz)
    U = w[:, H * nz:H * (nz + nu)].reshape(-1, H, nu)
    c = gref.defects(step, z0.double(), Z, U).reshape(w.shape[0], -1)
    J = cost(Z, U)
    lam, zl, zu = lam.double(), zl.double(), zu.double()
    g, = torch.autograd.grad(J.sum(), w, retain_graph=True)
    ATlam, = torch.autograd.grad((c * lam).sum(), w)
    w, c = w.detach(), c.detach()
    lb, ub = lb.double(), ub.double()
    fin_l, fin_u = torch.isfinite(lb), torch.isfinite(ub)
    viol = torch.maximum(torch.where(fin_l, torch.relu(lb - w), 0.0),
                         torch.where(fin_u, torch.relu(w - ub), 0.0))
    r_d = g + ATlam - zl + zu
    comp = torch.maximum(torch.where(fin_l, zl * (w - lb), 0.0),
                         torch.where(fin_u, zu * (ub - w), 0.0))
    n_b = int(fin_l.sum() + fin_u.sum())
    s_d = torch.clamp((lam.abs().sum(-1) + zl.sum(-1) + zu.sum(-1))
                      / (lam.shape[1] + n_b), min=100.0) / 100.0
    s_c = torch.clamp((zl.sum(-1) + zu.sum(-1)) / n_b, min=100.0) / 100.0
    return (torch.maximum(c.abs().amax(-1), viol.amax(-1)),
            torch.maximum(r_d.abs().amax(-1) / s_d,
                          comp.abs().amax(-1) / s_c))


@pytest.mark.parametrize("hessian", ["exact", "gauss_newton"])
def test_seeded_solve_converges_within_the_limits(hessian):
    """B=2, H=6: the GRU's readout scaled by 0.05 keeps the uncontrolled
    head inside the box; a cold solve and one warm re-plan through
    ``next_batch`` converge, and the reference's defects and
    stationarity at each returned point stay under 1e-3, with the exact
    Hessian and with the Gauss-Newton one (the benchmark configuration's,
    ``quadrotor_gru.json`` ``solver``)."""
    H, B = 6, 2
    gd, w, step = _bundle(True, weight_scale=0.05)
    z0 = gd.lift(_points(B, torch.float32, seed=7)[0][:, :NX] * 0.3)
    uncontrolled = z0
    for _ in range(H):
        uncontrolled = gd.model(uncontrolled, torch.full((B, NU), 1.2),
                                None, None, w)
        assert float(uncontrolled[:, :3].abs().max()) < 5.0
    mpc = _mpc(gd, H, auto_scale=False, max_iter=80, hessian=hessian)
    nlp = mpc.nlp

    def cost(Z, U):
        x = Z[..., :NX]
        return (torch.sum(x[..., :3] ** 2, (-1, -2))
                + 0.1 * torch.sum(x[..., 3:] ** 2, (-1, -2))
                + 0.05 * torch.sum((U - 1.2) ** 2, (-1, -2))
                + 5.0 * torch.sum(x[:, -1, :6] ** 2, -1))

    def step64(z, u):
        return gref.lifted_step({k: v.double() for k, v in w.items()}, z, u,
                                NX, features,
                                {k: v.double() for k, v in
                                 _scales(torch.float32).items()})
    carry = None
    for k in range(2):
        x = z0 if carry is None else res.x[:, 0]
        carry, res = mpc.next_batch(x, params=w, carry=carry)
        assert bool(res.converged.all()), res.kkt_error
        assert carry.w.shape[1] == nlp.n == H * (NX + HID + NU)  # no slacks
        defect, stat = _kkt_residuals(
            step64, cost, x, carry.w, carry.lam, carry.zl, carry.zu,
            nlp.lower, nlp.upper, H, NX + HID, NU)
        assert float(defect.max()) <= LIMIT, defect
        assert float(stat.max()) <= LIMIT, stat


def test_fit_fits_the_scaled_function():
    """``_teacher_forced_loss`` of a scaled bundle is the mean over
    sequences and steps of the squared standardised errors, summed over
    the states: the reference's lifted step run on the measured states;
    and ``fit_gru_on_sequences`` lowers it."""
    gd, w, step = _bundle(True)
    g = torch.Generator().manual_seed(9)
    N, Tn = 8, 5
    X = torch.rand((N, Tn + 1, NX), generator=g) * 2.0 - 1.0
    U = torch.rand((N, Tn, NU), generator=g) * 3.0
    h = torch.zeros((N, HID))
    errs = []
    for t in range(Tn):
        nxt = step(torch.cat([X[:, t], h], -1), U[:, t])
        h = nxt[:, NX:]
        errs.append((nxt[:, :NX] - X[:, t + 1]) / gd.out_sd)
    want = torch.mean(torch.sum(torch.stack(errs, 1) ** 2, -1))
    got = trnn._teacher_forced_loss(w, X, U, HID, gd)
    assert float((got - want).abs()) <= 1e-5 * float(want)
    params, loss = T.fit_gru_on_sequences(gd, X, U, steps=30, lr=1e-2)
    assert loss < float(want)


def test_next_batch_cold_plan():
    """``NMPC.next_batch(init_x=, init_u=)``: the cold solve starts from the
    given plan (the same solve as ``cold_start`` of that plan), a warm
    re-plan ignores it, and the plan's shapes are checked and must come
    together."""
    H, B = 5, 3
    gd, w, step = _bundle(True, weight_scale=0.05)
    z0 = gd.lift(_points(B, torch.float32, seed=8)[0][:, :NX] * 0.3)
    X0 = z0[:, None].expand(B, H, NX + HID)
    U0 = torch.tensor([1.2, 1.1, 1.3, 1.2]).expand(B, H, NU)
    mpc = _mpc(gd, H, max_iter=3)
    carry, res = mpc.next_batch(z0, params=w, init_x=X0, init_u=U0)
    rt = mpc._runtime(z0, None, None, w)
    want = mpc._step(mpc.cold_start(z0, X0, U0, params=w), rt)[1]
    assert torch.equal(res.u, want.u) and torch.equal(res.x, want.x)
    roll = mpc.next_batch(z0, params=w)[1]
    assert not torch.equal(roll.u, res.u)
    warm = mpc.next_batch(z0, params=w, carry=carry)[1]
    assert torch.equal(mpc.next_batch(z0, params=w, carry=carry,
                                      init_x=X0, init_u=U0)[1].u, warm.u)
    with pytest.raises(ValueError, match="together"):
        mpc.next_batch(z0, params=w, init_x=X0)
    with pytest.raises(ValueError, match="init_u must be shape"):
        mpc.next_batch(z0, params=w, init_x=X0, init_u=U0[:, :2])
