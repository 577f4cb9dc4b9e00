"""Riccati KKT backend: the port's stage blocks and one whole Newton
direction against the JAX package's ``make_riccati_direction`` on the LV-MLP
problem, at the same (w, λ, rt, Σ, r̃, c)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.solve.riccati import \
    make_riccati_direction as j_direction
from pyneuralempc_tpu_torch.solve.riccati import (eligible,
                                                  make_riccati_direction)

from _torch_lv import glorot_params, jax_mpc, jax_params, torch_mpc
import _torch_threads  # noqa: F401  (one torch thread)

H = 8
BLOCK_ATOL = 1e-5
DIR_RTOL = 1e-4


def _point(nlp, seed):
    """A strictly interior, mildly infeasible iterate with its barrier
    terms, as numpy float32."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(nlp.lower)
    hi = np.asarray(nlp.upper)
    w = rng.uniform(lo + 0.05, hi - 0.05).astype(np.float32)
    lam = rng.normal(0, 0.3, nlp.m).astype(np.float32)
    mu = 0.01
    Sigma = (mu / (w - lo) ** 2 + mu / (hi - w) ** 2).astype(np.float32)
    r_tilde = rng.normal(0, 1, nlp.n).astype(np.float32)
    c = rng.normal(0, 0.05, nlp.m).astype(np.float32)
    x0 = np.asarray([0.5, -0.6], np.float32)
    return x0, w, lam, Sigma, r_tilde, c


@pytest.fixture(scope="module")
def setup():
    np_params = glorot_params(4)
    jm, tm = jax_mpc(H), torch_mpc(H)
    jd = j_direction(jm.nlp, jm.config)
    td = make_riccati_direction(tm.nlp, tm.config)
    return np_params, jm, tm, jd, td


def _rts(np_params, x0, s_obj):
    jrt = J.runtime(jnp.asarray(x0), params=jax_params(np_params))
    jrt["_s_obj"] = jnp.asarray(s_obj, jnp.float32)
    trt = T.runtime(torch.as_tensor(x0)[None],
                    params=T.mlp_params_from_numpy(np_params, device="cpu"))
    trt["_s_obj"] = torch.tensor([s_obj], dtype=torch.float32)
    return jrt, trt


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_blocks_match_jax(setup, seed):
    np_params, jm, tm, jd, td = setup
    assert eligible(tm.nlp) and tm.kkt_backend == jm.kkt_backend
    x0, w, lam, *_ = _point(jm.nlp, seed)
    jrt, trt = _rts(np_params, x0, 0.7)
    jA, jB, jG, jM, _, _ = jd.prepare(jnp.asarray(w), jnp.asarray(lam), jrt)
    tA, tB, tG, tM, tJg, tJq = td.prepare(torch.as_tensor(w)[None],
                                          torch.as_tensor(lam)[None], trt)
    assert tJg == () and tJq == ()     # no path constraints
    for j, t in ((jA, tA), (jB, tB), (jG, tG), (jM, tM)):
        assert t.shape[1:] == j.shape and t.is_contiguous()
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j),
                                   atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_direction_matches_jax(setup, seed):
    np_params, jm, tm, jd, td = setup
    x0, w, lam, Sigma, r_tilde, c = _point(jm.nlp, seed)
    jrt, trt = _rts(np_params, x0, 1.0)
    jdw, jdlam, jok, _ = jd(*(jnp.asarray(a) for a in (w, lam)), jrt,
                            *(jnp.asarray(a) for a in (Sigma, r_tilde, c)))
    tdw, tdlam, tok, resolve = td(
        *(torch.as_tensor(a)[None] for a in (w, lam)), trt,
        *(torch.as_tensor(a)[None] for a in (Sigma, r_tilde, c)))
    assert bool(jok) and bool(tok[0])
    for j, t in ((jdw, tdw), (jdlam, tdlam)):
        j = np.asarray(j)
        err = np.abs(t[0].numpy() - j).max() / max(np.abs(j).max(), 1.0)
        assert err <= DIR_RTOL
    # resolve reuses the blocks: the same rhs gives the same direction
    rdw, rdlam, rok = resolve(torch.as_tensor(r_tilde)[None],
                              torch.as_tensor(c)[None])
    assert torch.equal(rdw, tdw) and torch.equal(rdlam, tdlam)


def test_delta_ladder_is_per_problem(setup):
    """A member whose sweep fails at δ=0 is re-swept up the ladder while a
    healthy member of the same batch keeps its δ=0 direction."""
    np_params, jm, tm, jd, td = setup
    pts = [_point(jm.nlp, s) for s in (0, 1)]
    w, lam, Sigma, r, c = (torch.as_tensor(np.stack([p[i] for p in pts]))
                           for i in range(1, 6))
    trt = T.runtime(torch.as_tensor(np.stack([p[0] for p in pts])),
                    params=T.mlp_params_from_numpy(np_params, device="cpu"))
    trt["_s_obj"] = torch.ones(2)
    blocks = td.prepare(w, lam, trt)
    dw0, dl0, ok0 = td.solve_blocks(blocks, Sigma, r, c)
    # make member 1 genuinely indefinite in u at one stage: fails at δ=0
    A, Bm, G, M0 = (b.clone() for b in blocks[:4])
    M0[1, 3, 2, 2] = -0.5
    bad = (A, Bm, G, M0) + blocks[4:]
    dw1, dl1, ok1 = td.solve_blocks(bad, Sigma, r, c)
    dwn, _, okn = td.solve_blocks(bad, Sigma, r, c, retry=False)
    assert bool(ok0.all()) and bool(ok1.all())
    assert okn.tolist() == [True, False]
    assert torch.equal(dw1[0], dw0[0])
    assert not torch.equal(dw1[1], dw0[1])
