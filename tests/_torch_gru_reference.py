"""Plain reference of the lifted GRU surrogate, for the tests of the port's
quadrotor GRU path: the GRU cell, the lifted step z = [x, h] with an
optional feature map and standardising scales, a trajectory's defects, and
the stage blocks that the Riccati backend derives (A, B and the
λ-weighted defect Hessian G) by ``torch.autograd.functional``.

Plain ``torch`` only: it imports neither the port
(``pyneuralempc_tpu_torch``) nor JAX, and keeps float32 matmuls out of
TF32, so that a float32 comparison reads the same on a card as here.
Every function takes tensors of any float dtype.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gru_cell(w, h, inp):
    """One GRU update, h_new = (1 − z)·h + z·h̃, over the last axis:
    ``w`` holds wz, wr, wh ((in + hidden, hidden)) and bz, br, bh."""
    hx = torch.cat([inp, h], dim=-1)
    z = torch.sigmoid(hx @ w["wz"] + w["bz"])
    r = torch.sigmoid(hx @ w["wr"] + w["br"])
    h_tilde = torch.tanh(torch.cat([inp, r * h], dim=-1) @ w["wh"]
                         + w["bh"])
    return (1.0 - z) * h + z * h_tilde


def lifted_step(w, z, u, x_dim, features=None, scales=None):
    """z_{t+1} from z_t = [x_t, h_t] (…, x_dim + hidden) and u_t:
    h_{t+1} = GRU(h_t, ([features(x_t) | u_t] − in_mu) / in_sd),
    x_{t+1} = x_t + (W_o h_{t+1} + b_o)·out_sd + out_mu; without
    ``features`` the GRU reads x_t, without ``scales`` (a dict of in_mu,
    in_sd, out_mu, out_sd) nothing is standardised."""
    x, h = z[..., :x_dim], z[..., x_dim:]
    inp = torch.cat([x if features is None else features(x), u], dim=-1)
    if scales is not None:
        inp = (inp - scales["in_mu"]) / scales["in_sd"]
    h_new = gru_cell(w, h, inp)
    dx = h_new @ w["wo"] + w["bo"]
    if scales is not None:
        dx = dx * scales["out_sd"] + scales["out_mu"]
    return torch.cat([x + dx, h_new], dim=-1)


def defects(step, z0, Z, U):
    """c_t = step(z_{t-1}, u_t) − z_t for t = 1..H: z0 (N, nz), Z (N, H,
    nz), U (N, H, nu) -> (N, H, nz)."""
    prev = torch.cat([z0[:, None], Z[:, :-1]], dim=1)
    nz, nu = Z.shape[-1], U.shape[-1]
    nxt = step(prev.reshape(-1, nz), U.reshape(-1, nu))
    return nxt.reshape(Z.shape) - Z


def stage_blocks(step, z, u, lam):
    """One stage's A = ∂step/∂z, B = ∂step/∂u and G = ∇²_{(z, u)} λᵀstep,
    each by ``torch.autograd.functional`` on the unbatched z (nz,), u (nu,)
    and λ (nz,)."""
    nz = z.shape[0]

    def f(zu):
        return step(zu[None, :nz], zu[None, nz:])[0]

    zu = torch.cat([z, u])
    J = torch.autograd.functional.jacobian(f, zu)
    G = torch.autograd.functional.hessian(lambda v: (lam * f(v)).sum(), zu)
    return J[:, :nz], J[:, nz:], G
