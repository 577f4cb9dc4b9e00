"""Horizon (sequence-parallel) sharding of the Riccati sweep.

PyTorch counterpart of ``pyneuralempc_tpu/parallel/horizon.py``.  The
parallel-in-time formulation (:mod:`..solve.pscan`) makes the backward
pass a composition of linear-fractional value-map elements, and
compositions split cleanly over S horizon shards:

  1. each shard runs a local suffix scan of its H/S stages on its own
     device;
  2. the S shard totals (one element each: nx² + 3·nx floats a problem)
     are gathered to every shard of the row, by copying them between
     devices (the counterpart of ``all_gather``);
  3. each shard folds the later shards' totals, in increasing time order,
     into a boundary value (P_b, p_b) at its right edge;
  4. each shard applies its local suffix elements to that boundary value;

and the forward pass likewise with affine prefix maps.  What moves between
devices is O(S · nx²) a problem whatever H is; the batch axis shards over
``scenario`` with no communication at all.

The JAX package runs this as one ``shard_map`` program over a 2-D
``(scenario, horizon)`` mesh.  The port runs it in one process over a
:class:`~.sharding.Mesh` of ``torch.device``s, one shard after another;
each shard's blocks stay on its device, and only the results are
assembled, on the inputs' device, because the port's solver is
batch-first on one device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.scan import associative_scan
from ..solve.pscan import (affine_compose, canonical_elems, compose, gains,
                           riccati_sweep_pscan, with_delta)
from .sharding import Mesh, mesh_devices

__all__ = ["make_horizon_mesh", "make_sharded_sweep", "horizon_sweep"]


def make_horizon_mesh(n_scenario: int, n_horizon: int,
                      devices=None) -> Mesh:
    """(scenario, horizon) mesh over the first n_scenario·n_horizon of
    ``devices`` (the CUDA devices when None; a list may repeat a
    device)."""
    devs = mesh_devices(n_scenario * n_horizon, devices)
    return Mesh(np.asarray(devs, dtype=object).reshape(n_scenario,
                                                        n_horizon),
                ("scenario", "horizon"))


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _apply_elem(e, Pv, pv):
    """Apply a value-map element to (P, p)."""
    A, b, C, eta, J = e
    nx = A.shape[-1]
    eye = torch.eye(nx, dtype=A.dtype, device=A.device)
    # P (I + C P)⁻¹ == (I + P C)⁻¹ P: solve with (I + P C), one LU for both
    # right-hand sides
    sol, info = torch.linalg.solve_ex(
        eye + Pv @ C, torch.cat([Pv @ A, (pv + _mv(Pv, b)).unsqueeze(-1)],
                                -1))
    sol = torch.where((info == 0)[..., None, None], sol, torch.nan)
    return J + A.mT @ sol[..., :nx], eta + _mv(A.mT, sol[..., nx])


def _identity_elem(nx, dtype, batch_shape=(), device=None):
    eye = torch.eye(nx, dtype=dtype, device=device).expand(
        batch_shape + (nx, nx))
    Z = torch.zeros(batch_shape + (nx, nx), dtype=dtype, device=device)
    z = torch.zeros(batch_shape + (nx,), dtype=dtype, device=device)
    return (eye, z, Z, z, Z)


def make_sharded_sweep(mesh: Mesh) -> Callable:
    """Build ``sweep(A, B, G, M, mx, mu, c, delta)`` for batched inputs
    (B, H, ...) with B split over ``scenario`` and H over ``horizon``.

    Returns (dX, dU, dLam, ok) on the inputs' device; matches
    :func:`..solve.pscan.riccati_sweep_pscan` to f32 tolerance.  Raises
    ``ValueError`` unless B divides by the scenario axis and H by the
    horizon one.
    """
    grid = mesh.devices
    n_scen, n_hor = mesh.shape["scenario"], mesh.shape["horizon"]

    def row(devs, A, B_, G, M, mx, mu, c, delta):
        """One scenario row's problems over its ``n_hor`` shards."""
        Bn, H, nx = c.shape
        h = H // n_hor
        home = c.device
        shards = []
        # (1) local suffix scans, each shard on its device
        for j, d in enumerate(devs):
            a = [t[:, j * h:(j + 1) * h].to(d)
                 for t in (A, B_, G, M, mx, mu, c)]
            dl = delta.to(d)
            elems, stage, ok = canonical_elems(*a, dl)
            suffix = associative_scan(lambda x, y: compose(y, x), elems,
                                      dim=1, reverse=True)
            shards.append(dict(dev=d, a=a, dl=dl, stage=stage, ok=ok,
                               suffix=suffix,
                               total=tuple(t[:, 0] for t in suffix)))
        # (2)-(4) gather the totals, fold the later shards' into the
        # boundary value, apply the local suffix to it; then the gains and
        # the local affine prefix scan
        for j, s in enumerate(shards):
            d = s["dev"]
            later = _identity_elem(nx, c.dtype, (Bn,), d)
            for i in range(j + 1, n_hor):
                later = compose(later, tuple(t.to(d) for t in
                                              shards[i]["total"]))
            Pb, pb = later[4], later[3]          # J, η of the composite
            P_loc, p_loc = _apply_elem(s["suffix"], Pb[:, None],
                                       pb[:, None])
            P_next = torch.cat([P_loc[:, 1:], Pb[:, None]], 1)
            p_next = torch.cat([p_loc[:, 1:], pb[:, None]], 1)
            A_, Bm, _, _, _, _, c_ = s["a"]
            K, k, ok_g = gains(*s["stage"], A_, Bm, c_, P_next, p_next)
            Fp, vp = associative_scan(
                affine_compose, (A_ + Bm @ K, _mv(Bm, k) + c_), dim=1)
            s.update(K=K, k=k, P_next=P_next, p_next=p_next, Fp=Fp, vp=vp,
                     ok=s["ok"] & ok_g)
        # forward: the Δx at each shard's left edge from the earlier
        # shards' totals, composed in increasing time order
        outs, oks = [], []
        for j, s in enumerate(shards):
            d = s["dev"]
            acc = (torch.eye(nx, dtype=c.dtype, device=d).expand(Bn, nx, nx),
                   torch.zeros((Bn, nx), dtype=c.dtype, device=d))
            for i in range(j):
                acc = affine_compose(acc, (shards[i]["Fp"][:, -1].to(d),
                                           shards[i]["vp"][:, -1].to(d)))
            dx_left = acc[1]
            dX = _mv(s["Fp"], dx_left[:, None]) + s["vp"]
            dx_prev = torch.cat([dx_left[:, None], dX[:, :-1]], 1)
            dU = _mv(s["K"], dx_prev) + s["k"]
            Md = with_delta(s["a"][3], s["dl"])
            dLam = (_mv(s["P_next"] + Md[..., :nx, :nx], dX)
                    + _mv(Md[..., :nx, nx:], dU) + s["p_next"] + s["a"][4])
            oks.append((s["ok"] & torch.isfinite(dX).all(dim=(1, 2))
                        & torch.isfinite(dU).all(dim=(1, 2))).to(home))
            outs.append(tuple(t.to(home) for t in (dX, dU, dLam)))
        # one flag a problem: the AND over the horizon shards
        return (tuple(torch.cat(parts, 1) for parts in zip(*outs))
                + (torch.stack(oks).all(0),))

    def sweep(A, B_, G, M, mx, mu, c, delta):
        Bn, H = c.shape[:2]
        if Bn % n_scen or H % n_hor:
            raise ValueError(f"batch {Bn} and horizon {H} must divide by "
                             f"the mesh's {mesh.shape}")
        b = Bn // n_scen
        rows = [row(grid[r], *(t[r * b:(r + 1) * b] for t in
                               (A, B_, G, M, mx, mu, c, delta)))
                for r in range(n_scen)]
        return tuple(torch.cat(parts, 0) for parts in zip(*rows))

    return sweep


def horizon_sweep(mesh: Mesh) -> Callable:
    """Sweep that makes the whole interior-point solve sequence-parallel:
    pass it as ``sweep_impl`` to
    :func:`~pyneuralempc_tpu_torch.solve.riccati.make_riccati_direction`
    (or use ``NMPC(..., mesh=mesh)``).  Batched solves (``next_batch``)
    run every IP iteration's sweep split across the mesh; a single problem
    (``NMPC.next`` and ``NMPC.step``) takes the sweep's ``unbatched``
    attribute, the single-device parallel-in-time scan, as the JAX
    package's unbatched rule does.

    Requires the batch divisible by ``mesh.shape['scenario']`` and H by
    ``mesh.shape['horizon']``.
    """
    sweep = make_sharded_sweep(mesh)
    sweep.unbatched = riccati_sweep_pscan
    return sweep
