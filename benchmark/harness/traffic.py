"""The one generator of every traffic mix: a fleet controller's closed loop.

A mix is a data file of parameters (``benchmark/traffic/<mix>.json``); the
configuration's file says which states they act on (its ``layout``).  From
``--seed`` alone the generator makes, on the device:

* the starts: each physical state uniform in the configuration's
  ``start_low``/``start_high``; under an ``orbit`` reference the tracked
  states start on the member's path, moved by ``reference.jitter``
  standard normals, and their rates at the path's;
* the references (``reference.kind``): ``none`` (the configuration's own
  target), or ``orbit``, a closed path per member in the plane of the
  first two ``tracked`` states, further tracked states held at a drawn
  ``height``: a centre, radius, speed and phase drawn from the mix's
  ranges.  Re-plan k (k = 0 is the cold solve) gets the path at the
  horizon's times (k + 1 + j)·DT as ``tvp`` (B, H, tracked) and its last
  point as ``p`` (B, tracked);
* the disturbance after re-plan k: ``disturbance.std`` standard normals
  on the ``disturbed`` states;
* the members that the correctness check reads from re-plan k:
  ``check_per_replan`` drawn without replacement.

Each of the four comes from a stream of its own, so one seed gives the same
numbers whatever the window's length.  Every seed gets the same work in
another order: each uniform is one of B evenly spaced quantiles of its
range and each set of standard normals the evenly spaced quantiles of the
normal law, the seed only permuting them over the members (a stratified
draw).  A random draw would give each seed its own extremes, and the
slowest member sets a lockstep re-plan's length.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def _uniform(rng, lo, hi, n: int, k=None):
    """n values of each of the k ranges [lo, hi], the n evenly spaced
    quantiles of each in an order the generator draws; (n,) or (n, k)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    cols = 1 if k is None else k
    q = np.stack([rng.permutation(n) for _ in range(cols)], axis=1)
    out = lo + (hi - lo) * (q + 0.5) / n
    return out[:, 0] if k is None else out


class _Normals:
    """Standard normals of a fixed shape: the evenly spaced quantiles of the
    normal law, in an order the generator draws at every call."""

    def __init__(self, shape):
        n = int(np.prod(shape))
        inv = statistics.NormalDist().inv_cdf
        self.shape = shape
        self.values = np.array([inv((i + 0.5) / n) for i in range(n)])

    def __call__(self, rng):
        return rng.permutation(self.values).reshape(self.shape)


class Traffic:
    def __init__(self, mix: dict, cfg: dict, seed: int, device,
                 lift=None):
        self.mix, self.cfg = mix, cfg
        self.device = torch.device(device)
        self.B = int(mix["batch"])
        self.H, self.DT = int(cfg["H"]), float(cfg["DT"])
        self.lead_in = int(mix.get("lead_in", 0))
        self.trace_replans = int(mix.get("trace_replans", 1))
        if self.trace_replans < 1:
            raise ValueError("trace_replans must be at least 1")
        self.check_per_replan = min(int(mix["check_per_replan"]), self.B)
        self.lay = cfg["layout"]
        self.lift = lift if lift is not None else (lambda x: x)
        ss = np.random.SeedSequence(int(seed) % 2 ** 64)
        s_start, s_dist, s_check = ss.spawn(3)
        self._rng_start = np.random.default_rng(s_start)
        self._rng_dist = np.random.default_rng(s_dist)
        self._rng_check = np.random.default_rng(s_check)
        self.ref = mix.get("reference", {"kind": "none"})
        self._gusts = _Normals((self.B, len(self.lay.get("disturbed", []))))
        self._new_fleet()

    # ---- the fleet: starts and paths ----

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _new_fleet(self):
        rng, B = self._rng_start, self.B
        lo = np.asarray(self.lay["start_low"], np.float64)
        hi = np.asarray(self.lay["start_high"], np.float64)
        x = _uniform(rng, lo, hi, B, lo.size)
        if self.ref["kind"] == "orbit":
            r = self.ref
            self._orbit = {
                "cx": _uniform(rng, *r["center"], B),
                "cy": _uniform(rng, *r["center"], B),
                "radius": _uniform(rng, *r["radius"], B),
                "speed": _uniform(rng, *r["speed"], B),
                "phase": _uniform(rng, 0.0, 2.0 * math.pi, B),
                "height": _uniform(rng, *r["height"], B),
            }
            tr, rates = self.lay["tracked"], self.lay["tracked_rates"]
            pos, vel = self._path(np.zeros(1))
            x[:, tr] = pos[:, 0] + float(self.ref.get("jitter", 0.0)) \
                * _Normals((B, len(tr)))(rng)
            x[:, rates] = vel[:, 0]
        elif self.ref["kind"] != "none":
            raise ValueError(f"unknown reference kind {self.ref['kind']!r}")
        self.x0 = self.lift(self._t(x))

    def _path(self, times):
        """Positions and velocities (B, T, tracked) of every member's path
        at ``times`` (T,) seconds."""
        o = self._orbit
        w = (o["speed"] / o["radius"])[:, None]
        ang = w * times[None, :] + o["phase"][:, None]
        r = o["radius"][:, None]
        n_tr = len(self.lay["tracked"])
        pos = np.empty((self.B, times.size, n_tr))
        vel = np.zeros_like(pos)
        pos[..., 0] = o["cx"][:, None] + r * np.cos(ang)
        pos[..., 1] = o["cy"][:, None] + r * np.sin(ang)
        vel[..., 0] = -r * w * np.sin(ang)
        vel[..., 1] = r * w * np.cos(ang)
        for d in range(2, n_tr):
            pos[..., d] = o["height"][:, None]
        return pos, vel

    # ---- what each re-plan gets ----

    def request(self, k: int):
        """(x0 or None, tvp, p) of re-plan k: x0 only for the cold solve
        (k = 0); tvp and p None without a path."""
        x0 = self.x0 if k == 0 else None
        if self.ref["kind"] != "orbit":
            return x0, None, None
        times = (k + 1 + np.arange(self.H)) * self.DT
        pos, _ = self._path(times)
        tvp = self._t(pos)
        return x0, tvp, tvp[:, -1].contiguous()

    def disturbance(self, k: int):
        """(B, nx) additive disturbance after re-plan k's plant step."""
        dims = self.lay.get("disturbed", [])
        std = float(self.mix.get("disturbance", {}).get("std", 0.0))
        d = np.zeros((self.B, int(self.cfg["x_dim"])), np.float32)
        if dims and std:
            d[:, dims] = std * self._gusts(self._rng_dist)
        return self._t(d)

    def check_members(self, k: int):
        return torch.as_tensor(np.sort(self._rng_check.choice(
            self.B, self.check_per_replan, replace=False)),
            device=self.device)
