"""Whether the window's plans are correct.

During the window the harness keeps, for a sample of each re-plan's
members drawn from the seed (the mix's ``check_per_replan``), what that
re-plan was given (the start, the reference path) and what it returned:
the plan w, its multipliers λ, z_l, z_u, its converged flag and KKT
error, and the plan it was warm-started from.  Once the window has closed
and the program's state is freed, the plain reference
(:mod:`benchmark.reference.nlp`) works out every sampled member's
residuals, in blocks, in float64.  Every sampled plan is judged, converged
or not: the fleet applies each member's first control either way.  Each
number compared is held to its limit in the configuration's file
(``check.limits``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import nlp

NUMBERS = ("defect_max", "stationarity_max")


class Samples:
    def __init__(self):
        self.rows: List[dict] = []

    def add(self, idx, x0, tvp, p, carry_in, carry_out, res):
        def pick(t):
            return None if t is None else t[idx].detach().clone()
        self.rows.append({
            "x0": pick(x0), "tvp": pick(tvp), "p": pick(p),
            "w_prev": None if carry_in is None else pick(carry_in.w),
            "w": pick(carry_out.w), "lam": pick(carry_out.lam),
            "zl": pick(carry_out.zl), "zu": pick(carry_out.zu),
            "converged": pick(res.converged),
            "kkt_error": pick(res.kkt_error)})


def _cat(rows, key):
    vals = [r[key] for r in rows]
    return None if vals[0] is None else torch.cat(vals)


def residuals(problem, samples: Samples, block: int = 512) -> dict:
    """Every sampled member's reference residuals (``defect``,
    ``stationarity``) beside its ``converged`` flag and the program's own
    ``kkt_error``, as CPU float64 tensors."""
    out = {k: [] for k in ("converged", "kkt_error", "defect",
                           "stationarity")}
    # warm- and cold-started rows cannot share a block (w_prev)
    groups: Dict[bool, list] = {}
    for r in samples.rows:
        groups.setdefault(r["w_prev"] is None, []).append(r)
    for rows in groups.values():
        cols = {k: _cat(rows, k) for k in rows[0]}
        n = cols["w"].shape[0]
        for s in range(0, n, block):
            sl = {k: None if v is None else v[s: s + block]
                  for k, v in cols.items()}
            res = nlp.residuals(problem, sl["x0"], sl["w"], sl["lam"],
                                sl["zl"], sl["zu"], sl["w_prev"],
                                tvp=sl["tvp"], p=sl["p"])
            out["defect"].append(res["defect"].cpu())
            out["stationarity"].append(res["stationarity"].cpu())
            out["converged"].append(sl["converged"].bool().cpu())
            out["kkt_error"].append(sl["kkt_error"].double().cpu())
    return {k: torch.cat(v) if v else torch.zeros(0, dtype=torch.float64)
            for k, v in out.items()}


def judge(per_member: dict, limits: Dict[str, float]):
    """The numbers compared: the largest defect and stationarity over the
    sampled members.  Returns ``({number: {"value", "limit"}, "compared":
    ...}, ok)``; an empty sample reads as not correct."""
    compared = int(per_member["defect"].numel())
    worst = {}
    for k, col in (("defect_max", "defect"),
                   ("stationarity_max", "stationarity")):
        v = per_member[col]
        worst[k] = float(v.max()) if compared else math.inf
    # a non-finite reading prints as 1e300 (JSON has no infinity)
    checks = {k: {"value": worst[k] if math.isfinite(worst[k]) else 1e300,
                  "limit": float(limits[k])} for k in NUMBERS}
    checks["compared"] = {"value": compared, "limit": 1}
    ok = compared >= 1 and all(worst[k] <= float(limits[k])
                               for k in NUMBERS)
    return checks, ok
