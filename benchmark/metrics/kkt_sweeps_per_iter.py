"""``kkt_sweeps_per_iter``: KKT sweeps (the spans ``kkt.sweep``, one a δ
level tried) over lockstep iterations (the spans ``ip.iteration``) in the
traced re-plans.  An iteration sweeps once for its step, once more for a
second-order correction, and again for each δ level its batch climbs."""

from benchmark.metrics._spans import per_iteration


def read(ctx):
    return per_iteration(ctx, "kkt.sweep")
