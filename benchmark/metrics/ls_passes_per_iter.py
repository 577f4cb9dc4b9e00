"""``ls_passes_per_iter``: line-search passes (the spans ``sync.ls``, one a
pass) over lockstep iterations (the spans ``ip.iteration``) in the traced
re-plans: passes beyond the first are trial points that were refused."""

from benchmark.metrics._spans import per_iteration


def read(ctx):
    return per_iteration(ctx, "sync.ls")
