"""``replan_p90_ms``: the 90th percentile of every re-plan of the window,
each from its call until ``torch.cuda.synchronize()`` returned (numpy's
linear interpolation)."""

import numpy as np


def read(ctx):
    if not ctx.records:
        return None
    return 1e3 * float(np.percentile([r["dt"] for r in ctx.records], 90))
