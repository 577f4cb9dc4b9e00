"""``setup_s``: from the harness's first line to the first timed re-plan:
imports, builds, the model, the cold solve and the lead-in re-plans."""


def read(ctx):
    return ctx.setup_s
