"""The refinement's time per step, in ms: CUDA events around each
batch's steps, summed over the window's batches, over its steps."""


def read(ctx: dict):
    records = ctx['records']
    steps = ctx['setup'].niter * len(records)
    if not steps:
        return None
    return sum(r.refine_ms for r in records) / steps
