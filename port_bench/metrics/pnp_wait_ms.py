"""The driving thread's wait for PnP's result, mean per batch of the
window, in ms (host clock around the future's `result()`)."""


def read(ctx: dict):
    waits = [r.pnp_wait_s for r in ctx['records'] if r.pnp_wait_s is not None]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
