"""The device's idle share of the traced window, in percent: one minus
the union of the device operations' intervals over the window."""


def read(ctx: dict):
    tracer = ctx['tracer']
    if not tracer.window_s:
        return None
    return 100.0 * (1.0 - tracer.busy_s() / tracer.window_s)
