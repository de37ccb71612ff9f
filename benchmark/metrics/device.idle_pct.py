"""The card's idle share of the traced window, in %: 100 less the union
of the device operations' intervals over the window."""


def read(ctx):
    t0, t1 = ctx["window_ns"]
    if not ctx["device_spans"] or t1 <= t0:
        return None
    return 100.0 * (1.0 - ctx["device"].busy_s(ctx["device_spans"])
                    / ((t1 - t0) / 1e9))
