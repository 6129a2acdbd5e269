"""The device's idle share of the traced stretch: 100 x (1 - the union of
the kernel, copy and set intervals on all streams over the stretch)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["device"] or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
