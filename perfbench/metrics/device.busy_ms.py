"""Milliseconds a step in which some device operation runs: the union of
the kernel, copy and set intervals on all streams, over the traced steps."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["device"]:
        return None
    return tr["busy_us"] * 1e-3 / tr["steps"]
