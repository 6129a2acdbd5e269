"""Device operations (kernels, copies, sets) a step in the traced
stretch."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["device"]:
        return None
    return len(tr["device"]) / tr["steps"]
