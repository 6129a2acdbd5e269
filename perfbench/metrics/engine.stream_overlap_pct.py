"""The share of the device's busy time in which operations of two or more
streams run at once: the overlap of the engine's (domain, queue) streams,
the paper's async(n)."""


def read(ctx):
    tr = ctx["trace"]
    if tr["busy_us"] <= 0:
        return None
    return 100.0 * tr["overlap_us"] / tr["busy_us"]
