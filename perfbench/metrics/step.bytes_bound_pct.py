"""The whole step's share of the card's memory bandwidth: the least bytes
the step's work needs (``bench/work.step_bytes``, from the cell's shapes
and the counts the traced steps report) at the peak rate, over the same
run's untraced milliseconds a step."""


def read(ctx):
    work = ctx.get("work")
    if not work or not work["step_bytes"] or not ctx["trace"]["device"]:
        return None
    least_s = work["step_bytes"] / ctx["peaks"].HBM_BYTES_PER_S
    return 100.0 * least_s / (ctx["step_ms"] * 1e-3)
