"""The fused push + deposit kernel's share of its roofline: each launch's
bytes from the cell's shapes (``bench/work.fused_launch_bytes``: inputs
read once, outputs written once) at the peak memory rate, over the device
time of its launches (``fused_push_deposit_kernel``, ``fused_block_kernel``)
in the traced stretch."""

KERNELS = ("fused_push_deposit_kernel", "fused_block_kernel")


def read(ctx):
    times = [e - s for s, e, _, name in ctx["trace"]["device"]
             if any(k in name for k in KERNELS)]
    work = ctx.get("work")
    if not times or not work:
        return None
    least_s = (len(times) * work["fused_launch_bytes"]
               / ctx["peaks"].HBM_BYTES_PER_S)
    return 100.0 * least_s / (sum(times) * 1e-6)
