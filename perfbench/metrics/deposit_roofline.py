"""The standalone CIC deposit kernel's share of its roofline: the least
bytes of the traced steps' deposits at the peak memory rate, over the
device time of the kernel's launches (``deposit_kernel``,
``deposit_block_kernel``) in the traced stretch.

The least bytes follow the rows that carry charge, from the step's event
counters (``work["deposit_rows"]`` a step: the secondaries that landed),
and not the candidate rows the program passes: x and q of each charged row
read once, and each node written once a launch. So the metric reads the
same work whatever implements it."""

from perfbench.bench import work as least

KERNELS = ("deposit_kernel", "deposit_block_kernel")
# x and q of a charged row, read once
ROW = 8


def kernel_name(name: str) -> str:
    """The bare function name of a device event's name: no return type,
    namespace, template arguments or argument list."""
    bare = name.replace("(anonymous namespace)::", "")
    bare = bare.split("(", 1)[0].split("<", 1)[0].strip()
    return bare.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def read(ctx):
    times = [e - s for s, e, _, name in ctx["trace"]["device"]
             if kernel_name(name) in KERNELS]
    work = ctx.get("work")
    if not times or not work or "deposit_rows" not in work:
        return None
    bytes_ = (ROW * work["deposit_rows"] * ctx["trace"]["steps"]
              + least.NODE * work["deposit_nodes"] * len(times))
    least_s = bytes_ / ctx["peaks"].HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(times) * 1e-6)
