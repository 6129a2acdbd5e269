"""Device milliseconds a traced step of the engine's carried-charge work
outside the fused push: the program's ``engine/rho/q<k>`` spans (each
queue's leavers' charge taken off, on the queue's stream) and its
``engine/merge/rho`` span (the arrivals' and births' charge added at the
merge) inside its ``engine/step`` (``bench/spans.py``). Nothing where the
program records no such span."""

import re

from perfbench.bench import spans

RHO = re.compile(r"^engine/(rho/q\d+|merge/rho)$")


def read(ctx):
    names = {r["name"] for r in spans.recorded() or () if RHO.match(r["name"])}
    return spans.device_ms(ctx, names, "engine/step")
