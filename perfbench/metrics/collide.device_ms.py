"""Device milliseconds a traced step of the cycle's collide phase: the
program's ``cycle/collide`` span (the collision densities, pairing and
scattering of the menu) inside its ``cycle/step`` (``bench/spans.py``)."""

from perfbench.bench import spans


def read(ctx):
    return spans.device_ms(ctx, ("cycle/collide",), "cycle/step")
