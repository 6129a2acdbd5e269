"""Device milliseconds a traced step of the cycle's field phase: the
program's ``cycle/field`` span (the smoother, the float64 Poisson solve
and E from the carried charge density) inside its ``cycle/step``
(``bench/spans.py``)."""

from perfbench.bench import spans


def read(ctx):
    return spans.device_ms(ctx, ("cycle/field",), "cycle/step")
