"""Device milliseconds a traced step of the engine's field phase: the
program's ``engine/field`` span (the halo sum of the shared edge nodes,
the smoother, the float64 Poisson solve with its gathered scalars and E,
over the (D, ncl + 1) slabs of the carried charge) inside its
``engine/step`` (``bench/spans.py``), as ``field.device_ms`` reads the
cycle's."""

from perfbench.bench import spans


def read(ctx):
    return spans.device_ms(ctx, ("engine/field",), "engine/step")
