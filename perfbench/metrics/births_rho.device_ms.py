"""Device milliseconds a traced step of the births' charge deposited into
the cycle's carried charge density: the program's ``cycle/ionize/rho``
span (the births' weights and one deposit of both halves of every born
pair) inside its ``cycle/step`` (``bench/spans.py``). Nothing where the
program records no such span: a step that carries no rho, or a program
without the span."""

from perfbench.bench import spans


def read(ctx):
    return spans.device_ms(ctx, ("cycle/ionize/rho",), "cycle/step")
