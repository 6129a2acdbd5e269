"""Device milliseconds a traced step of the cycle's secondary electron
emission: the program's ``cycle/see`` span (the candidates' draws, the
free slots, the secondaries' scatter and their charge deposit) inside its
``cycle/step`` (``bench/spans.py``)."""

from perfbench.bench import spans


def read(ctx):
    return spans.device_ms(ctx, ("cycle/see",), "cycle/step")
