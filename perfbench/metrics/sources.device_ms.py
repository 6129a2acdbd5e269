"""Device milliseconds a traced step of the cycle's MC sources: the
program's ``cycle/ionize`` (events, kills, the births' scatter) and
``cycle/see`` spans inside its ``cycle/step`` (``bench/spans.py``)."""

from perfbench.bench import spans


def read(ctx):
    return spans.device_ms(ctx, ("cycle/ionize", "cycle/see"), "cycle/step")
