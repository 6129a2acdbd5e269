"""The share of the traced engine steps that replayed the step's CUDA
graph: of the program's last ``engine/step`` spans of the traced stretch
(``bench/spans.py``), those holding an ``engine/graph/replay`` span.
Nothing where the program records no span, names no such span among its
own (``obs.tracing.PORT_ONLY_SPANS``: a program that replays no graph),
or the stretch holds no engine step."""

from perfbench.bench import spans

REPLAY = "engine/graph/replay"


def read(ctx):
    from repro_torch.obs import tracing

    if REPLAY not in getattr(tracing, "PORT_ONLY_SPANS", ()):
        return None
    recs = spans.recorded()
    if not recs:
        return None
    steps = [r["index"] for r in recs
             if r["name"] == "engine/step" and r["parent"] is None]
    steps = steps[-ctx["trace"]["steps"]:]
    if not steps:
        return None
    held = {r["parent"] for r in recs if r["name"] == REPLAY}
    return 100.0 * sum(s in held for s in steps) / len(steps)
