"""The program's own spans of the traced stretch, for the per-layer
metrics that read them: ``repro_torch.obs.tracing.spans()`` (each span's
name, parent, step and ``device_ms``, the time between CUDA events the
program records on its stream at the span's entry and exit), imported
inside the call as ``program.py`` imports the program. A program without
that recorder gives nothing."""

from __future__ import annotations


def recorded() -> list[dict] | None:
    """The program's recorded spans, or None where it records none."""
    from repro_torch.obs import tracing

    spans = getattr(tracing, "spans", None)
    return None if spans is None else spans()


def device_ms(ctx: dict, names, root: str) -> float | None:
    """Device ms a traced step of the spans named ``names``: their
    ``device_ms`` summed over the last ``ctx["trace"]["steps"]`` steps
    whose root span is ``root``, over those steps. None where no such
    span was recorded or one has no device time."""
    recs = recorded()
    if not recs:
        return None
    steps = set([r["index"] for r in recs
                 if r["name"] == root and r["parent"] is None]
                [-ctx["trace"]["steps"]:])
    vals = [r["device_ms"] for r in recs
            if r["step"] in steps and r["name"] in names]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(steps)
