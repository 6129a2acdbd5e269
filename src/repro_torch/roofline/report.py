"""Render dryrun_results.json into the roofline table (the port of
``repro.roofline.report``)."""

from __future__ import annotations

import json
import sys


def fmt_row(x: dict) -> str:
    ro = x.get("roofline") or {}
    if not ro:
        return ""
    gb = x.get("bytes_per_chip_est", 0) / 2 ** 30
    br = ro.get("coll_breakdown", {})
    brs = " ".join(f"{k.split('-')[-1][:4]}:{v / 1e6:.0f}M"
                   for k, v in sorted(br.items())) or "-"
    return (f"| {x['arch']} | {x['shape']} | {x['mesh']} | "
            f"{ro['t_compute_s']:.3e} | {ro['t_memory_s']:.3e} | "
            f"{ro['t_collective_s']:.3e} | **{ro['bottleneck']}** | "
            f"{ro.get('useful_flops_ratio', 0):.2f} | {gb:.1f} | "
            f"{'yes' if x.get('fits_80g') else 'NO'} | {brs} |")


HEADER = ("| arch | shape | mesh | t_compute (s) | t_memory (s) | "
          "t_collective (s) | bottleneck | useful | GiB/chip | fits 80G | "
          "collective mix |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def render_rows(rows: list, mesh: str | None = None) -> str:
    """The table of dry-run rows (``run_cell`` / ``run_pic_dryrun``
    dicts), then the skipped cells."""
    out = [HEADER]
    skips = []
    for x in rows:
        if mesh and x["mesh"] != mesh:
            continue
        if x["status"] == "ok":
            r = fmt_row(x)
            if r:
                out.append(r)
        elif x["status"] == "skipped":
            skips.append(f"* {x['arch']} x {x['shape']} ({x['mesh']}): "
                         f"{x['reason']}")
    table = "\n".join(out)
    if skips:
        table += "\n\nSkipped cells:\n" + "\n".join(sorted(set(skips)))
    return table


def render(path: str = "dryrun_results.json", mesh: str | None = None) -> str:
    with open(path) as f:
        return render_rows(json.load(f), mesh)


if __name__ == "__main__":
    print(render(*sys.argv[1:]))
