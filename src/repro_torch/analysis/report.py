"""The roofline table of the port's step reports, as markdown.

Port of ``repro.analysis.report``: :func:`roofline_table` and the
formatting helpers.  The reference's ``dryrun_table`` reads the dry-run
records of ``launch/dryrun.py``, which the port does not have yet
(ROADMAP Queue 1 item 13); it comes with them.

    PYTHONPATH=src python -m repro_torch.analysis.report \
        [--json chiprun_out/chip_smoke.json]

reads the ``"roofline"`` list ``chip_smoke.py`` writes (phase 12: one
report a step, each a ``roofline.RooflineReport`` as a dict).
"""

from __future__ import annotations

import argparse
import json

__all__ = ["fmt_bytes", "fmt_s", "roofline_table", "main"]


def fmt_bytes(b: float) -> str:
    """GiB, two decimals."""
    return f"{b / 2 ** 30:.2f}"


def fmt_s(x: float | None) -> str:
    if x is None:
        return "not measured"
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def _hint(r: dict) -> str:
    """What moves the dominant term."""
    b = r["bottleneck"]
    if b == "memory":
        return ("move fewer bytes: fuse the eager ops, keep weights and "
                "activations in fewer bits")
    if b == "collective":
        return "gather less per step: keep activations sharded longer"
    return "more operations a byte: the int8 tensor cores (2x bf16)"


def roofline_table(reports: list[dict]) -> str:
    """One row a step report: the three terms, the bottleneck, the
    measured time and the bound's share of it."""
    lines = [
        "| arch | shape | mesh | t_compute | t_memory | t_collective | "
        "bottleneck | measured | bound/measured | MODEL_FLOPS | "
        "useful/counted | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in reports:
        share = f"{r['bound_share']:.3f}" if r.get("measured_s") \
            else "not measured"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_s(r['t_compute'])} | {fmt_s(r['t_memory'])} | "
            f"{fmt_s(r['t_collective'])} | **{r['bottleneck']}** | "
            f"{fmt_s(r.get('measured_s'))} | {share} | "
            f"{r['model_flops_total']:.2e} | "
            f"{r['useful_flops_ratio']:.3f} | {_hint(r)} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="chiprun_out/chip_smoke.json",
                    help="a JSON file holding a 'roofline' list")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        reports = json.load(f).get("roofline", [])
    print(roofline_table(reports))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
