"""The dry-run's tables and the port's step rooflines, as markdown.

Port of ``repro.analysis.report``: :func:`load_records`,
:func:`dryrun_table` and :func:`dryrun_roofline_table` (the reference's
``roofline_table``) read the records of ``launch/dryrun.py``
(``experiments/dryrun_torch/*.json``), as the reference's read its
dry-run's; :func:`roofline_table` reads the step reports
``chip_smoke.py`` writes (phase 12: one ``roofline.RooflineReport`` a
step, as a dict).

    PYTHONPATH=src python -m repro_torch.analysis.report \
        [--dir experiments/dryrun_torch | --json chiprun_out/chip_smoke.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["SHAPE_ORDER", "load_records", "fmt_bytes", "fmt_s",
           "dryrun_table", "dryrun_roofline_table", "roofline_table",
           "main"]

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(d: str) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


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


def dryrun_table(recs: list[dict]) -> str:
    """One row a dry-run record: status, peak and argument GiB a device,
    the counted operations and collective bytes a device."""
    lines = [
        "| arch | shape | mesh | status | peak GiB/dev | arg GiB/dev | "
        "HLO flops/dev | wire GB/dev | compile s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"],
                                         SHAPE_ORDER.index(r["shape"]),
                                         r["mesh"])):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"SKIP: {r['reason']} | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"**FAILED** | — | — | — | — | — |")
            continue
        ma, ro = r["memory_analysis"], r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_bytes(ma['peak_memory_in_bytes'])} | "
            f"{fmt_bytes(ma['argument_size_in_bytes'])} | "
            f"{ro['flops_per_device']:.2e} | "
            f"{ro['wire_bytes_per_device'] / 1e9:.1f} | "
            f"{r.get('compile_s', 0):.0f} |")
    return "\n".join(lines)


def dryrun_roofline_table(recs: list[dict]) -> str:
    """The single-pod (16x16) records' three terms, one row a cell."""
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck |"
        " MODEL_FLOPS | useful/HLO | roofline frac | what moves the "
        "dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"],
                                         SHAPE_ORDER.index(r["shape"]))):
        if r["status"] != "ok" or r["mesh"] != "16x16":
            continue
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['t_compute'])} | "
            f"{fmt_s(ro['t_memory'])} | {fmt_s(ro['t_collective'])} | "
            f"**{ro['bottleneck']}** | {ro['model_flops_total']:.2e} | "
            f"{ro['useful_flops_ratio']:.2f} | "
            f"{ro['roofline_fraction']:.3f} | {_dryrun_hint(ro)} |")
    return "\n".join(lines)


def _dryrun_hint(ro: dict) -> str:
    b = ro["bottleneck"]
    if b == "memory":
        return ("fuse the eager ops / drop f32 and f64 materializations; "
                "remat policy")
    if b == "collective":
        kinds = ro.get("collective_breakdown", {})
        top = max(kinds, key=kinds.get) if kinds else "?"
        return f"dominant {top}: reshard to cut hops / overlap with compute"
    return "increase per-chip arithmetic intensity (int8 datapath: 2x peak)"


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
    ap.add_argument("--dir", default=None,
                    help="a directory of dry-run records "
                         "(experiments/dryrun_torch)")
    ap.add_argument("--json", default="chiprun_out/chip_smoke.json",
                    help="a JSON file holding a 'roofline' list")
    args = ap.parse_args(argv)
    if args.dir is not None:
        recs = load_records(args.dir)
        ok = [r for r in recs if r["status"] == "ok"]
        skip = [r for r in recs if r["status"] == "skipped"]
        fail = [r for r in recs if r["status"] not in ("ok", "skipped")]
        print(f"<!-- generated by repro_torch.analysis.report: {len(ok)} "
              f"ok, {len(skip)} skipped, {len(fail)} failed -->\n")
        print("### Dry-run records\n")
        print(dryrun_table(recs))
        print("\n### Roofline (single-pod 16x16, per-device terms)\n")
        print(dryrun_roofline_table(recs))
        return 0
    with open(args.json) as f:
        reports = json.load(f).get("roofline", [])
    print(roofline_table(reports))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
