"""The dry-run and roofline tables of the port, from the records
``launch/dryrun.py`` and ``launch/roofline.py`` write (``repro/launch/
report.py``'s analogue; re-run after any refresh):

    PYTHONPATH=src python -m repro_torch.launch.report > experiments/report_h100.md

The same two tables as the reference's, read from the port's files; the
dry run's "trace s" stands where the reference has "compile s", and its
FLOPs are those of the traced aten ops (there is no HLO).  Reads files
only: no device is touched.
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os

GB = 1e9
DRYRUN_DIR = "experiments/dryrun_h100"
ROOFLINE_CSV = "experiments/roofline_h100.csv"


def dryrun_table(dryrun_dir: str = DRYRUN_DIR) -> str:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        mem = d.get("memory_analysis", {})
        cost = d.get("cost_analysis", {})
        colls = d.get("collectives", {})
        rows.append({
            "arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
            "devices": d.get("n_devices", ""),
            "ok": "✓" if d.get("ok") else "✗",
            "trace_s": d.get("trace_s", ""),
            "args_gb": round(mem.get("argument_size_in_bytes", 0) / GB, 2),
            "temp_gb": round(mem.get("temp_size_in_bytes", 0) / GB, 2),
            "flops_raw": f"{cost.get('flops', 0):.2e}",
            "coll_gb": round(colls.get("total_bytes", 0) / GB, 2),
            "coll_ops": "/".join(sorted(colls.get("per_op", {}))),
        })
    hdr = ("| arch | shape | mesh | devs | ok | trace s | args GB/dev | "
           "temp GB/dev | traced flops (raw) | coll GB | collective ops |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['devices']} "
            f"| {r['ok']} | {r['trace_s']} | {r['args_gb']} "
            f"| {r['temp_gb']} | {r['flops_raw']} | {r['coll_gb']} "
            f"| {r['coll_ops']} |")
    return "\n".join(lines)


def roofline_table(csv_path: str = ROOFLINE_CSV) -> str:
    if not os.path.exists(csv_path):
        return f"({os.path.basename(csv_path)} not yet generated)"
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL_FLOPS | useful ratio | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if not r.get("compute_s"):
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
            continue
        f = lambda k: f"{float(r[k]):.4g}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {f('compute_s')} "
            f"| {f('memory_s')} | {f('collective_s')} | {r['dominant']} "
            f"| {float(r['model_flops_total']):.3e} "
            f"| {f('useful_flops_ratio')} | {f('roofline_fraction')} |")
    return "\n".join(lines)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    print("## Dry-run matrix (H100 port, fake world)\n")
    print(dryrun_table())
    print("\n## Roofline table (single-pod, per card, published H100 peaks)\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
