"""Aggregate the dry-run's JSON records into roofline tables, one a mesh.

Counterpart of ``repro/launch/report.py``: the same columns in the same
order, mem/dev in GiB.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        --dir experiments/dryrun_torch
"""
import argparse
import glob
import json
import os


def load(dirname):
    recs = []
    for fn in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def fmt_ms(s):
    return f"{s*1e3:.2f}"


def table(recs, mesh):
    rows = []
    rows.append("| arch | shape | status | mem/dev GiB | compute ms | "
                "memory ms | collective ms | dominant | useful FLOPs |")
    rows.append("|---|---|---|---|---|---|---|---|---|")
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    for r in sorted([r for r in recs if r["mesh"] == mesh],
                    key=lambda r: (r["arch"], order[r["shape"]])):
        if r["status"] != "OK":
            reason = r.get("reason", r.get("error", ""))[:40]
            rows.append(f"| {r['arch']} | {r['shape']} | {r['status']} "
                        f"({reason}) | | | | | | |")
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | OK "
            f"| {r['memory']['per_device_total']/2**30:.2f} "
            f"| {fmt_ms(t['compute_s'])} | {fmt_ms(t['memory_s'])} "
            f"| {fmt_ms(t['collective_s'])} | {t['dominant']} "
            f"| {t['useful_flops_ratio']:.2f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load(args.dir)
    meshes = sorted({r["mesh"] for r in recs})
    for mesh in ([args.mesh] if args.mesh else meshes):
        print(f"\n### Mesh {mesh}\n")
        print(table(recs, mesh))


if __name__ == "__main__":
    main()
