"""Turn dry-run JSONL results into the EXPERIMENTS.md roofline tables.

Usage: PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_single.jsonl
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List


def load(path: Path) -> List[Dict]:
    rows = []
    seen = {}
    for line in Path(path).read_text().splitlines():
        try:
            r = json.loads(line)
        except Exception:
            continue
        seen[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    return list(seen.values())


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | mesh | compute | memory | collective | dominant | "
        "useful ratio | roofline frac | HBM est | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "skipped":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"skipped | — | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAILED | | | | | | | |"
            )
            continue
        rf = r["roofline"]
        me = r.get("memory_est", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} | "
            f"{fmt_s(rf['collective_s'])} | {rf['dominant']} | "
            f"{rf['useful_ratio']:.3f} | {rf['roofline_fraction']:.4f} | "
            f"{me.get('hbm_fraction', float('nan')):.2f} | "
            f"{'yes' if me.get('fits_hbm') else 'NO'} |"
        )
    return "\n".join(out)


def pick_hillclimb(rows: List[Dict]) -> Dict[str, Dict]:
    ok = [r for r in rows if r["status"] == "ok" and r["shape"] != "long_500k"]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"])
    # most representative of the paper's technique: the training shape whose
    # persistence/step overlap matters most = largest model train cell
    train = [r for r in ok if r["shape"] == "train_4k"]
    rep = max(train, key=lambda r: r["roofline"]["model_flops_global"])
    return {"worst_fraction": worst, "most_collective_bound": coll, "representative": rep}


def main() -> None:
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("results/dryrun_single.jsonl")
    rows = load(path)
    print(f"## Roofline table ({path.name}, {len(rows)} cells)\n")
    print(roofline_table(rows))
    ok = [r for r in rows if r["status"] == "ok"]
    if ok:
        print("\n### Hillclimb candidates\n")
        for tag, r in pick_hillclimb(rows).items():
            print(
                f"- **{tag}**: {r['arch']} x {r['shape']} "
                f"(dominant={r['roofline']['dominant']}, "
                f"fraction={r['roofline']['roofline_fraction']:.4f})"
            )
    n_fail = sum(1 for r in rows if r["status"] == "failed")
    n_skip = sum(1 for r in rows if r["status"] == "skipped")
    print(f"\ncells: {len(rows)} ok={len(ok)} skipped={n_skip} failed={n_fail}")


if __name__ == "__main__":
    main()
