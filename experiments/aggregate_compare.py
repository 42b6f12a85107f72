#!/usr/bin/env python
"""Aggregate per-seed train_compare artifacts into the seed table.

A committed, rerunnable aggregation: reads every per-seed
``train_compare`` output, computes per-arm means and seed-PAIRED
differences vs the baseline arm (the authoritative analysis), and writes
the aggregate JSON.

Arms re-measured later under a CHANGED implementation are merged as
DISTINCT arm names via ``--extra`` (e.g. the round-4 per-game
stratified-coin PCR re-test lands as ``pcr_pergame``/``economy_pergame``
beside the round-3 batch-shared-coin rows, which stay quotable).

Usage:
  python experiments/aggregate_compare.py \
      --base "docs/runs/train_compare_cpu.json,docs/runs/train_compare_cpu_s*.json" \
      --extra pergame:"docs/runs/train_compare_cpu_pcr2_s*.json" \
      --out docs/runs/train_compare_cpu_seeds.json
"""

import argparse
import glob
import json
import math


def load_seed_files(patterns):
    files = []
    for pat in patterns.split(","):
        files.extend(sorted(glob.glob(pat.strip())))
    out = {}
    meta = {}
    for f in files:
        d = json.load(open(f))
        if "seed" not in d or "results" not in d:
            continue  # e.g. the aggregate itself caught by a loose glob
        seed = d["seed"]
        meta = {"preset": d["preset"], "iters": d["iters"]}
        for r in d["results"]:
            out.setdefault(seed, {})[r["arm"]] = r
    return out, meta


def paired(deltas):
    n = len(deltas)
    mean = sum(deltas) / n
    if n < 2:
        return {"mean": round(mean, 1), "se": None, "t": None}
    var = sum((d - mean) ** 2 for d in deltas) / (n - 1)
    se = math.sqrt(var / n)
    return {
        "mean": round(mean, 1),
        "se": round(se, 1),
        "t": round(mean / se, 2) if se > 0 else None,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="comma-separated globs of per-seed files")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="SUFFIX:GLOBS",
                    help="per-seed files whose arms are renamed arm_SUFFIX")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    by_seed, meta = load_seed_files(args.base)
    for spec in args.extra:
        suffix, pats = spec.split(":", 1)
        extra, _ = load_seed_files(pats)
        for seed, arms in extra.items():
            for arm, r in arms.items():
                by_seed.setdefault(seed, {})[f"{arm}_{suffix}"] = r

    seeds = sorted(by_seed)
    arm_names = sorted({a for arms in by_seed.values() for a in arms})
    table = {}
    for arm in arm_names:
        rows = [(s, by_seed[s][arm]) for s in seeds if arm in by_seed[s]]
        peaks = [r["best_anchored_elo"] for _, r in rows]
        finals = [r["final_anchored_elo"] for _, r in rows]
        entry = {
            "n_seeds": len(rows),
            "seeds": [s for s, _ in rows],
            "peak_per_seed": [round(p, 1) for p in peaks],
            "final_per_seed": [round(f, 1) for f in finals],
            "mean_peak": round(sum(peaks) / len(peaks), 1),
            "mean_final": round(sum(finals) / len(finals), 1),
            "mean_wall_s": round(
                sum(r["wall_s"] for _, r in rows) / len(rows), 1
            ),
        }
        if arm != "baseline":
            pairs = [
                s for s, _ in rows
                if "baseline" in by_seed[s]
            ]
            if len(pairs) >= 2:
                dp = [
                    by_seed[s][arm]["best_anchored_elo"]
                    - by_seed[s]["baseline"]["best_anchored_elo"]
                    for s in pairs
                ]
                df = [
                    by_seed[s][arm]["final_anchored_elo"]
                    - by_seed[s]["baseline"]["final_anchored_elo"]
                    for s in pairs
                ]
                entry["paired_peak_diff_vs_baseline"] = paired(dp)
                entry["paired_final_diff_vs_baseline"] = paired(df)
        table[arm] = entry

    out = {"preset": meta.get("preset"), "iters": meta.get("iters"),
           "seeds": seeds, "arms": table}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out} ({len(arm_names)} arms x {len(seeds)} seeds)")
    for arm in arm_names:
        e = table[arm]
        pd = e.get("paired_peak_diff_vs_baseline", {})
        print(
            f"  {arm:18s} n={e['n_seeds']} peak={e['mean_peak']:7.1f} "
            f"final={e['mean_final']:7.1f} wall={e['mean_wall_s']:6.1f}s"
            + (
                f"  dpeak={pd['mean']:+7.1f} (t={pd['t']})"
                if pd
                else ""
            )
        )


if __name__ == "__main__":
    main()
