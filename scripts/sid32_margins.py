"""Conditioning analysis of the d=32 StableIdentification instance.

Reads the SAME cached instance payload the batched sweeps and the CPU/x64
deep run solve (``dataset/_cache/StableIdentification_s32_seed0_b8.npz``)
and measures, per constrained entry of A, the width of the widest
feasible segment — the corridor the barrier must operate in.  Every
constraint width scales with |true_A[r, c]| (onebox: width = (u1+u2)|a|
with u_i ~ U[0.2, 0.8], so in [0.4, 1.6]|a|; ``generator.py:68-113``
semantics re-derived in ``problems/stable_identification.py::
generate_constraints``), so near-zero true-A entries get proportionally
razor corridors.  The output attributes the tightest corridors to their
constraint type (onebox vs twobox/annulus) and records the width
distribution (``result/sid32_margins.json``), to compare the deepest
residual any solver reaches against the tightest corridor.

    python scripts/sid32_margins.py [--npz dataset/_cache/...npz]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def entry_segments(constset):
    """Per constrained entry: feasible segments ([lo,hi] minus annulus
    holes), mirroring ``feasible_entry_targets`` (which returns midpoints;
    here we need the widths and the constraint-type attribution)."""
    from riptrm_tpu.problems.stable_identification import (
        KIND_LS, KIND_RS, parse_constset,
    )

    kinds, rows, cols, p1s, p2s = parse_constset(np.asarray(constset), 1.0)
    entries: dict = {}
    for kind, r, c, p1, p2 in zip(kinds, rows, cols, p1s, p2s):
        e = entries.setdefault(
            (int(r), int(c)),
            {"lo": -np.inf, "hi": np.inf, "holes": [], "kinds": set()},
        )
        e["kinds"].add(int(kind))
        if kind == KIND_LS:
            e["lo"] = max(e["lo"], float(p1))
        elif kind == KIND_RS:
            e["hi"] = min(e["hi"], float(p2))
        else:  # annulus hole |a - cc| >= |k|
            half = abs(float(p2))
            e["holes"].append((float(p1) - half, float(p1) + half))
    out = {}
    for key, e in sorted(entries.items()):
        segs = [(e["lo"], e["hi"])]
        for a, b in e["holes"]:
            segs = [
                s
                for seg in segs
                for s in ((seg[0], min(seg[1], a)), (max(seg[0], b), seg[1]))
            ]
        segs = [s for s in segs if s[1] > s[0]]
        out[key] = {
            "segments": segs,
            "widest": max((b - a for a, b in segs), default=0.0),
            "is_twobox": bool(e["holes"]),
        }
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--npz",
        default="dataset/_cache/StableIdentification_s32_seed0_b8.npz",
        help="cached instance payload (must contain 'constset')",
    )
    parser.add_argument("--out", default="result/sid32_margins.json")
    args = parser.parse_args()

    with np.load(args.npz) as z:
        constset = np.asarray(z["constset"])
    true_a_vals = {  # (r, c) -> true A entry, from the constset's aval col
        (int(r), int(c)): float(a)
        for r, c, a in zip(
            constset[:, 1].astype(int), constset[:, 2].astype(int),
            constset[:, 5],
        )
    }

    entries = entry_segments(constset)
    widths = np.array([e["widest"] for e in entries.values()])
    keys = list(entries.keys())
    order = np.argsort(widths)

    onebox_ratio = []  # onebox widest-segment width / |a|
    twobox_widest = []
    tightest = []
    for i in order[:10]:
        k = keys[i]
        e = entries[k]
        tightest.append(
            {
                "entry": list(k),
                "widest_segment": e["widest"],
                "type": "twobox" if e["is_twobox"] else "onebox",
                "true_a": true_a_vals[k],
                "abs_a": abs(true_a_vals[k]),
            }
        )
    for k, e in entries.items():
        a = abs(true_a_vals[k])
        if e["is_twobox"]:
            twobox_widest.append(e["widest"])
        elif a > 0:
            onebox_ratio.append(e["widest"] / a)

    report = {
        "npz": args.npz,
        "n_constrained_entries": len(entries),
        "n_onebox_entries": sum(
            1 for e in entries.values() if not e["is_twobox"]
        ),
        "n_twobox_entries": sum(1 for e in entries.values() if e["is_twobox"]),
        "widest_segment_min": float(widths.min()),
        "widest_segment_median": float(np.median(widths)),
        "widest_segment_max": float(widths.max()),
        "spread_max_over_min": float(widths.max() / widths.min()),
        "n_below_1e2": int((widths < 1e-2).sum()),
        "n_below_1e1": int((widths < 1e-1).sum()),
        "onebox_width_over_absa_min": float(np.min(onebox_ratio)),
        "onebox_width_over_absa_max": float(np.max(onebox_ratio)),
        "tightest_twobox_widest_segment": float(np.min(twobox_widest)),
        "tightest_10_entries": tightest,
        "note": (
            "onebox width = (u1+u2)|a|, u_i~U[0.2,0.8] -> [0.4,1.6]|a| by "
            "construction; the tightest corridors are oneboxes on near-zero "
            "true-A entries, not annulus slivers"
        ),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "tightest_10_entries"}))


if __name__ == "__main__":
    main()
