"""Standalone eval over saved prediction / GT dumps
(vdn/cli/eval_depthcrafter.py; reference eval_depthcrafter/eval.py:254-381:
CSV-driven CLI).

CSV columns: pred_path,gt_path[,mask_path]; npy / npz arrays [T, H, W]
(predictions in disparity, GT in depth).  Prints one JSON line of metrics
per row, then the means.  Needs no cv2 and no card.

Usage:
  python -m vdn_torch.cli.eval_depthcrafter --csv rows.csv \
      [--domain depth|disp] [--seq-len 98] [--min-depth 1e-3] \
      [--max-depth 70]
"""

from __future__ import annotations

import argparse
import csv
import json

import numpy as np


def _load(path):
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]]
    return np.load(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="depthcrafter eval "
                                                 "(vdn_torch)")
    parser.add_argument("--csv", required=True,
                        help="rows: pred_path,gt_path[,mask_path]")
    parser.add_argument("--domain", default="depth",
                        choices=["depth", "disp"])
    parser.add_argument("--seq-len", type=int, default=98)
    parser.add_argument("--min-depth", type=float, default=1e-3)
    parser.add_argument("--max-depth", type=float, default=70.0)
    args = parser.parse_args(argv)

    from vdn_torch.eval.protocol import eval_sequence

    rows = []
    with open(args.csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append(row)

    all_metrics = []
    for row in rows:
        pred = _load(row[0]).astype(np.float32)
        gt = _load(row[1]).astype(np.float32)
        mask = _load(row[2]) if len(row) > 2 and row[2] else None
        m = eval_sequence(pred, gt, seq_len=args.seq_len,
                          domain=args.domain,
                          dataset_min_depth=args.min_depth,
                          dataset_max_depth=args.max_depth, mask=mask)
        all_metrics.append(m)
        print(json.dumps({"pred": row[0], **m}))

    if all_metrics:
        means = {k: float(np.mean([m[k] for m in all_metrics]))
                 for k in all_metrics[0]}
        print(json.dumps({"mean": means, "sequences": len(all_metrics)}))


if __name__ == "__main__":
    main()
