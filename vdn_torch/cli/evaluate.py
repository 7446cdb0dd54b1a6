"""Evaluation CLI: depthcrafter protocol + TPF reporting (vdn/cli/evaluate.py;
reference scripts/evaluate_v4.py:128-238, eval_depthcrafter/eval.py).

Usage:
  python -m vdn_torch.cli.evaluate --dataset-config configs/config_eval.yaml \
      --datasets Sintel --encoder vitl --checkpoint ckpt.pth \
      [--model-name ours|dav2] [--double-refine] [--device cuda]

Prints one JSON line: the metrics averaged over the val sequences,
``TPF(msec)`` (ms a frame of the model's forward, the copy back to the
host included) and ``frames``.  ``build_model`` and ``evaluate`` are the
device work, apart from the argument parsing in ``main``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Sequence

import numpy as np


def build_model(encoder: str, checkpoint: str, model_version: int = 4,
                compute_dtype: str = "bf16", device: str = "cuda"):
    """RefineVideoDepth with the checkpoint's weights (reference names,
    ``V4_RENAME_MAP`` applied), on ``device``."""
    from vdn_torch.core.checkpoint import load_checkpoint
    from vdn_torch.models.refine import build_refine_video_depth
    from vdn_torch.train.trainer import V4_RENAME_MAP, rename_with_map
    model = build_refine_video_depth(model_version, encoder,
                                     compute_dtype=compute_dtype,
                                     device=device)
    load_checkpoint(model, checkpoint,
                    rename=lambda k: rename_with_map(k, V4_RENAME_MAP))
    return model


def evaluate(model, datasets: Sequence, model_name: str = "ours",
             double_refine: bool = False, seq_len: int = 98,
             domain: str = "depth") -> Dict:
    """Every sequence of ``datasets`` through ``model`` (``dav2``: the
    input depth maps scored as they are), each scored by
    ``eval_sequence``: {"metrics": the means, "TPF(msec)", "frames"}."""
    import torch

    from vdn_torch.eval.protocol import eval_sequence
    device = next(model.parameters()).device
    all_metrics = []
    total_time, total_frames = 0.0, 0
    with torch.no_grad():
        for ds in datasets:
            for i in range(len(ds)):
                item = ds[i]
                x = item["depth_anything_v2"][None].astype(np.float32)
                t0 = time.perf_counter()
                if model_name == "dav2":
                    pred = x  # baseline: score the input depth maps as-is
                else:
                    out = model(torch.from_numpy(x).to(device))
                    if double_refine:
                        out = model(out)
                    pred = out.float().cpu().numpy()
                pred = np.asarray(pred)[0]
                total_time += time.perf_counter() - t0
                total_frames += pred.shape[0]
                all_metrics.append(eval_sequence(
                    pred, item["depth"], seq_len=seq_len, domain=domain,
                    mask=item.get("mask")))
    avg = {k: float(np.mean([m[k] for m in all_metrics]))
           for k in all_metrics[0]}
    tpf_ms = total_time / max(total_frames, 1) * 1000
    return {"metrics": avg, "TPF(msec)": round(tpf_ms, 3),
            "frames": total_frames}


def main(argv=None):
    parser = argparse.ArgumentParser(description="vdn_torch evaluation")
    parser.add_argument("--dataset-config", type=str, required=True)
    parser.add_argument("--datasets", nargs="+", default=["Sintel"])
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--model-version", type=int, default=4)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--domain", default="depth",
                        choices=["depth", "disp"])
    parser.add_argument("--seq-len", type=int, default=98)
    parser.add_argument("--double-refine", action="store_true",
                        help="run model(model(x)) like the reference "
                        "'ours' eval path (evaluate_v4.py:195-196)")
    parser.add_argument("--model-name", default="ours",
                        choices=["ours", "dav2"],
                        help="'dav2' evaluates the input depth-anything "
                        "maps directly (the reference's baseline "
                        "passthrough, evaluate_v4.py:192-196)")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if not args.checkpoint:
        raise SystemExit("--checkpoint is required")

    from vdn_torch.data.factory import create_datasets
    model = build_model(args.encoder, args.checkpoint, args.model_version,
                        args.compute_dtype, args.device)
    datasets = create_datasets(args.datasets, args.dataset_config, "val")
    result = evaluate(model, datasets, args.model_name, args.double_refine,
                      args.seq_len, args.domain)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
