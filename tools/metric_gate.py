"""chip_smoke.py's metric-phase gradient-fidelity gate at several base
learning rates, on the card.

    python3 tools/metric_gate.py [--tree DIR] LR [LR ...]

For each base LR (MetricDepthTrainer's; its head at 10x) the metric
phase's set-up is built anew (vitl 518, bf16, random weights from the
phase's seed, the output bias calibrated), then: one b1 step's gradient
with the kernels, through the plain versions in bf16 and in fp32 (the
first LR also at the built weights), after the phase's 1 +
METRIC_TRAIN_STEPS steps at b2.  Prints the three distances, the gate's
tolerance (E2E_DRIFT_FACTOR x plain bf16 vs fp32), the fp32 gradient's
norm, whether the gate passes, the losses and how many parameter tensors
the steps moved.  ``--tree DIR`` runs another checkout's chip_smoke.py
and vdn_torch (its kernels built from its own sources), so two trees can
be compared in one call.  Imports nothing of JAX; needs a CUDA device.
"""

import argparse
import os
import sys

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("lrs", nargs="+", type=float)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from vdn_torch import kernels
    from vdn_torch.models.metric_depth import build_metric_depth_anything_v2
    from vdn_torch.pipelines.transform import preprocess_frame
    from vdn_torch.train.metric_depth import MetricDepthTrainer
    cs.environment()
    cs.build_kernels()
    frames = cs.synthetic_clip()
    for i, lr in enumerate(args.lrs):
        model = build_metric_depth_anything_v2(
            "vitl", compute_dtype=torch.bfloat16, device="cpu",
            generator=torch.Generator().manual_seed(cs.SEED + 4)).to(
                cs.DEVICE)
        rng = np.random.default_rng(cs.SEED + 1)
        img = np.stack([preprocess_frame(f, cs.SIZE)
                        for f in frames[:cs.TRAIN_B]])
        depth = 0.5 + 15.0 * cs.smooth_field(rng, cs.TRAIN_B)
        mask = (rng.random(depth.shape) > 0.05).astype(np.float32)
        batch = {"image": img, "depth": depth.astype(np.float32),
                 "valid_mask": mask}
        x = torch.from_numpy(img[:1]).to(cs.DEVICE)
        cs.calibrate_output_bias(model.depth_head.scratch,
                                 lambda: model(x), quantile=0.5,
                                 unit_scale=True)
        trainer = MetricDepthTrainer(model, base_lr=lr)
        params = [p for p in model.parameters() if p.requires_grad]
        small = [torch.from_numpy(a[:1]).to(cs.DEVICE)
                 for a in (img, batch["depth"], mask)]

        def grads():
            model.zero_grad(set_to_none=True)
            trainer.loss(*small).backward()
            g = cs.grad_vector([p for p in params if p.grad is not None])
            model.zero_grad(set_to_none=True)
            return g

        def report(where: str) -> None:
            g = grads()
            with kernels.plain_reference():
                g16 = grads()
                model.compute_dtype = torch.float32
                g32 = grads()
                model.compute_dtype = torch.bfloat16
            floor = cs.rel_l2(g16, g32)
            tol = cs.E2E_DRIFT_FACTOR * floor
            kb, kf = cs.rel_l2(g, g16), cs.rel_l2(g, g32)
            print(f"[metric_gate] tree={args.tree} base_lr={lr:g} "
                  f"at={where} kernels_vs_plain_bf16={kb:.4e} "
                  f"kernels_vs_fp32={kf:.4e} plain_bf16_vs_fp32={floor:.4e} "
                  f"tol={tol:.4e} grad_norm_fp32={float(g32.norm()):.4e} "
                  f"passes={kb <= tol and kf <= tol}", flush=True)

        if i == 0:
            report("built")
        before = [p.detach().clone() for p in params]
        flips = np.random.default_rng(cs.SEED)
        losses = [round(trainer.train_step(batch, flips), 6)
                  for _ in range(1 + cs.METRIC_TRAIN_STEPS)]
        moved = sum(not torch.equal(p, b) for p, b in zip(params, before))
        print(f"[metric_gate] tree={args.tree} base_lr={lr:g} "
              f"losses={losses} tensors_moved={moved}/{len(params)}",
              flush=True)
        report("trained")
        del model, trainer, before
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
