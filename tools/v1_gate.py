"""The spread of chip_smoke.py's v1 gradient-fidelity gate on the card.

    python3 tools/v1_gate.py [--clips K] [ENCODER ...]

For each encoder (hiera_base_plus and hiera_large by default) the set-up of
chip_smoke's ``[cli_train_v1_<encoder>]`` phase is built anew (seeded random
weights at full width, 256 px, ``train_v1``'s ``train`` for one epoch of 3
steps at b2 x 8, fp32), then K b1 x s4 clips of the v1 batch contract, each
with its own fixed cotangent, go through the model's VJP four ways: with the
kernels; with the kernels but D2 swapped for its plain version; through the
plain versions; through the plain versions with the input depths or frames
scaled by 1 +- 1e-6.  Prints, per clip and pooled over the K clips (the
rel L2 of the K VJPs concatenated), the kernels' distance to the plain VJP,
the D2-plain variant's, and the four nudged plain runs', and whether the
kernels' VJP is bit-equal on a second run.  Also at the built weights (before
the epoch).  Imports nothing of JAX; needs a CUDA device.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=6)
    ap.add_argument("encoders", nargs="*",
                    default=["hiera_base_plus", "hiera_large"])
    args = ap.parse_args()
    import chip_smoke as cs
    from vdn_torch import kernels
    from vdn_torch.cli import train_v1 as cli
    from vdn_torch.cli._common import parse_with_master_config
    from vdn_torch.kernels import flash_attention as fa
    from vdn_torch.train.trainer import V1Trainer
    cs.environment()
    cs.build_kernels()
    kernel_bwd = fa.flash_attention_bwd

    def plain_bwd(q, k, v, out, lse, dout, scale=None):
        return fa.flash_attention_bwd_plain(q, k, v, out, dout, scale)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = cs.synthetic_config(tmp, "v1_gate", size=cs.CLI_V1_WIDE_SIZE,
                                  t=cs.V1_S)
        for encoder in args.encoders:
            a = parse_with_master_config(cli.build_parser(), [
                "--dataset-config", cfg, "--datasets", cs.synthetic_dataset(),
                "--encoder", encoder, "--sequence-length", str(cs.V1_S),
                "--epochs", "1", "--batch-size", str(cs.V1_B),
                "--seed", str(cs.SEED), "--log-dir",
                os.path.join(tmp, f"{encoder}_logs"), "--checkpoint-dir",
                os.path.join(tmp, f"{encoder}_ckpt"), "--run-name",
                encoder], "v1")
            with cs.exact_fp32():
                model = cs.build_v1_model(encoder, cs.SEED + 9)
                for where in ("built", "trained"):
                    if where == "trained":
                        cli.train(a, model)
                        torch.cuda.synchronize()
                    report(cs, kernels, fa, kernel_bwd, plain_bwd, model,
                           V1Trainer(model), encoder, where, args.clips)
            del model
            torch.cuda.empty_cache()


def report(cs, kernels, fa, kernel_bwd, plain_bwd, model, trainer, encoder,
           where, clips) -> None:
    rng = np.random.default_rng(cs.SEED + 9)
    sq = {}

    def add(key, g, ref):
        d, n = sq.setdefault(key, [0.0, 0.0])
        sq[key] = [d + float((g - ref).norm()) ** 2,
                   n + float(ref.norm()) ** 2]
        return cs.rel_l2(g, ref)

    for clip in range(clips):
        batch = cs.v1_batch(rng)
        small = trainer._batch({k: v[:1, :cs.V1_GRAD_S]
                                for k, v in batch.items()})
        inputs = small[:2]
        cot = [cs._rand(rng, (1, cs.V1_GRAD_S, cs.V1_SIZE, cs.V1_SIZE)),
               cs._rand(rng, (1, cs.V1_GRAD_S, cs.V1_SIZE, cs.V1_SIZE, 3))]

        def vjp(x=inputs):
            model.zero_grad(set_to_none=True)
            d, n = model(*x)
            ((d * cot[0]).sum() + (n * cot[1]).sum()).backward()
            g = cs.grad_vector([p for p in model.parameters()
                                if p.grad is not None])
            model.zero_grad(set_to_none=True)
            return g

        g_k = vjp()
        g_k2 = vjp()
        fa.flash_attention_bwd = plain_bwd
        try:
            g_kd = vjp()
        finally:
            fa.flash_attention_bwd = kernel_bwd
        row = {}
        with kernels.plain_reference():
            g_p = vjp()
            for i, name in enumerate(("depth", "rgb")):
                for sign in (1, -1):
                    nudged = list(inputs)
                    nudged[i] = nudged[i] * (1 + sign * 1e-6)
                    key = f"plain_nudged_{name}{'+' if sign > 0 else '-'}"
                    row[key] = add(key, vjp(nudged), g_p)
        row["kernels"] = add("kernels", g_k, g_p)
        row["kernels_d2_plain"] = add("kernels_d2_plain", g_kd, g_p)
        row["kernels_repeat_equal"] = bool(torch.equal(g_k, g_k2))
        print(f"[v1_gate] encoder={encoder} at={where} clip={clip} " +
              json.dumps({k: v if isinstance(v, bool) else float(f"{v:.4e}")
                          for k, v in row.items()}), flush=True)
    pooled = {k: float(f"{(d / n) ** 0.5:.4e}") for k, (d, n) in sq.items()}
    print(f"[v1_gate] encoder={encoder} at={where} pooled_over={clips} "
          + json.dumps(pooled), flush=True)


if __name__ == "__main__":
    main()
