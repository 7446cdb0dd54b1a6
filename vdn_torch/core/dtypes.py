"""Mixed-precision policy of the port, the same as vdn/core/dtypes.py.

bf16 compute with fp32 parameters, cast to the compute dtype at use;
LayerNorm, GroupNorm and softmax statistics in fp32; and an fp32 output
island (the last DPT convs accumulate and emit fp32).  Modules take the
compute dtype from their input tensor, as vdn's do.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # dtype used for softmax / normalization statistics
    reduce_dtype: torch.dtype = torch.float32
    # dtype of the final output convs (the reference's fp32 island)
    output_dtype: torch.dtype = torch.float32


FP32 = Policy()
BF16 = Policy(compute_dtype=torch.bfloat16)


def get_policy(name: str) -> Policy:
    return {"fp32": FP32, "float32": FP32, "bf16": BF16, "bfloat16": BF16}[name]
