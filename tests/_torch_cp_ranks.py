"""The port's side of tests/test_torch_context.py: one rank of a gloo world
of four on the CPU.

This module imports no jax: the test spawns its ranks with the ``spawn``
method, and a spawned child imports the module of its target.  Every rank
runs every case on one world (a (1, 4, 1) and a (2, 2, 1) mesh of the same
four ranks) and saves its results to ``rank{r}.pt`` in the work directory;
the test process holds them against vdn.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist

import vdn_torch.nn.vit as tvit
from vdn_torch.kernels.ring_attention import ring_attention_kernel
from vdn_torch.models.video_depth_anything import build_video_depth_anything
from vdn_torch.parallel.context import (distributed_kv_attention,
                                        make_context_parallel_forward,
                                        ring_attention, set_cp_mode,
                                        ulysses_attention)
from vdn_torch.parallel.launch import initialize_distributed
from vdn_torch.parallel.mesh import SEQ_AXIS, axis_group, make_mesh, use_mesh

MESHES = {"seq4": (1, 4, 1), "seq2": (2, 2, 1)}
CLIP_CFG = dict(features=32, out_channels=(32, 32, 64, 64))


def short_vits() -> None:
    """vits cut to its first 4 blocks (the DPT head reads blocks 0-3)."""
    tvit.VIT_CONFIGS["vits"] = {**tvit.VIT_CONFIGS["vits"], "depth": 4}
    tvit.INTERMEDIATE_LAYER_IDX["vits"] = [0, 1, 2, 3]


def build(state, **kw):
    model = build_video_depth_anything("vits", device="cpu", **CLIP_CFG,
                                       **kw)
    model.load_state_dict(state)
    return model


def _seq_slice(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    p, i = mesh.size(1), mesh.get_coordinate()[1]
    n = x.shape[dim] // p
    return x.narrow(dim, i * n, n).contiguous()


def attention_cases(mesh, inp) -> dict:
    """The four attentions over the mesh's seq axis, this rank's blocks."""
    q, k, v, g = (_seq_slice(inp[n], mesh) for n in ("q", "k", "v", "g"))
    out = {}
    with use_mesh(mesh):
        with torch.no_grad():
            out["ring"] = ring_attention(q, k, v, SEQ_AXIS)
            out["ulysses"] = ulysses_attention(q, k, v, SEQ_AXIS)
            out["dkv"] = distributed_kv_attention(
                inp["dq"], _seq_slice(inp["dk"], mesh),
                _seq_slice(inp["dv"], mesh), SEQ_AXIS,
                _seq_slice(inp["dbias"], mesh, 0))
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        y = ring_attention_kernel(*args, axis_group(SEQ_AXIS))
        (y * g).sum().backward()
        out["ring_kernel"] = y.detach()
        out["ring_kernel_grads"] = [a.grad for a in args]
    return out


def clip_cases(state, mesh, x) -> dict:
    """The context-parallel clip forward for pe ape / rope in the modes
    ring and ring_pallas."""
    out = {}
    for pe in ("ape", "rope"):
        model = build(state, pe=pe, seq_axis=SEQ_AXIS)
        fwd = make_context_parallel_forward(model, mesh)
        for mode in ("ring", "ring_pallas"):
            set_cp_mode(mode)
            out[pe, mode] = fwd(x)
    set_cp_mode("auto")
    return out


def decode_cases(state, mesh, inp) -> dict:
    """_cached_cp with the 3-entry window zero-padded to 4 shards, and the
    CP chunk window (t0 4, k 2, cap 8), on the seq-4 mesh."""
    model = build(state, seq_axis=SEQ_AXIS)
    out = {}
    with use_mesh(mesh), torch.no_grad():
        new = inp["new"]
        caches = [_seq_slice(c, mesh) for c in inp["padded"]]
        out["cached_cp"] = model.forward_depth(
            model.forward_features(new), new.shape, caches=caches,
            cache_len=3)
        chunk = inp["chunk"]
        ph, pw = chunk.shape[2] // 14, chunk.shape[3] // 14
        r1, r2, l3, l4 = model.head.decode_pre(
            model.forward_features(chunk), ph, pw)
        windows = [(_seq_slice(b, mesh), inp["onehot"])
                   for b in inp["buffers"]]
        p3, ents = model.head.decode_temporal(
            l3, l4, tuple(r2.shape[-3:-1]), chunk.shape[1], caches=windows)
        out["chunk"] = (model.head.decode_post(p3, r1, r2,
                                               (ph * 14, pw * 14)), ents)
    return out


def run(rank: int, world: int, workdir: str) -> None:
    """One rank: every case, results to ``workdir/rank{rank}.pt``."""
    torch.set_num_threads(1)
    short_vits()
    work = Path(workdir)
    initialize_distributed(num_processes=world, process_id=rank,
                           device="cpu",
                           init_method=f"file://{work / 'store'}")
    inp = torch.load(work / "inputs.pt")
    state = torch.load(work / "state.pt")
    meshes = {name: make_mesh(*shape, device="cpu")
              for name, shape in MESHES.items()}
    out = {"coord": {n: tuple(m.get_coordinate()) for n, m in meshes.items()}}
    for name, mesh in meshes.items():
        out[name] = attention_cases(mesh, inp)
        out[name, "clip"] = clip_cases(state, mesh, inp["clip"])
    out["decode"] = decode_cases(state, meshes["seq4"], inp)
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()
