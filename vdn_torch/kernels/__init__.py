"""Hand-written CUDA kernels of the port: build, dispatch, launch counts.

The kernels (A1-A6 of the clip-depth path, B1 of streaming, C1 and C2 of
the single-image path's memory attention and of hieradet's global blocks,
the training backwards D1-D4 with A1's training forward, F1-F6 of the
int8 serving mode, E1, the ring-attention step of the context-parallel
temporal attention, and C3, the head-major fused-qkv attention that no
path calls)
live in ``vdn_torch/csrc/*.cu``
with a plain C interface.  ``build()`` compiles
them with nvcc for sm_90a into one shared library under
``build/vdn_torch/`` (named by a hash of the sources and flags, so a
rebuilt checkout never loads a stale library) and loads it with ctypes.
Nothing is built at import time; the first kernel call builds.

Dispatch, used by every wrapper in this package:

- a tensor on the CPU takes the kernel's plain PyTorch version;
- a CUDA tensor launches the kernel, or the wrapper raises;
- inside ``plain_reference()`` CUDA tensors take the plain version too.
  Only reference runs enter it (chip_smoke.py's end-to-end comparison);
  the model's own path never does.

Autograd: a wrapper that a training path reaches (A1-A6, C2) runs, when
grad is enabled and an input requires it, through a
``torch.autograd.Function`` whose forward dispatches as above and whose
backward is the backward kernel (D1-D4), the same kernel on the transposed
plan (A5a, A5b) or a recompute of the plain version (A4, A6; the ring of
E1 re-runs the plain ring), as vdn computes it; on the CPU the backward takes the kernel's plain version.  A
backward dispatches as its forward did, on whatever thread autograd runs
it (``save_dispatch``, ``same_dispatch``).  B1, C1, C3, F1-F6 and the
single E1 step have no backward, nor has C2's bf16 kernel (D2 is fp32): on
a CUDA tensor that requires grad they raise.

``launches`` counts, per wrapper, the calls that launched the kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "launches", "reset_launches", "plain_reference",
           "use_kernel", "wants_grad", "save_dispatch", "same_dispatch",
           "grads_of_plain", "layer_norm_f32", "linear_f32acc"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vdn_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

launches = {
    "flash_attention_fused_qkv": 0,
    "fused_ln_mlp_residual": 0,
    "temporal_attention_block": 0,
    "fused_ln_geglu_residual": 0,
    "resize_rows": 0,
    "resize_mid_axis": 0,
    "select_rows": 0,
    "fused_resize_island": 0,
    "flash_attention": 0,
    "flash_attention_colbias": 0,
    "flash_attention_bwd": 0,
    "flash_attention_fused_qkv_train": 0,
    "flash_attention_fused_qkv_bwd": 0,
    "fused_ln_mlp_residual_bwd": 0,
    "temporal_attention_block_bwd": 0,
    "int8_ln_linear": 0,
    "int8_linear": 0,
    "int8_proj_residual": 0,
    "fused_ln_mlp_residual_int8": 0,
    "fused_ln_swiglu_residual_int8": 0,
    "ring_step": 0,
    "flash_attention_int8_fused_qkv": 0,
    "flash_attention_qkv": 0,
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "vdn_flash_attention_qkv": (_P, _I, _I, _I, _F, _P, _I, _P),
    "vdn_flash_attention_qkv_lse": (_P, _I, _I, _I, _F, _P, _P, _I, _P),
    "vdn_flash_attention_qkv_bwd": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P,
                                    _P, _P, _P),
    "vdn_flash_attention_bthd": (_P, _P, _P, _I, _I, _I, _I, _F, _P, _I,
                                 _P),
    "vdn_flash_attention_colbias": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
                                    _I, _P),
    "vdn_flash_attention_bthd_f32": (_P, _P, _P, _I, _I, _I, _I, _I)
    + (_L,) * 6 + (_F, _P, _P, _P),
    "vdn_flash_attention_bthd_bwd": (_P,) * 6 + (_I,) * 5 + (_L,) * 6
    + (_F, _F) + (_P,) * 5,
    "vdn_ln_mlp_residual": (_P, _I, _I, _I) + (_P,) * 7 + (_F,) + (_P,) * 3
    + (_I,) * 2 + (_P,),
    "vdn_ln_mlp_residual_bwd": (_P, _P, _I, _I, _I) + (_P,) * 6 + (_F,)
    + (_P,) * 12 + (_I,) * 2 + (_P,),
    "vdn_ln_geglu_residual": (_P, _I, _I, _I) + (_P,) * 6 + (_F,)
    + (_P,) * 3 + (_I,) * 2 + (_P,),
    "vdn_temporal_attention": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _F, _P,
                               _P, _P, _I, _I, _I, _P),
    "vdn_temporal_attention_bwd": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _F,
                                   _P, _P, _P, _P, _I, _I, _I, _P),
    "vdn_resize_rows": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P),
    "vdn_resize_mid_axis": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _P),
    "vdn_resize_island": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                          _I, _P, _P, _P, _P, _I, _F, _P, _I, _P),
    "vdn_int8_ln_linear": (_P, _I, _I, _I, _P, _P, _F) + (_P,) * 6 + (_I,),
    "vdn_int8_proj_residual": (_P, _P, _I, _I) + (_P,) * 7 + (_I, _P),
    "vdn_ln_mlp_int8": (_P, _I, _I, _I, _P, _P, _F) + (_P,) * 14
    + (_I,) * 3 + (_P,),
    "vdn_ln_swiglu_int8": (_P, _I, _I, _I, _P, _P, _F) + (_P,) * 14
    + (_I,) * 3 + (_P,),
    "vdn_ring_step": (_P, _P, _P) + (_I,) * 6 + (_L,) * 5 + (_F,)
    + (_P,) * 3 + (_I,) * 5 + (_P,),
    "vdn_ring_step_fit": (_I,) * 8 + (_P,),
    "vdn_flash_attention_int8": (_P, _I, _I, _I, _I, _F, _F) + (_P,) * 8
    + (_I, _P),
    "vdn_flash_attention_qkv_heads": (_P, _I, _I, _I, _F, _P, _I, _P),
    "vdn_gelu_check": (_P, _P, _P),
}

_PLAIN = contextvars.ContextVar("vdn_torch_plain_reference", default=False)
_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def plain_reference():
    """Run CUDA tensors through the plain versions (reference runs only)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def save_dispatch(ctx) -> None:
    """In an autograd Function's forward: record whether it ran inside
    ``plain_reference()``.  Autograd runs a CUDA backward on a thread of
    its own, where the context variable is unset; the backward re-enters
    it through ``same_dispatch(ctx)``."""
    ctx.plain = _PLAIN.get()


def same_dispatch(ctx):
    """In an autograd Function's backward: dispatch as its forward did."""
    return plain_reference() if ctx.plain else contextlib.nullcontext()


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True where a call must record a backward: grad mode is on and an
    input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def grads_of_plain(fn, inputs, needs, grad_out) -> list:
    """The cotangents of ``fn(*inputs)`` for the inputs flagged in
    ``needs`` (None for the others): a recompute of a plain version under
    autograd, the backward of the kernels vdn gives none (A4, A6) and of
    A3's weights."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(bool(n))
                if isinstance(t, torch.Tensor) else t
                for t, n in zip(inputs, needs)]
        wanted = [a for a, n in zip(args, needs) if n]
        if not wanted:
            return [None] * len(inputs)
        got = torch.autograd.grad(fn(*args), wanted, grad_out,
                                  allow_unused=True)
    got = iter(torch.zeros_like(a) if d is None else d
               for a, d in zip(wanted, got))
    return [next(got) if n else None for n in needs]


def use_kernel(x: torch.Tensor) -> bool:
    """True where the wrapper must launch its CUDA kernel."""
    if x.device.type == "cpu" or _PLAIN.get():
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    return True


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda)")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libvdn_torch_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{so.stem}_{src.stem}.o" for src in sources]
        # one nvcc per source, in parallel, then one link
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        (BUILD_DIR / f"{so.stem}.log").write_text("\n".join(logs))
        failed = [(src.name, log) for src, p, log in zip(sources, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error.
    The stream is read as its raw handle: ``torch.cuda.current_stream()``
    builds a Stream object, 5-8 us of host time against 0.3
    (tools/d2_variants.py, ``host_pieces``)."""
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = getattr(build(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (the kernels' persistent
    grids)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_kernel_args(name: str, *tensors: torch.Tensor,
                      aligned: bool = True) -> None:
    """Raise unless every tensor is a contiguous bf16, fp32, int32 or int8
    CUDA tensor, 16-byte aligned where the kernel needs ``aligned``."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
        if t.dtype not in (torch.bfloat16, torch.float32, torch.int32,
                           torch.int8):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor not contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """vdn.nn.layers.LayerNorm's fp32 island (returns fp32)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def linear_f32acc(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with operands in a's dtype, summed in fp32, rounded once to
    a's dtype: the ``preferred_element_type=float32`` dots of the TPU
    kernels.  w is a torch Linear weight [out, in]."""
    dt = a.dtype
    return torch.matmul(a.float(), w.to(dt).float().t()).to(dt)


LOG2E = math.log2(math.e)
