"""Wrapper of the Hopper fused-forward kernel K2 (``csrc/fused_forward.cu``).

It replaces the TPU kernel ``hual_tpu/ops/pallas/fused_forward.py``, both
of its product paths: f64 sums of f32 operands (the default) and, with
``mxu_bf16``, bf16 operands with f32 sums (the JAX kernel's ``mxu_bf16``).
For tensors on the CPU it runs the plain version, ``ops.fused_forward.
forward_math``, with the same ``mxu_bf16``; for CUDA tensors it launches the
kernel on that path or raises, and never falls back to the other path or
the plain version.  The bf16 path reads the packed weights' bf16 companion
and the schedule of its slabs (``PackedWeights.bf16``, ``.schedule``).  ``fused_forward.launches`` counts the launches of the
default path, ``fused_forward.launches_bf16`` those of the bf16 path.
The kernel takes any T >= 1 and W >= 1 and any D that ``num_heads`` divides,
as the Pallas kernel does: each stage takes a resident route where its
operands fit in a block's shared memory and a tiled one where they do not
(:func:`routes`); :func:`check_kernel_shape` is what it refuses.  Two builds
of the source serve it: the resident kernel (``csrc/fused_forward.cu``),
whose code is what the shapes of the old limit ran before the tiled routes,
takes every shape whose stages are all resident; the general kernel
(``csrc/fused_forward_general.cu``, every route) takes the rest.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hual_tpu_torch.ops.fused_forward import PackedWeights, forward_math
from hual_tpu_torch.ops.kernels import build

# The keys of ``fused_forward_routes``'s six values (csrc/fused_forward.cu)
ROUTE_KEYS = ("f64_attention", "f64_heads_per_group", "f64_masks_in_smem",
              "bf16_heads_per_group", "bf16_cq_tile", "bf16_masks_in_smem")
F64_ATTENTION = ("resident", "grouped", "streamed")


@functools.cache
def _library(name: str = "fused_forward"):
    lib = build.load(name)
    lib.fused_forward_f32.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_forward_f32.restype = ctypes.c_int
    lib.fused_forward_bf16.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_forward_bf16.restype = ctypes.c_int
    lib.fused_forward_bf16_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_forward_bf16_smem_bytes.restype = ctypes.c_longlong
    lib.fused_forward_weight_floats.argtypes = [ctypes.c_int] * 3
    lib.fused_forward_weight_floats.restype = ctypes.c_longlong
    lib.fused_forward_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.fused_forward_workspace_floats.restype = ctypes.c_longlong
    lib.fused_forward_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_forward_smem_bytes.restype = ctypes.c_longlong
    lib.fused_forward_routes.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fused_forward_routes.restype = None
    lib.fused_forward_threads.restype = ctypes.c_int
    lib.fused_forward_takes.argtypes = [ctypes.c_int] * 5
    lib.fused_forward_takes.restype = ctypes.c_int
    return lib


def resident(T: int, W: int, D: int, num_heads: int, mxu_bf16: bool = False) -> bool:
    """Whether the resident kernel takes this shape on this path (else the
    general kernel runs it)."""
    return bool(_library().fused_forward_takes(T, W, D, num_heads, int(mxu_bf16)))


def workspace_floats(T: int, W: int, D: int, num_heads: int) -> int:
    """f32 values of per-sample workspace the kernel needs (0.53 MB a sample
    at T=64, W=13, D=128)."""
    return int(_library().fused_forward_workspace_floats(T, W, D, num_heads))


def smem_bytes(T: int, W: int, D: int, num_heads: int, mxu_bf16: bool = False) -> int:
    """Dynamic shared memory of one block (one sample) on either path."""
    lib = _library()
    fn = lib.fused_forward_bf16_smem_bytes if mxu_bf16 else lib.fused_forward_smem_bytes
    return int(fn(T, W, D, num_heads))


def routes(T: int, W: int, D: int, num_heads: int) -> dict:
    """The routes a launch takes at this shape: the default path's attention
    (``resident``: q, k and v of every head in shared memory; ``grouped``: of
    ``f64_heads_per_group`` heads at a time; ``streamed``: one head's scores
    in the workspace), the bf16 path's heads whose images fit at once (0:
    every attention streams its keys in chunks, as any over more than 112
    keys does) and its CQ products' tile (0: resident), whether each path
    keeps the masks in shared memory, and which kernel runs each path
    (``resident`` or ``general``, :func:`resident`)."""
    out = (ctypes.c_int * len(ROUTE_KEYS))()
    _library().fused_forward_routes(T, W, D, num_heads, out)
    got = dict(zip(ROUTE_KEYS, out))
    got["f64_attention"] = F64_ATTENTION[got["f64_attention"]]
    for path, bf16 in (("f64", False), ("bf16", True)):
        got[f"{path}_kernel"] = ("resident" if resident(T, W, D, num_heads, bf16)
                                 else "general")
    for key in ("f64_masks_in_smem", "bf16_masks_in_smem"):
        got[key] = bool(got[key])
    return got


def threads_per_block() -> int:
    return int(_library().fused_forward_threads())


def check_kernel_shape(T: int, W: int, D: int, num_heads: int) -> None:
    """Raises ``ValueError`` unless the kernel takes T clips, W words, width
    D and ``num_heads`` heads: T, W and the heads at least 1, D divisible by
    the heads.  There is no upper bound: past what fits in shared memory
    the stages tile (:func:`routes`)."""
    if T < 1 or W < 1:
        raise ValueError(f"fused_forward: the kernel takes T >= 1 and W >= 1, "
                         f"got T={T}, W={W}")
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"fused_forward: D={D} not divisible by "
                         f"{num_heads} heads")


def _check(packed: PackedWeights, vf, qf, v_mask, q_mask, attn_layer: int,
           num_heads: int) -> None:
    dev = vf.device
    for t, name, dtype, dims in ((packed.buffer, "packed weights", torch.float32, 1),
                                 (vf, "vf", torch.float32, 3),
                                 (qf, "qf", torch.float32, 3),
                                 (v_mask, "v_mask", torch.int32, 2),
                                 (q_mask, "q_mask", torch.int32, 2)):
        if t.device != dev:
            raise ValueError(f"fused_forward: {name} is on {t.device}, vf on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fused_forward: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != dims:
            raise ValueError(f"fused_forward: {name} must have {dims} dims, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_forward: {name} must be contiguous")
    B, T, D = vf.shape
    W = qf.shape[1]
    if qf.shape != (B, W, D):
        raise ValueError(f"fused_forward: qf has shape {tuple(qf.shape)}, "
                         f"expected (B={B}, W, D={D})")
    if v_mask.shape != (B, T) or q_mask.shape != (B, W):
        raise ValueError(f"fused_forward: masks {tuple(v_mask.shape)} and "
                         f"{tuple(q_mask.shape)} do not match (B,T)={B, T}, "
                         f"(B,W)={B, W}")
    check_kernel_shape(T, W, D, num_heads)
    if max(T, W) > packed.max_pos:
        raise ValueError(f"fused_forward: T={T} and W={W} must lie in "
                         f"[1, {packed.max_pos}] (the positional table)")
    if attn_layer != packed.attn_layer:
        raise ValueError(f"fused_forward: attn_layer={attn_layer}, the weights "
                         f"were packed for {packed.attn_layer}")


def _check_bf16(packed: PackedWeights, dev: torch.device) -> None:
    """The bf16 path reads the companion and its schedule (pack_weights)."""
    for t, name, dtype in ((packed.bf16, "bf16 companion", torch.bfloat16),
                           (packed.schedule, "ring schedule", torch.int32)):
        if t is None:
            raise ValueError(f"fused_forward: the {name} is missing: pack the "
                             "weights with pack_weights")
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"fused_forward: the {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")


def fused_forward(packed: PackedWeights, vf: torch.Tensor, qf: torch.Tensor,
                  v_mask: torch.Tensor, q_mask: torch.Tensor, *, attn_layer: int,
                  num_heads: int, tau: float, use_gumbel: bool,
                  mxu_bf16: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: projected streams vf (B,T,D) / qf (B,W,D) f32 and their int32 0/1
    masks -> (start_logits (B,T), end_logits (B,T), match_scores (B,T,4)),
    f32; ``mxu_bf16`` runs the products on bf16 operands."""
    _check(packed, vf, qf, v_mask, q_mask, attn_layer, num_heads)
    if vf.device.type == "cpu":
        return forward_math(packed, vf, qf, v_mask, q_mask,
                            attn_layer=attn_layer, num_heads=num_heads,
                            tau=tau, use_gumbel=use_gumbel, mxu_bf16=mxu_bf16)
    if vf.device.type != "cuda":
        raise ValueError(f"fused_forward: unsupported device {vf.device}")
    B, T, D = vf.shape
    W = qf.shape[1]
    lib = (_library() if resident(T, W, D, num_heads, mxu_bf16)
           else _library("fused_forward_general"))
    expected = lib.fused_forward_weight_floats(D, attn_layer, packed.max_pos)
    if packed.buffer.numel() != expected:
        raise ValueError(f"fused_forward: {packed.buffer.numel()} packed "
                         f"weights, the kernel reads {expected}")
    dev = vf.device
    if mxu_bf16:
        _check_bf16(packed, dev)
    start = torch.empty((B, T), dtype=torch.float32, device=dev)
    end = torch.empty((B, T), dtype=torch.float32, device=dev)
    scores = torch.empty((B, T, 4), dtype=torch.float32, device=dev)
    if B == 0:
        return start, end, scores
    workspace = torch.empty(B * workspace_floats(T, W, D, num_heads),
                            dtype=torch.float32, device=dev)
    args = (vf.data_ptr(), qf.data_ptr(), v_mask.data_ptr(), q_mask.data_ptr(),
            start.data_ptr(), end.data_ptr(), scores.data_ptr(),
            workspace.data_ptr(), B, T, W, D, num_heads, attn_layer,
            packed.max_pos, float(tau), int(bool(use_gumbel)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if mxu_bf16:
            rc = lib.fused_forward_bf16(
                packed.buffer.data_ptr(), packed.bf16.data_ptr(),
                packed.schedule.data_ptr(), packed.schedule.shape[0],
                packed.bf16_layout["matching_head/dense/kernel"][0],
                packed.bf16_layout["label_emb"][0], *args, stream)
        else:
            rc = lib.fused_forward_f32(packed.buffer.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_forward kernel launch failed: CUDA error {rc}")
    if mxu_bf16:
        fused_forward.launches_bf16 += 1
    else:
        fused_forward.launches += 1
    return start, end, scores


fused_forward.launches = 0
fused_forward.launches_bf16 = 0
