"""Wrapper of the Hopper span-decode kernel (``csrc/span_decode.cu``).

It replaces the TPU kernel ``hual_tpu/ops/pallas/span_decode.py``.  For
tensors on the CPU it runs the plain decode of ``ops/decode.py``; for CUDA
tensors it launches the kernel or raises, and never falls back.
``span_decode.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hual_tpu_torch.ops import decode
from hual_tpu_torch.ops.kernels import build

# one warp per row, 4 rows a block, 2*T floats of shared memory per row; the
# default 48 KB of shared memory per block bounds T
MAX_T = 48 * 1024 // (4 * 2 * 4)


@functools.cache
def _function():
    fn = build.load("span_decode").span_decode_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def span_decode(start_logits: torch.Tensor, end_logits: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.decode.span_decode``: (B,T) f32 logits and (B,T)
    int32 0/1 mask -> (start_index, end_index), each (B,) int32."""
    if start_logits.device.type == "cpu":
        return decode.span_decode(start_logits, end_logits, mask)
    if start_logits.device.type != "cuda":
        raise ValueError(f"span_decode: unsupported device {start_logits.device}")
    for t, name, dtype in ((start_logits, "start_logits", torch.float32),
                           (end_logits, "end_logits", torch.float32),
                           (mask, "mask", torch.int32)):
        if t.device != start_logits.device:
            raise ValueError(f"span_decode: {name} is on {t.device}, "
                             f"start_logits on {start_logits.device}")
        if t.dtype != dtype:
            raise TypeError(f"span_decode: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape != start_logits.shape:
            raise ValueError(f"span_decode: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(start_logits.shape)} (B, T)")
        if not t.is_contiguous():
            raise ValueError(f"span_decode: {name} must be contiguous")
    B, T = start_logits.shape
    if not 1 <= T <= MAX_T:
        raise ValueError(f"span_decode: T={T} outside [1, {MAX_T}]")
    start_index = torch.empty(B, dtype=torch.int32, device=start_logits.device)
    end_index = torch.empty(B, dtype=torch.int32, device=start_logits.device)
    if B == 0:
        return start_index, end_index
    with torch.cuda.device(start_logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _function()(start_logits.data_ptr(), end_logits.data_ptr(),
                         mask.data_ptr(), start_index.data_ptr(),
                         end_index.data_ptr(), B, T, stream)
    if rc != 0:
        raise RuntimeError(f"span_decode kernel launch failed: CUDA error {rc}")
    span_decode.launches += 1
    return start_index, end_index


span_decode.launches = 0
