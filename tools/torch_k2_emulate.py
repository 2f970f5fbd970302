#!/usr/bin/env python3
"""Run K2's CUDA source (``hual_tpu_torch/csrc/fused_forward.cu``) on the
CPU, both product paths, to rehearse its logic where there is no card and
no nvcc.

The source is compiled with g++ against a stand-in CUDA runtime: one
``std::thread`` per CUDA thread, ``std::barrier`` for ``__syncthreads`` and
for each warp's collectives (shuffles, ``ldmatrix``, ``mma.sync``).  The
PTX helpers get emulated bodies that follow the hardware's fragment and
descriptor layouts as the card showed them (``mma.sync m16n8k4`` f64 and
``m16n8k16`` bf16, ``ldmatrix`` with and without ``.trans``, ``wgmma
m64nNk16`` reading K-major images by descriptor, LBO along K, SBO between
8-row groups); bf16 rounds to nearest even.  ``mbarrier``s and bulk copies
follow the phase rules, and a bulk copy lands only when a thread waits on
its barrier, its destination NaN until then, so a read before the wait
shows.  Shared memory starts as NaN and every ``ldmatrix``, descriptor
read and bulk copy is bounds-checked.  After a bf16 launch each block
checks that it consumed every slab of the schedule.

What it cannot show: timing, the compiler's register allocation and
spills, anything of the memory model beyond barrier order.

    python3 tools/torch_k2_emulate.py [--general] [B,T,W,D,H,L[,bf16[,seed]]] ...

(``--general``: the general kernel, every route; else the resident one)
prints, per shape, the largest error of each output against the plain
version (``forward_math``) in f64 and with the path's own rounding, and
the statistic S (rms distance from f64 over the plain bf16 version's).
Without a card the f32 sums differ from torch's in order, and one bf16
rounding that flips moves everything after it: below ~1e-6 the two agree,
above only statistically (S near 1).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.ops.fused_forward import (PackedWeights, forward_math,  # noqa: E402
                                              pack_weights)

SRC = os.path.join(ROOT, "hual_tpu_torch", "csrc", "fused_forward.cu")
OUT = os.path.join(ROOT, "build", "k2_emulate")

RUNTIME_H = r'''// A stand-in CUDA runtime for running device code on the CPU: one
// std::thread per CUDA thread, std::barrier for __syncthreads, a barrier
// per warp for the warp-collective operations.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include <stdexcept>
#include <cstdio>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(a, b)
#define __align__(n) alignas(n)
#define __shared__
#ifndef INFINITY
#define INFINITY (__builtin_inff())
#endif

using std::min;
using std::max;

struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx, blockIdx;
inline Dim3 blockDim{256, 1, 1};

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline long long clock64() { return 0; }

struct EmuBlock {
  std::vector<unsigned char> smem;
  std::unique_ptr<std::barrier<>> block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  // per-warp exchange: 32 lanes x 16 words
  std::vector<uint64_t> xch;
  std::vector<const void*> xptr;
};
inline thread_local EmuBlock* emu_block = nullptr;
inline unsigned char* emu_smem() { return emu_block->smem.data(); }

inline void __syncthreads() { emu_block->block_bar->arrive_and_wait(); }
inline void emu_warp_sync() { emu_block->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }
inline uint64_t* emu_xch() { return emu_block->xch.data() + (threadIdx.x / 32) * 32 * 16; }
inline const void** emu_xptr() { return emu_block->xptr.data() + (threadIdx.x / 32) * 32; }

inline float __shfl_xor_sync(unsigned, float v, int o) {
  uint64_t* x = emu_xch();
  const int l = threadIdx.x % 32;
  x[l * 16] = __float_as_uint(v);
  emu_warp_sync();
  const float r = __uint_as_float(static_cast<uint32_t>(x[(l ^ o) * 16]));
  emu_warp_sync();
  return r;
}

inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const unsigned char*>(p) - emu_smem();
}

template <class F>
inline void emu_launch(int blocks, int threads, int smem_bytes, F&& fn) {
  for (int b = 0; b < blocks; ++b) {
    EmuBlock blk;
    blk.smem.assign(smem_bytes + 64, 0xff);  // NaN everywhere
    blk.block_bar = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w) blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    blk.xch.assign(threads * 16, 0);
    blk.xptr.assign(threads, nullptr);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        emu_block = &blk;
        threadIdx.x = t;
        blockIdx.x = b;
        fn();
      });
    for (auto& th : ts) th.join();
  }
}
'''

PTX_H = r'''// Emulated bodies of the PTX helpers (see emu.py).
#pragma once
#include <mutex>
#include <condition_variable>
#include <unordered_map>
#include <deque>

inline uint32_t emu_bf16(float f) {  // round to nearest even
  uint32_t u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}
inline float emu_bf16f(uint16_t v) { return __uint_as_float(static_cast<uint32_t>(v) << 16); }

struct EmuBar {
  int count = 0, pending = 0;
  long long tx = 0;
  long long phase = 0;
  struct Copy { void* dst; const void* src; unsigned bytes; };
  std::deque<Copy> copies;
};
inline std::mutex emu_mu;
inline std::condition_variable emu_cv;
inline std::unordered_map<const void*, EmuBar> emu_bars;

inline void emu_bar_check(EmuBar& b) {
  if (b.pending == 0 && b.tx == 0 && b.copies.empty()) {
    b.phase++;
    b.pending = b.count;
    emu_cv.notify_all();
  }
}

inline void emu_hmma(float& d0, float& d1, float& d2, float& d3, const uint32_t (&a)[4],
                     uint32_t b0, uint32_t b1) {
  uint64_t* x = emu_xch();
  const int l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) x[l * 16 + i] = a[i];
  x[l * 16 + 4] = b0;
  x[l * 16 + 5] = b1;
  emu_warp_sync();
  const int g = l / 4, t = l % 4;
  auto A = [&](int r, int c) {
    const uint32_t w = static_cast<uint32_t>(x[((r % 8) * 4 + (c % 8) / 2) * 16 + (r / 8) + 2 * (c / 8)]);
    return emu_bf16f(static_cast<uint16_t>(w >> (16 * (c % 2))));
  };
  auto B = [&](int k, int n) {
    const uint32_t w = static_cast<uint32_t>(x[(n * 4 + (k % 8) / 2) * 16 + 4 + k / 8]);
    return emu_bf16f(static_cast<uint16_t>(w >> (16 * (k % 2))));
  };
  float* d[4] = {&d0, &d1, &d2, &d3};
  for (int h = 0; h < 2; ++h)
    for (int q = 0; q < 2; ++q) {
      double s = 0;
      for (int k = 0; k < 16; ++k) s += static_cast<double>(A(g + 8 * h, k)) * B(k, 2 * t + q);
      *d[2 * h + q] = static_cast<float>(*d[2 * h + q] + s);
    }
  emu_warp_sync();
}

inline void emu_dmma(double (&d)[4], double a0, double a1, double b0) {
  uint64_t* x = emu_xch();
  const int l = threadIdx.x % 32;
  double* xd = reinterpret_cast<double*>(x);
  xd[l * 16] = a0;
  xd[l * 16 + 1] = a1;
  xd[l * 16 + 2] = b0;
  emu_warp_sync();
  const int g = l / 4, t = l % 4;
  for (int h = 0; h < 2; ++h)
    for (int q = 0; q < 2; ++q) {
      const int r = g + 8 * h, n = 2 * t + q;
      double s = 0;
      for (int k = 0; k < 4; ++k) s += xd[((r % 8) * 4 + k) * 16 + r / 8] * xd[(n * 4 + k) * 16 + 2];
      d[2 * h + q] += s;
    }
  emu_warp_sync();
}

inline void emu_check_smem(const void* p, size_t bytes) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < emu_smem() || c + bytes > emu_smem() + emu_block->smem.size() - 64) {
    std::fprintf(stderr, "shared memory access out of bounds: offset %ld\n", long(c - emu_smem()));
    std::abort();
  }
}

inline void emu_ldsm(uint32_t (&r)[4], const void* row, bool trans) {
  const void** xp = emu_xptr();
  const int l = threadIdx.x % 32;
  emu_check_smem(row, 16);
  if ((reinterpret_cast<uintptr_t>(row) - reinterpret_cast<uintptr_t>(emu_smem())) % 16) {
    std::fprintf(stderr, "ldmatrix row not 16-byte aligned\n");
    std::abort();
  }
  xp[l] = row;
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!trans) {
      const uint16_t* p = static_cast<const uint16_t*>(xp[8 * i + l / 4]);
      lo = p[2 * (l % 4)];
      hi = p[2 * (l % 4) + 1];
    } else {
      lo = static_cast<const uint16_t*>(xp[8 * i + 2 * (l % 4)])[l / 4];
      hi = static_cast<const uint16_t*>(xp[8 * i + 2 * (l % 4) + 1])[l / 4];
    }
    r[i] = lo | (static_cast<uint32_t>(hi) << 16);
  }
  emu_warp_sync();
}

template <int NR>
inline void emu_wgmma(float (&d)[NR], uint64_t da, uint64_t db, int scale_d) {
  const int tid = threadIdx.x % 128, w = tid / 32, l = tid % 32, g = l / 4, t = l % 4;
  auto dec = [](uint64_t desc, int r, int k) {
    if ((desc >> 49) != 0) { std::fprintf(stderr, "descriptor: swizzle/base bits set\n"); std::abort(); }
    const unsigned char* start = emu_smem() + ((desc & 0x3fff) << 4);
    const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
    const unsigned char* p = start + (r / 8) * sbo + (k / 8) * lbo + (r % 8) * 16 + (k % 8) * 2;
    emu_check_smem(p, 2);
    return emu_bf16f(*reinterpret_cast<const uint16_t*>(p));
  };
  for (int j = 0; j < NR / 4; ++j)
    for (int h = 0; h < 2; ++h)
      for (int q = 0; q < 2; ++q) {
        const int row = 16 * w + g + 8 * h, col = 8 * j + 2 * t + q;
        double s = 0;
        for (int k = 0; k < 16; ++k) s += static_cast<double>(dec(da, row, k)) * dec(db, col, k);
        float& o = d[4 * j + 2 * h + q];
        o = static_cast<float>((scale_d ? static_cast<double>(o) : 0.0) + s);
      }
}

inline void emu_mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> lk(emu_mu);
  EmuBar& b = emu_bars[bar];
  b = EmuBar{};
  b.count = b.pending = static_cast<int>(count);
}

inline void emu_mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> lk(emu_mu);
  for (;;) {
    EmuBar& b = emu_bars.at(bar);
    if (!b.copies.empty()) {
      while (!b.copies.empty()) {
        auto c = b.copies.front();
        b.copies.pop_front();
        std::memcpy(c.dst, c.src, c.bytes);
        b.tx -= c.bytes;
      }
      emu_bar_check(b);
    }
    if ((b.phase & 1) != static_cast<long long>(parity)) return;
    emu_cv.wait(lk);
  }
}

inline void emu_bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  emu_check_smem(dst, bytes);
  if (bytes % 16 || reinterpret_cast<uintptr_t>(src) % 16 ||
      (static_cast<unsigned char*>(dst) - emu_smem()) % 16) {
    std::fprintf(stderr, "bulk copy not 16-byte aligned\n");
    std::abort();
  }
  std::lock_guard<std::mutex> lk(emu_mu);
  EmuBar& b = emu_bars.at(bar);
  b.tx += bytes;
  std::memset(dst, 0xff, bytes);  // NaN until the copy lands
  b.copies.push_back({dst, src, bytes});
  if (--b.pending < 0) { std::fprintf(stderr, "mbarrier: too many arrivals\n"); std::abort(); }
}
'''

BODIES = {
    "dmma_16x8x4": "emu_dmma(d, a0, a1, b0);",
    "hmma4": "emu_hmma(d0, d1, d2, d3, a, b0, b1);",
    "bf16x2": "return emu_bf16(lo) | (emu_bf16(hi) << 16);",
    "cp_async": "if (valid) std::memcpy(dst, src, N); else std::memset(dst, 0, N);",
    "cp_async_commit": "",
    "cp_async_wait": "",
    "ldsm_x4": "emu_ldsm(r, row, false);",
    "ldsm_x4_t": "emu_ldsm(r, row, true);",
    "wgmma_fence": "", "wgmma_commit": "", "wgmma_wait": "", "reg_fence": "(void)d;",
    "fence_proxy_async": "", "fence_mbar_init": "",
    "mbar_init": "emu_mbar_init(bar, count);",
    "mbar_wait": "emu_mbar_wait(bar, parity);",
    "bulk_copy": "emu_bulk_copy(dst, src, bytes, bar);",
    "wgmma_m64n64k16": "emu_wgmma<32>(d, da, db, scale_d);",
    "wgmma_m64n128k16": "emu_wgmma<64>(d, da, db, scale_d);",
}



def _replace_body(src: str, name: str, body: str) -> str:
    m = re.search(r"__device__[^;{]*?\b" + name + r"\s*\(", src)
    if not m:
        raise SystemExit(f"torch_k2_emulate: no definition of {name}")
    i = src.index("{", m.end())
    depth, j = 0, i
    while True:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            break
        j += 1
    return src[:i] + "{\n  " + body + "\n}" + src[j + 1:]


SMEM_LIMIT = "constexpr long kSmemLimit = 232448;"


def emulated_source(src: str, smem_limit: int | None = None, general: bool = False) -> str:
    """The kernel's source with the PTX helpers' bodies emulated, the
    launch a loop over blocks and a check of the ring's slabs; ``general``
    builds the general kernel (every route: ``csrc/fused_forward_general.cu``),
    else the resident one; with ``smem_limit`` the kernel's shared-memory
    budget (kSmemLimit) is that many bytes, so that its tiled routes open at
    shapes the emulator can afford."""
    if general:
        src = "#define K2_GENERAL 1\n" + src
    if smem_limit is not None:
        if SMEM_LIMIT not in src:
            raise SystemExit(f"torch_k2_emulate: text not in the source: {SMEM_LIMIT!r}")
        src = src.replace(SMEM_LIMIT, f"constexpr long kSmemLimit = {int(smem_limit)};")
    for name, body in BODIES.items():
        src = _replace_body(src, name, body)
    src = src.replace("#include <cuda_runtime.h>",
                      '#include <cuda_runtime.h>\n#include "emu_ptx.h"', 1)
    edits = [("  extern __shared__ __align__(16) float smem[];",
              "  float* smem = reinterpret_cast<float*>(emu_smem());"),
             ("  fused_forward_kernel<kBf16, kGen><<<B, kThreads, smem, stream>>>(p);",
              "  emu_launch(B, kThreads, smem, [&] { fused_forward_kernel<kBf16, kGen>(p); });"),
             ("                 p.end_logits + static_cast<long>(b) * T);\n}",
              "                 p.end_logits + static_cast<long>(b) * T);\n"
              "  if constexpr (kBf16)\n"
              "    if (x.slab != x.nsched) {\n"
              "      std::fprintf(stderr, \"consumed %d slabs of %d\\n\", x.slab, x.nsched);\n"
              "      std::abort();\n"
              "    }\n}")]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"torch_k2_emulate: text not in the source: {old[:60]!r}")
        src = src.replace(old, new)
    left = [line for line in src.splitlines()
            if re.search(r"\basm\b", line) and not line.strip().startswith("//")]
    if left:
        raise SystemExit(f"torch_k2_emulate: PTX left in the source: {left[:3]}")
    return src


def build(out_dir: str = OUT, src_path: str = SRC, smem_limit: int | None = None,
          general: bool = False) -> str:
    """Compile the emulated source (see :func:`emulated_source`) with g++
    into ``out_dir`` (once per source: processes that ask at the same time
    wait on a lock there for the first one's build); returns the library's
    path."""
    src = emulated_source(open(src_path).read(), smem_limit, general)
    digest = hashlib.sha256((src + RUNTIME_H + PTX_H).encode()).hexdigest()[:16]
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libk2_emulated-{digest}.so")
    with open(os.path.join(out_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):
            return lib
        for name, text in (("cuda_runtime.h", RUNTIME_H), ("emu_ptx.h", PTX_H),
                           ("k2_emulated.cpp", src)):
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(text)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
                               "-w", "-I", out_dir, "-o", tmp,
                               os.path.join(out_dir, "k2_emulated.cpp")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"torch_k2_emulate: g++ failed:\n{proc.stderr[-6000:]}")
        os.replace(tmp, lib)
    return lib


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fused_forward_f32.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.fused_forward_bf16.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p] * 8 + tail)
    lib.fused_forward_workspace_floats.restype = ctypes.c_longlong
    lib.fused_forward_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.fused_forward_takes.argtypes = [ctypes.c_int] * 5
    lib.fused_forward_takes.restype = ctypes.c_int
    lib.fused_forward_routes.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fused_forward_routes.restype = None
    return lib


ROUTE_KEYS = ("f64_attention", "f64_heads", "f64_masks_smem", "bf16_heads",
              "bf16_cq_tile", "bf16_masks_smem")


def routes(lib, T: int, W: int, D: int, H: int) -> dict:
    """The routes the library's kernel takes at this shape
    (``fused_forward_routes``)."""
    out = (ctypes.c_int * len(ROUTE_KEYS))()
    lib.fused_forward_routes(T, W, D, H, out)
    return dict(zip(ROUTE_KEYS, out))


def call(lib, packed: PackedWeights, vf, qf, v_mask, q_mask, *, num_heads: int,
         mxu_bf16: bool, tau: float = 0.3, use_gumbel: bool = False):
    """K2 on CPU tensors through the emulated library: (start_logits,
    end_logits, match_scores)."""
    B, T, D = vf.shape
    W = qf.shape[1]
    outs = [torch.full((B, T), float("nan")), torch.full((B, T), float("nan")),
            torch.full((B, T, 4), float("nan"))]
    ws = torch.full((B * lib.fused_forward_workspace_floats(T, W, D, num_heads),),
                    float("nan"))
    rest = ([t.data_ptr() for t in (vf, qf, v_mask, q_mask, *outs, ws)]
            + [B, T, W, D, num_heads, packed.attn_layer, packed.max_pos, tau,
               int(use_gumbel), None])
    if mxu_bf16:
        rc = lib.fused_forward_bf16(
            packed.buffer.data_ptr(), packed.bf16.data_ptr(), packed.schedule.data_ptr(),
            packed.schedule.shape[0], packed.bf16_layout["matching_head/dense/kernel"][0],
            packed.bf16_layout["label_emb"][0], *rest)
    else:
        rc = lib.fused_forward_f32(packed.buffer.data_ptr(), *rest)
    if rc != 0:
        raise RuntimeError(f"torch_k2_emulate: the entry point returned {rc}")
    return tuple(outs)


def case(B: int, T: int, W: int, D: int, H: int, L: int, seed: int = 0):
    """A seeded model and inputs: (packed, vf, qf, v_mask, q_mask, kw);
    sample 0 unmasked, the others of random lengths."""
    model = SeqPAN(vdim=16, dim=D, num_heads=H, attn_layer=L, max_vlen=max(T, W),
                   word_dim=300, char_dim=8, num_chars=20,
                   generator=torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed)
    vf = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32))
    qf = torch.from_numpy(rng.normal(size=(B, W, D)).astype(np.float32))
    vl, ql = rng.integers(1, T + 1, B), rng.integers(1, W + 1, B)
    vl[0], ql[0] = T, W
    v_mask = torch.from_numpy((np.arange(T)[None] < vl[:, None]).astype(np.int32))
    q_mask = torch.from_numpy((np.arange(W)[None] < ql[:, None]).astype(np.int32))
    kw = dict(attn_layer=L, num_heads=H, tau=0.3, use_gumbel=False)
    return pack_weights(model), vf, qf, v_mask, q_mask, kw


def compare(lib, B, T, W, D, H, L, mxu_bf16: bool, seed: int = 0) -> dict:
    """Per output: the largest error against the plain version in f64
    (``exact``) and against the plain version with the path's rounding in
    f32 (``plain``), and S."""
    packed, vf, qf, vm, qm, kw = case(B, T, W, D, H, L, seed)
    got = call(lib, packed, vf, qf, vm, qm, num_heads=H, mxu_bf16=mxu_bf16)
    p64 = PackedWeights(packed.buffer.double(), packed.layout, L)
    exact = forward_math(p64, vf.double(), qf.double(), vm, qm, **kw)
    plain = forward_math(packed, vf, qf, vm, qm, **kw, mxu_bf16=mxu_bf16)
    out = {}
    for name, x, e, p in zip(("start_logits", "end_logits", "match_scores"),
                             got, exact, plain):
        d, dp = x.double() - e, p.double() - e
        out[name] = {"exact": d.abs().max().item(),
                     "plain": (x.double() - p.double()).abs().max().item(),
                     "S": (d.square().mean().sqrt() / dp.square().mean().sqrt()).item()
                     if mxu_bf16 else None,
                     "finite": bool(torch.isfinite(x).all())}
    return out


def main(argv: list[str]) -> None:
    general = argv[:1] == ["--general"]
    argv = argv[1:] if general else argv
    lib = load(build(general=general))
    for arg in argv or ["2,17,5,32,4,1,1", "2,17,5,32,4,1,0"]:
        v = [int(a) for a in arg.split(",")]
        shape, bf16, seed = v[:6], bool(v[6]) if len(v) > 6 else True, v[7] if len(v) > 7 else 0
        res = compare(lib, *shape, mxu_bf16=bf16, seed=seed)
        print(f"{arg} {'bf16' if bf16 else 'f64'}: " + "; ".join(
            f"{k} exact {r['exact']:.3g} plain {r['plain']:.3g}"
            + (f" S {r['S']:.3f}" if r["S"] is not None else "") for k, r in res.items()),
            flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
