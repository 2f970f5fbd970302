#!/usr/bin/env python3
"""Probe where K2 (``hual_tpu_torch/csrc/fused_forward.cu``) spends its time
on one NVIDIA GPU.  Each mode builds a copy of the kernel's source with nvcc
into ``build/k2_probe/`` (the kernel in the package is left as it is):

* ``timeline [--mxu-bf16]``: a copy with a ``clock64()`` stamp after every
  block-level barrier of the source (2- or 4-space indented
  ``__syncthreads();``); runs (1,64,13) and (96,64,13) at Charades width on
  the default path, or on the bf16 path with ``--mxu-bf16``, and prints,
  per barrier line, the cycles of block 0 spent since the previous stamp,
  largest first.
* ``variants``: copies with named text substitutions (``VARIANTS``), built in
  parallel; prints ptxas's registers and spills and the CUDA-event time of a
  call at (1,64,13), (96,64,13) and (32,100,30), and the largest error
  against the plain version in f64.
* ``dense``: one ``dense()`` of D=128 alone in a loop, 64 and 13 rows, on 1
  and 96 blocks, in cycles per call beside its DMMA bound; and the same
  with the DMMA loop replaced by a plain FMA (``nodmma``) and with the
  staging skipped (``nostage``).
* ``dmma``: the rates of ``mma.sync m16n8k4`` and ``m16n8k16`` in f64 with
  operands in registers, and of f32 -> f64 conversion, on one SM with 4
  and 8 warps.

Run from the repository root: ``python3 tools/torch_k2_probe.py timeline``
(or ``timeline --mxu-bf16``, ``variants``, ``dense``, ``dmma``).  Needs the
card and nvcc; prints text.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.ops.fused_forward import PackedWeights, forward_math, pack_weights  # noqa: E402
from hual_tpu_torch.ops.kernels import build  # noqa: E402

SRC = os.path.join(ROOT, "hual_tpu_torch", "csrc", "fused_forward.cu")
OUT = os.path.join(ROOT, "build", "k2_probe")
KW = dict(attn_layer=2, num_heads=8, tau=0.3, use_gumbel=False)

_UNROLL = "#pragma unroll 2\n          for (int kk = 0; kk < steps; ++kk) {"
_HEADS = "      if (H % heads == 0 && floats() <= limit) return;"
# name -> [(text in the source, replacement)]
VARIANTS = {
    "as_is": [],
    "unroll4": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))],
    "unroll1": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))],
    "heads<=2": [(_HEADS, _HEADS.replace("H % heads", "heads <= 2 && H % heads"))],
    "heads<=1": [(_HEADS, _HEADS.replace("H % heads", "heads <= 1 && H % heads"))],
}


def nvcc(cu: str, so: str) -> subprocess.Popen:
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.Popen([os.path.join(CUDA_HOME, "bin", "nvcc"), *build.NVCC_FLAGS,
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def model_packed(T: int) -> PackedWeights:
    cfg = {k: v for k, v in chip_smoke.CHARADES.items() if k not in ("name", "max_tlen")}
    model = SeqPAN(**cfg | {"num_chars": 60, "max_vlen": T},
                   generator=torch.Generator().manual_seed(1)).cuda().eval()
    return pack_weights(model)


def bind(so: str):
    lib = ctypes.CDLL(so)
    tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fused_forward_f32.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.fused_forward_bf16.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p] * 8 + tail)
    lib.fused_forward_workspace_floats.restype = ctypes.c_longlong
    lib.fused_forward_workspace_floats.argtypes = [ctypes.c_int] * 4
    return lib


def call(lib, packed, args, B, T, W, mxu_bf16=False):
    outs = [torch.empty(B, T, device="cuda"), torch.empty(B, T, device="cuda"),
            torch.empty(B, T, 4, device="cuda")]
    ws = torch.empty(B * lib.fused_forward_workspace_floats(T, W, 128, 8), device="cuda")
    rest = ([a.data_ptr() for a in args] + [o.data_ptr() for o in outs]
            + [ws.data_ptr(), B, T, W, 128, 8, 2, packed.max_pos, 0.3, 0])

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if mxu_bf16:
            rc = lib.fused_forward_bf16(
                packed.buffer.data_ptr(), packed.bf16.data_ptr(),
                packed.schedule.data_ptr(), packed.schedule.shape[0],
                packed.bf16_layout["matching_head/dense/kernel"][0],
                packed.bf16_layout["label_emb"][0], *rest, stream)
        else:
            rc = lib.fused_forward_f32(packed.buffer.data_ptr(), *rest, stream)
        assert rc == 0, f"CUDA error {rc}"
    return run, outs


def timeline(mxu_bf16: bool = False) -> None:
    src = open(SRC).read()
    out = []
    for i, line in enumerate(src.splitlines()):
        out.append(line)
        if re.fullmatch(r"( {2}| {4})__syncthreads\(\);.*", line):
            out.append(f"{line[:len(line) - len(line.lstrip())]}STAMP({i + 1});")
    text = "\n".join(out).replace("namespace {\n", """namespace {
__device__ long long g_t[4096];
__device__ int g_l[4096];
__device__ int g_n;
#define STAMP(l) do { if (threadIdx.x == 0 && blockIdx.x == 0 && g_n < 4096) { \\
  g_t[g_n] = clock64(); g_l[g_n] = l; ++g_n; } } while (0)
""", 1) + """
extern "C" int timed_dump(long long* t, int* l) {
  int n;
  cudaMemcpyFromSymbol(&n, g_n, sizeof(int));
  cudaMemcpyFromSymbol(t, g_t, sizeof(long long) * 4096);
  cudaMemcpyFromSymbol(l, g_l, sizeof(int) * 4096);
  const int z = 0;
  cudaMemcpyToSymbol(g_n, &z, sizeof(int));
  return n;
}
"""
    cu, so = os.path.join(OUT, "timed.cu"), os.path.join(OUT, "libtimed.so")
    open(cu, "w").write(text)
    log, _ = nvcc(cu, so).communicate()
    lib = bind(so)
    packed, lines = model_packed(64), src.splitlines()
    for B in (1, 96):
        args = chip_smoke.k2_inputs(B, 64, 13, np.random.default_rng(0))
        run, _ = call(lib, packed, args, B, 64, 13, mxu_bf16)
        t, l = np.zeros(4096, np.int64), np.zeros(4096, np.int32)
        for _ in range(3):
            lib.timed_dump(t.ctypes.data, l.ctypes.data)
            run()
            torch.cuda.synchronize()
            n = lib.timed_dump(t.ctypes.data, l.ctypes.data)
        agg: dict[int, list] = {}
        for dt, line in zip(np.diff(t[:n]), l[1:n]):
            agg.setdefault(int(line), [0, 0])
            agg[int(line)][0] += int(dt)
            agg[int(line)][1] += 1
        total = t[n - 1] - t[0]
        print(f"{'bf16' if mxu_bf16 else 'f64'} path, B={B} T=64 W=13: {total} "
              "cycles from the first barrier to the last", flush=True)
        for line, (cyc, k) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:30]:
            print(f"  line {line:4d} x{k:3d} {cyc:9d} cycles {100 * cyc / total:5.1f}%  "
                  f"{lines[line - 3].strip()[:60]} | {lines[line - 2].strip()[:50]}")


def variants() -> None:
    src = open(SRC).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"variant {name}: text not in the source: {a[:60]!r}")
            text = text.replace(a, b)
        stem = re.sub(r"\W", "_", name)
        cu, so = os.path.join(OUT, f"v_{stem}.cu"), os.path.join(OUT, f"libv_{stem}.so")
        open(cu, "w").write(text)
        procs[name] = (nvcc(cu, so), so)
    packs = {T: model_packed(T) for T in (64, 100)}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "nvcc failed\n", log[-3000:])
            continue
        print(name, chip_smoke.ptxas_resources(log), flush=True)
        lib = bind(so)
        for B, T, W in ((1, 64, 13), (96, 64, 13), (32, 100, 30)):
            args = chip_smoke.k2_inputs(B, T, W, np.random.default_rng(0))
            run, outs = call(lib, packs[T], args, B, T, W)
            ms, _ = chip_smoke.device_times_ms(run, per_round=10, warmup=2)
            p = packs[T]
            ref = forward_math(PackedWeights(p.buffer.double(), p.layout, 2),
                               *(a.double() if a.is_floating_point() else a for a in args), **KW)
            err = max((outs[i].double() - ref[i]).abs().max().item() for i in range(3))
            print(f"   {name} B={B} T={T} W={W}: {ms:.4f} ms, max err {err:.3g}", flush=True)


DENSE_BENCH = r'''
namespace {
__global__ void __launch_bounds__(kThreads, 1)
    bench_dense(const float* A, const float* Wt, float* Y, int M, int reps, long long* cyc) {
  extern __shared__ __align__(16) float smem[];
  const SmemLayout lay(64, 13, 128, 8);
  Ctx x;
  x.T = 64; x.W = 13; x.D = 128; x.H = 8; x.Lm = 64;
  x.stage = smem; x.stage_floats = lay.a_floats + lay.b_floats; x.a_floats = lay.a_floats;
  x.S = smem + lay.region; x.lds = lay.score_ld; x.heads = lay.heads;
  const float* a = A + blockIdx.x * 64L * 128;
  float* y = Y + blockIdx.x * 64L * 128;
  __syncthreads();
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    dense<false, false>(a, 128, M, 128, 128, Dense{Wt, nullptr}, x,
          [=](int m, int n, float v, float) { y[m * 128 + n] = v; });
    __syncthreads();
  }
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
}
}  // namespace
extern "C" int run_bench(const float* A, const float* Wt, float* Y, int M, int reps,
                         long long* cyc, int blocks) {
  const int smem = static_cast<int>(fused_forward_smem_bytes(64, 13, 128, 8));
  cudaFuncSetAttribute(bench_dense, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bench_dense<<<blocks, kThreads, smem>>>(A, Wt, Y, M, reps, cyc);
  cudaDeviceSynchronize();
  return static_cast<int>(cudaGetLastError());
}
'''


def dense() -> None:
    src = open(SRC).read()
    loop = ("                if (i < mi_n && j < nj_n)  // warp-uniform\n"
            "                  dmma_16x8x4(acc[i][j], av[i][0], av[i][1], bv[j]);")
    stage_a = "        stage_tile(st, kSlabLd, a.p, a.ld, m0, rows, M, k0, kSlabShift, K, a_vec);"
    stage_b = "        else\n          stage_tile(st + a_floats, bld, b.p, b.ld, k0, kSlab, K, n0,"
    for text in (loop, stage_a, stage_b):
        if text not in src:
            raise SystemExit(f"dense: text not in the source: {text[:60]!r}")
    texts = {"as_is": src,
             "nodmma": src.replace(loop, "                if (i < mi_n && j < nj_n) "
                                         "acc[i][j][0] += av[i][0] * bv[j];"),
             "nostage": src.replace(stage_a, "        if (k0 < 0)\n" + stage_a)
                           .replace(stage_b, stage_b.replace("else\n", "else if (k0 < 0)\n"))}
    procs = {}
    for name, text in texts.items():
        cu, so = os.path.join(OUT, f"dense_{name}.cu"), os.path.join(OUT, f"libdense_{name}.so")
        open(cu, "w").write(text + DENSE_BENCH)
        procs[name] = (nvcc(cu, so), so)
    a = torch.randn(96 * 64 * 128, device="cuda")
    w = torch.randn(128 * 128, device="cuda")
    y = torch.zeros(96 * 64 * 128, device="cuda")
    cyc = torch.zeros(96, dtype=torch.int64, device="cuda")
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "nvcc failed\n", log[-3000:])
            continue
        lib = ctypes.CDLL(so)
        lib.run_bench.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                  + [ctypes.c_void_p, ctypes.c_int])
        for M in (64, 13):
            for blocks in (1, 96):
                reps = 200
                rc = lib.run_bench(a.data_ptr(), w.data_ptr(), y.data_ptr(), M, reps,
                                   cyc.data_ptr(), blocks)
                c = cyc[:blocks].double().mean().item() / reps
                # m16n8k4 DMMAs, 4 sub-partitions at 16 cycles each
                bound = ((M + 15) // 16) * (128 // 8) * (128 // 4) * 16 / 4
                print(f"{name} M={M} blocks={blocks}: {c:.0f} cycles a dense "
                      f"(DMMA bound {bound:.0f}), rc {rc}", flush=True)


DMMA_BENCH = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ void k4(double (&d)[4], double a0, double a1, double b0) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
               "{%0,%1,%2,%3};\n" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a0), "d"(a1), "d"(b0));
}
__device__ __forceinline__ void k16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                 "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
// kKind 0: m16n8k4, 1: m16n8k16, 2: f32 -> f64 conversions; 8 independent chains a thread
template <int kKind>
__global__ void bench(double* out, long long* cyc, int iters, const float* in) {
  double acc[8][4] = {};
  double a[8], b[4];
  float f[8];
  for (int i = 0; i < 8; ++i) { a[i] = threadIdx.x * 1e-3 + i; f[i] = in[i]; }
  for (int i = 0; i < 4; ++i) b[i] = threadIdx.x * 2e-3 + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kKind == 0) k4(acc[j], a[0], a[1], b[0]);
      else if (kKind == 1) k16(acc[j], a, b);
      else { acc[j][0] += static_cast<double>(f[j]); f[j] += 1.0f; }
    }
  __syncthreads();
  const long long t1 = clock64();
  double s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][3];
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}
extern "C" long long run(int kind, int threads, int iters, double* out, long long* cyc,
                         const float* in) {
  for (int rep = 0; rep < 2; ++rep) {  // the second launch is timed
    if (kind == 0) bench<0><<<1, threads>>>(out, cyc, iters, in);
    else if (kind == 1) bench<1><<<1, threads>>>(out, cyc, iters, in);
    else bench<2><<<1, threads>>>(out, cyc, iters, in);
  }
  long long h = 0;
  cudaMemcpy(&h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  return cudaGetLastError() ? -1 : h;
}
'''


def dmma() -> None:
    cu, so = os.path.join(OUT, "dmma.cu"), os.path.join(OUT, "libdmma.so")
    open(cu, "w").write(DMMA_BENCH)
    log, _ = nvcc(cu, so).communicate()
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.run.restype = ctypes.c_longlong
    out = torch.zeros(1024, dtype=torch.float64, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    src = torch.zeros(8, device="cuda")
    iters = 4096
    for threads in (128, 256):
        for kind, name, fma in ((0, "m16n8k4", 512), (1, "m16n8k16", 2048), (2, "f32->f64 and an f64 add", 0)):
            n = iters // (4 if kind == 1 else 1)
            h = lib.run(kind, threads, n, out.data_ptr(), cyc.data_ptr(), src.data_ptr())
            ops = n * 8 * threads // (32 if kind < 2 else 1)
            rate = (f"{ops * fma / h:.1f} f64 FMA/clk/SM, {h / ops * 4:.2f} cycles an mma a "
                    f"sub-partition" if kind < 2 else f"{ops / h:.2f} conversions/clk/SM (with the adds)")
            print(f"{name} threads={threads}: {rate}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_probe: needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    modes = {"timeline": timeline, "variants": variants, "dense": dense, "dmma": dmma}
    args = sys.argv[1:]
    bf16 = args[1:] == ["--mxu-bf16"]
    if not args or args[0] not in modes or (args[1:] and not (bf16 and args[0] == "timeline")):
        raise SystemExit(f"usage: {sys.argv[0]} {'|'.join(modes)} (timeline [--mxu-bf16])")
    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    modes[args[0]](*([True] if bf16 else []))


if __name__ == "__main__":
    main()
