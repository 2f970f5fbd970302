// Fused deterministic SeqPAN forward on Hopper (K2): everything after the
// input projections, for one sample per thread block, in one launch:
//   shared pos-emb + 4-layer conv block on both streams
//   -> attn_layer x dual attention, both directions
//   -> CQ attention both ways, weighted pooling, cq_cat dense
//   -> matching softmax (1/tau with gumbel on) and the soft label embedding
//   -> conditioned predictor: feature encoder twice, start/end LN, ReLU
//      hidden layer, dense.
// Outputs start_logits (B,T), end_logits (B,T), match_scores (B,T,4), f32.
//
// Replaces the TPU kernel hual_tpu/ops/pallas/fused_forward.py::_kernel
// (pl.pallas_call in fused_call), whose math is _forward_math.  That kernel
// computes a block of samples at once with block-diagonal attention,
// one-hot matmuls for reshapes and padding of B to the block size; all of
// that exists for Mosaic's layout rules and is not carried over.  Here each
// sample is one thread block, so samples never mix and B may be any size.
//
// The plain version is hual_tpu_torch/ops/fused_forward.py::forward_math;
// the weights are one f32 buffer packed by pack_weights, read here in the
// order of pack_order (a cursor walks it).
//
// Bound on the H100: operations.  About 161 MFLOP a sample at Charades
// width (T=64, W=13, D=128, 8 heads, 2 layers), 15.5 GFLOP at B=96, i.e.
// 0.23 ms at 67 TFLOP/s (the f64 peak of the tensor cores) on the f64
// path, 0.0156 ms at 989 TFLOP/s (the dense bf16 peak) on the bf16 path;
// the bytes (3.9 MB of packed weights, 4.0 MB of inputs and outputs at
// B=96) take ~2.4 us at 3.35 TB/s.
//
// Design.  One block of 8 warps per sample walks every stage, with
// __syncthreads() between them.
// - Two product paths, chosen per launch (the JAX kernel's mxu_bf16): a
//   template flag kBf16 of the kernel, threaded through the stages to the
//   product routines (gemm, gemm_smem, narrow_dense); everything else is
//   shared source, and the f64 instantiation has no branch of the other
//   path (a runtime switch cost it 3%, PERF.md).  Every product at
//   least 8 outputs wide (the dense layers, the conv blocks' pointwise
//   layers, each head's q.k^T and p.v, the CQ trilinear and its three
//   products, cq_cat, the predictor's hidden layers) runs on the tensor
//   cores, inline PTX below:
//   * f64 (the default): mma.sync m16n8k4 in f64 (DMMA).  The f32 operands
//     convert exactly to f64, products and sums run in f64 and each output
//     is rounded to f32 once, in the epilogue: the match scores' parity
//     bound (atol 1e-5, at the edge of an f32 forward) needs f64 sums, and
//     DMMA gives them at twice the f64 rate of the CUDA cores.  TF32 keeps
//     too few bits, and wgmma has no f64 form.  Fragments (CUTLASS's
//     SM90_16x8x4_F64F64F64F64_TN): lane l, g = l/4, t = l%4, holds
//     A[g][t], A[g+8][t], B[t][g] and C[g][2t], C[g][2t+1], C[g+8][2t],
//     C[g+8][2t+1].
//   * bf16 (mxu_bf16): mma.sync m16n8k16 with bf16 operands and f32 sums
//     (HMMA): each f32 operand is rounded to nearest even bf16 as its
//     fragment is loaded (cvt.rn.bf16x2), k steps by 16, and the f32
//     accumulators go through the same epilogues.  Fragments (CUTLASS's
//     SM80_16x8x16_F32BF16BF16F32_TN): A[g][2t..2t+1], A[g+8][2t..2t+1],
//     A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]; B[2t..2t+1][g],
//     B[2t+8..2t+9][g]; C as above.  The products that round follow the
//     JAX kernel's mm/mmt: also the matching head and the soft label
//     embedding (CUDA cores, operands rounded); the pooling, the tile, the
//     row dots and the final (D,1) denses are elementwise sums or layout
//     moves there and stay f32.  The attention scale multiplies the f32
//     sum, after the product, as in JAX.  Zero fill covers ragged k (hd=8,
//     Tk=13).
// - Each warp owns a 32x32 tile of outputs (2x4 fragments, 32 f64
//   accumulators); the 8 warps cover 64x128, 128x64 or 256x32 outputs a
//   pass, by the product's width, and skip fragments wholly past M or N.
// - Operands in shared memory.  The activation rows and the weight are
//   staged in k-slabs of 64 f32 with cp.async (16-byte copies where the
//   rows allow, 4-byte copies with zero fill otherwise), double-buffered,
//   so the next slab's copy overlaps this slab's mma.  Rows are padded (68
//   or PN+8 floats) so that fragment loads are free of bank conflicts.
//   Each fragment is converted to f64 in the k-loop and used by the warp's
//   2 or 4 mma that take it.  Measured on the H100 (PERF.md), this beat an
//   f64 copy of the packed weights (twice the staged bytes), converting
//   each slab once in a pass over shared memory, and converting with
//   integer operations.  Zero fill pads every ragged tile (T=100, W=13,
//   Tk=13): padded k reads zeros, padded outputs are never stored, and no
//   padded column enters a softmax.
// - Attention in shared memory: q, k and v are copied there once a call
//   (over the stages, which are free between products); then a group of
//   heads at a time (as many as fit: 4 of 8 at T=64, 1 at T=100; see
//   fused_forward_heads_per_group) gets its Tq x Tk scores there, the
//   masked softmax over the real Tk (8 lanes a row), and p.v, with both
//   operands read in place and no barrier inside a product: the warps take
//   (head, tile) jobs in turn.
// - The activations between stages stay in a per-sample workspace in
//   device memory (fused_forward_workspace_floats: 0.49 MB a sample at
//   T=64, 0.83 MB at T=100): 13 buffers of Lm x D, shared by activations
//   whose lifetimes do not overlap, the CQ attention's four Lm x Lm
//   matrices and 5 small vectors, read back through L1 and L2.
// - Narrow products stay on the CUDA cores, summed in f64: the matching
//   head (N=4) and the final (D,1) denses; the pooling and trilinear dots
//   in f32.  LayerNorm holds a row in registers (a float4 a
//   lane); the depthwise conv and the elementwise stages go 4 channels a
//   thread.
// - Each bilinear of a dual-attention layer is one product with K = 2D:
//   out and the guided output share a buffer as the two halves of each
//   row, and the packed dense_1 and dense_2 kernels are adjacent, so
//   [out | outputs] @ [d1; d2] needs no read-modify-write epilogue.
// - Epilogues capture by value, a product keeps its operands in locals,
//   and it loads the lane's bias values and residuals before its first
//   store, handing them to the epilogue: a load that follows a store it
//   may alias waits for it, output by output (PERF.md: 8% and 3% of the
//   call).
// - expf and true division throughout, no fast math: K1 decodes these
//   logits, and its indices flip on near-ties.  LayerNorm, softmaxes and
//   gates stay f32.
// Registers: every stage (encode, fuse, predict, conv block, attention,
// dual attention, CQ attention, feature encoder, LayerNorm, softmax) and
// every product is a separate function (__noinline__), and the kernel's
// pointers into the workspace are derived from the Ctx at each use, so no
// function holds more across a call than the ABI keeps: ptxas reports 238
// registers (f64 path) and 224 (bf16 path), 600 bytes of stack and no spills
// (sm_90a, CUDA 12.8).
// Resources: 256 threads; dynamic shared memory (fused_forward_smem_bytes)
// of the stages or q/k/v, a head group's scores and the masks: 174 KB at
// T=64, 213 KB at T=100, opted in above 48 KB with cudaFuncSetAttribute.
// T and W are at most kMaxLen = 100 and D at most kMaxDim = 128, a
// multiple of 4, so that q, k and v fit beside one head's scores (the
// wrapper's check_kernel_shape).
//
// Plain C interface, bound from Python with ctypes; the entry point returns
// the first CUDA error of its attribute call or launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kConvK = 7;       // depthwise kernel width
constexpr int kConvLayers = 4;  // layers of a conv block
constexpr int kLabels = 4;      // matching-head classes
constexpr float kMask = -1e30f;

// products on the tensor cores
constexpr int kTile = 32;             // a warp's tile of outputs: kTile x kTile
constexpr int kTileShift = 5;         // log2(kTile)
constexpr int kSlab = 64;             // k depth of one staged slab
constexpr int kSlabShift = 6;         // log2(kSlab)
constexpr int kSlabLd = kSlab + 4;    // row stride of a k-contiguous slab
constexpr int kMaxPassN = 4 * kTile;  // widest pass: 4 warps across N
constexpr int kMaxLen = 100;          // largest T or W
constexpr int kMaxDim = 128;          // largest D
constexpr long kSmemLimit = 232448;   // bytes of shared memory a block may use

// Per-sample workspace: kBuffers buffers of Lm x D (Lm = max(T, W)), the
// CQ attention's 4 matrices of Lm x Lm and 5 small vectors.  Buffers whose
// lifetimes do not overlap share one (see the kernel).
constexpr int kBuffers = 13;

// Dynamic shared memory, in floats: a region that holds either the two
// stages of a staged product (each an A slab of up to Lm rows, then a B
// slab) or, inside attention, the Q, K and V rows; then the score tiles of
// a group of `heads` heads (Lm rows each); then the two masks.  Q and K
// rows are D+4 floats apart, V rows D+8, score rows lm_pad+4: conflict-free
// fragment loads.  `heads` is the largest divisor of H that fits.
struct SmemLayout {
  int a_floats, b_floats, region, score_ld, head_floats, heads, masks;
  __host__ __device__ SmemLayout(int T, int W, int D, int H) {
    const int lm = T > W ? T : W;
    const int lm_pad = (lm + kTile - 1) / kTile * kTile;
    a_floats = lm_pad * kSlabLd;
    const int row_major = kSlab * (kMaxPassN + 8), nt = kMaxPassN * kSlabLd;
    b_floats = row_major > nt ? row_major : nt;
    const int stages = 2 * (a_floats + b_floats),
              qkv = lm * (3 * D + 16);
    region = stages > qkv ? stages : qkv;
    score_ld = lm_pad + 4;
    head_floats = lm * score_ld;
    masks = T + W;
    for (heads = H; heads > 1; --heads)
      if (H % heads == 0 && floats() * 4 <= kSmemLimit) break;
  }
  __host__ __device__ long floats() const {
    return static_cast<long>(region) + static_cast<long>(heads) * head_floats +
           masks;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// -- PTX: DMMA and cp.async ----------------------------------------------------
// d += a . b for one m16n8k4 fragment, f64 (see the note at the top).
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0,
                                            double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// d += a . b for one m16n8k16 fragment: bf16 operands, f32 sums.
__device__ __forceinline__ void hmma_16x8x16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to nearest even bf16 and packed, lo in the low half
// (the element of the lower k).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// x rounded to nearest even bf16, as an f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(bf16x2(x, 0.0f) << 16);
}

// Copies N (4 or 16) bytes from device to shared memory, or writes
// zeros there when !valid (src-size 0: nothing is read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(valid ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` of this thread's copy groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// -- packed weights -----------------------------------------------------------
struct Cursor {
  const float* p;
  __device__ const float* take(long n) {
    const float* r = p;
    p += n;
    return r;
  }
};

struct LN {
  const float* scale;
  const float* bias;
};

struct Dense {
  const float* w;  // (in, out) row-major
  const float* b;  // (out,) or nullptr
};

struct ConvBlockW {
  LN ln[kConvLayers];
  const float* dw[kConvLayers];  // (kConvK, D)
  Dense pw[kConvLayers];
};

struct DualW {
  LN ln1, lnt, ln2;
  Dense query, f_key, f_value, t_key, t_value, s_dense, x_dense, s_gate,
      x_gate, guided;
  const float *b1d1, *b1d2, *b1b, *b2d1, *b2d2, *b2b;
  Dense dense_1, dense_2;
};

struct CQW {
  const float *w0, *w1, *wm;
  Dense dense;  // (4D, D), no bias
};

__device__ LN take_ln(Cursor& c, int D) {
  LN l;
  l.scale = c.take(D);
  l.bias = c.take(D);
  return l;
}

__device__ Dense take_dense(Cursor& c, int in, int out, bool bias = true) {
  Dense d;
  d.w = c.take(static_cast<long>(in) * out);
  d.b = bias ? c.take(out) : nullptr;
  return d;
}

__device__ ConvBlockW take_conv_block(Cursor& c, int D) {
  ConvBlockW w;
  for (int i = 0; i < kConvLayers; ++i) {
    w.ln[i] = take_ln(c, D);
    w.dw[i] = c.take(kConvK * D);
    w.pw[i] = take_dense(c, D, D);
  }
  return w;
}

__device__ DualW take_dual(Cursor& c, int D) {
  DualW w;
  w.ln1 = take_ln(c, D);
  w.lnt = take_ln(c, D);
  w.ln2 = take_ln(c, D);
  Dense* denses[] = {&w.query, &w.f_key, &w.f_value, &w.t_key, &w.t_value,
                     &w.s_dense, &w.x_dense, &w.s_gate, &w.x_gate, &w.guided};
  for (Dense* d : denses) *d = take_dense(c, D, D);
  w.b1d1 = c.take(D * D);
  w.b1d2 = c.take(D * D);
  w.b1b = c.take(D);
  w.b2d1 = c.take(D * D);
  w.b2d2 = c.take(D * D);
  w.b2b = c.take(D);
  w.dense_1 = take_dense(c, D, D);
  w.dense_2 = take_dense(c, D, D);
  return w;
}

__device__ CQW take_cq(Cursor& c, int D) {
  CQW w;
  w.w0 = c.take(D);
  w.w1 = c.take(D);
  w.wm = c.take(D);
  w.dense = take_dense(c, 4 * D, D, false);
  return w;
}

// -- block-wide building blocks --------------------------------------------
struct Ctx {
  int T, W, D, H, Lm;
  float* stage;      // two stages of stage_floats: an A slab (a_floats), then
  int stage_floats;  // a B slab; inside attention, the Q, K and V rows
  int a_floats;
  float* S;          // the scores of `heads` heads: Tq rows of lds floats each
  int lds, heads;
  float* ws;         // the sample's workspace: buffers of ld floats
  long ld;
};

// A row-major matrix: element (r, c) at p[r * ld + c].
struct Mat {
  const float* p;
  int ld;
};

// Rows that 16-byte copies can stage: an aligned start, ld and cols
// multiples of 4.
__device__ __forceinline__ bool rows_aligned(const float* p, int ld, int cols) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0 &&
         cols % 4 == 0;
}

// Starts copying rows [r0, r0 + R) x columns [c0, c0 + (1 << cshift)) of the
// row-major matrix src (row stride ld; rmax rows, cmax columns) to dst (row
// stride lds), zeros outside the matrix.  vec: 16-byte copies (see
// rows_aligned; c0 a multiple of 4, so a copy is wholly in or out).
__device__ __forceinline__ void stage_tile(float* dst, int lds, const float* src,
                                           int ld, int r0, int R, int rmax,
                                           int c0, int cshift, int cmax,
                                           bool vec) {
  if (vec) {
    const int qs = cshift - 2;
    for (int e = threadIdx.x; e < (R << qs); e += kThreads) {
      const int r = e >> qs, c = (e & ((1 << qs) - 1)) << 2;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async<16>(dst + r * lds + c,
                   ok ? src + static_cast<long>(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < (R << cshift); e += kThreads) {
      const int r = e >> cshift, c = e & ((1 << cshift) - 1);
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async<4>(dst + r * lds + c,
                  ok ? src + static_cast<long>(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// epi(m, n, f32(sum_k A[m, k] * B[k, n]) [+ bias[n]], res[m, n] or 0) for
// m < M, n < N (res has rows of N), each output
// once, from the thread that owns it (the same thread for every product of
// the same M and N).  A is row-major (M x K) in device memory; B is
// row-major (K x N) in device memory, or with kBNT stored as N x K (B[k, n]
// at b.p[n * ld + k]).  Both are staged through shared memory in k-slabs
// of f32; each fragment is converted in the k-loop: to f64, products and
// sums in f64 (DMMA), or with kBf16 to bf16, sums in f32 (HMMA).  Ends
// with the block synchronised after its last read of shared memory.
template <bool kBNT, bool kBf16, class Epi>
__device__ __noinline__ void gemm(int M, int N, int K, Mat a, Mat b,
                                  const float* bias, const float* res,
                                  const Ctx& x, Epi epi_arg) {
  using Acc = std::conditional_t<kBf16, float, double>;
  // locals, not reloads from x after each cp.async wait (a memory clobber)
  const Epi epi = epi_arg;
  float* const stage = x.stage;
  const int stage_floats = x.stage_floats, a_floats = x.a_floats;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int wc_shift = N > 2 * kTile ? 2 : N > kTile ? 1 : 0;
  const int pn_shift = kTileShift + wc_shift;
  const int PN = 1 << pn_shift, PM = (kTile * kWarps) >> wc_shift;
  const int wm = (warp >> wc_shift) * kTile;              // the warp's tile
  const int wn = (warp & ((1 << wc_shift) - 1)) * kTile;  // within a pass
  const bool a_vec = rows_aligned(a.p, a.ld, K);
  const bool b_vec = rows_aligned(b.p, b.ld, kBNT ? K : N);
  const int bld = kBNT ? kSlabLd : PN + 8;  // B slab row stride
  const int slabs = (K + kSlab - 1) / kSlab;
  for (int m0 = 0; m0 < M; m0 += PM) {
    const int rows = min(PM, (M - m0 + kTile - 1) / kTile * kTile);
    for (int n0 = 0; n0 < N; n0 += PN) {
      auto load = [&](int s) {
        float* st = stage + (s & 1) * stage_floats;
        const int k0 = s * kSlab;
        stage_tile(st, kSlabLd, a.p, a.ld, m0, rows, M, k0, kSlabShift, K, a_vec);
        if (kBNT)
          stage_tile(st + a_floats, kSlabLd, b.p, b.ld, n0, PN, N, k0,
                     kSlabShift, K, b_vec);
        else
          stage_tile(st + a_floats, bld, b.p, b.ld, k0, kSlab, K, n0,
                     pn_shift, N, b_vec);
        cp_async_commit();
      };
      // live fragments of the warp's tile: 16-row and 8-column ones
      const int mi_n = min(2, max(0, (M - m0 - wm + 15) / 16));
      const int nj_n = min(4, max(0, (N - n0 - wn + 7) / 8));
      Acc acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;
      load(0);
      for (int s = 0; s < slabs; ++s) {
        if (s + 1 < slabs) {
          load(s + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* As = stage + (s & 1) * stage_floats;
        const float* Bs = As + a_floats;
        if (mi_n == 0 || nj_n == 0) {
          // no live fragment in this warp's tile
        } else if constexpr (kBf16) {
          // k16 steps over the slab; its zero fill pads a ragged K
          const int steps = (min(kSlab, K - s * kSlab) + 15) >> 4;
          for (int kk = 0; kk < steps; ++kk) {
            const int k = kk * 16 + 2 * t;
            uint32_t av[2][4], bv[4][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float* r0 = As + (wm + i * 16 + g) * kSlabLd + k;
              const float* r8 = r0 + 8 * kSlabLd;
              av[i][0] = bf16x2(r0[0], r0[1]);
              av[i][1] = bf16x2(r8[0], r8[1]);
              av[i][2] = bf16x2(r0[8], r0[9]);
              av[i][3] = bf16x2(r8[8], r8[9]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = wn + j * 8 + g;
              if (kBNT) {
                const float* bp = Bs + c * kSlabLd + k;
                bv[j][0] = bf16x2(bp[0], bp[1]);
                bv[j][1] = bf16x2(bp[8], bp[9]);
              } else {
                const float* bp = Bs + k * bld + c;
                bv[j][0] = bf16x2(bp[0], bp[bld]);
                bv[j][1] = bf16x2(bp[8 * bld], bp[9 * bld]);
              }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (i < mi_n && j < nj_n)  // warp-uniform
                  hmma_16x8x16(acc[i][j], av[i], bv[j][0], bv[j][1]);
          }
        } else {
          const int steps = (min(kSlab, K - s * kSlab) + 3) >> 2;
#pragma unroll 2
          for (int kk = 0; kk < steps; ++kk) {
            const int k = kk * 4 + t;
            double av[2][2], bv[4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = wm + i * 16 + g;
              av[i][0] = As[r * kSlabLd + k];
              av[i][1] = As[(r + 8) * kSlabLd + k];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = wn + j * 8 + g;
              bv[j] = kBNT ? Bs[c * kSlabLd + k] : Bs[k * bld + c];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (i < mi_n && j < nj_n)  // warp-uniform
                  dmma_16x8x4(acc[i][j], av[i][0], av[i][1], bv[j]);
          }
        }
        __syncthreads();  // the stages are free for the next copy
      }
      // the lane's bias values and residuals, loaded before any store (a
      // store through epi could alias them, and each load would wait)
      float bv[4][2], rv[2][4][2][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn + j * 8 + 2 * t + q;
          bv[j][q] = bias != nullptr && j < nj_n && n < N ? bias[n] : 0.0f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int m = m0 + wm + i * 16 + g + 8 * h,
                        n = n0 + wn + j * 8 + 2 * t + q;
              rv[i][j][h][q] = res != nullptr && i < mi_n && j < nj_n && m < M &&
                                       n < N
                                   ? res[static_cast<long>(m) * N + n]
                                   : 0.0f;
            }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i >= mi_n || j >= nj_n) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)  // rows m and m + 8
#pragma unroll
            for (int q = 0; q < 2; ++q) {  // columns n and n + 1
              const int m = m0 + wm + i * 16 + g + 8 * h,
                        n = n0 + wn + j * 8 + 2 * t + q;
              if (m >= M || n >= N) continue;
              float v = static_cast<float>(acc[i][j][2 * h + q]);
              if (bias != nullptr) v = v + bv[j][q];
              epi(m, n, v, rv[i][j][h][q]);
            }
        }
    }
  }
}

// A dense layer: epi(m, n, x[m, :] @ d.w[:, n] + d.b[n], res[m, n] or 0);
// x is (M, K) row-major with rows lda floats apart, d.w (K, N), d.b (N,)
// or null, res (M, N) or null.
template <bool kBf16, class Epi>
__device__ void dense(const float* in, int lda, int M, int K, int N, Dense d,
                      const Ctx& x, Epi epi, const float* res = nullptr) {
  gemm<false, kBf16>(M, N, K, Mat{in, lda}, Mat{d.w, N}, d.b, res, x, epi);
}

// The same for a narrow N (the matching head, the (D,1) denses): one
// thread per output on the CUDA cores, f64 sums in order over k; with
// kRound both operands are rounded to bf16 first.
template <bool kRound, class Epi>
__device__ __noinline__ void narrow_dense(const float* in, int M, int K, int N,
                             const float* w, Epi epi) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    const float* xr = in + static_cast<long>(m) * K;
    double acc = 0.0;
    for (int k = 0; k < K; ++k) {
      const float a = kRound ? round_bf16(xr[k]) : xr[k];
      const float b = kRound ? round_bf16(w[k * N + n]) : w[k * N + n];
      acc = fma(static_cast<double>(a), static_cast<double>(b), acc);
    }
    epi(m, n, static_cast<float>(acc));
  }
}

// LayerNorm over the last axis (eps 1e-6), one warp per row held in
// registers (a float4 a lane: D <= 128, a multiple of 4); y has row stride
// ldy, a multiple of 4.
__device__ __noinline__ void layer_norm(const float* __restrict__ x,
                                        float* __restrict__ y,
                           int ldy, int L, int D, LN p) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bool has = lane < D / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 sc = has ? ld4(p.scale + 4 * lane) : zero;
  const float4 bi = has ? ld4(p.bias + 4 * lane) : zero;
  for (int row = warp; row < L; row += kWarps) {
    const float4 v = has ? ld4(x + static_cast<long>(row) * D + 4 * lane) : zero;
    const float mean = warp_sum((v.x + v.y) + (v.z + v.w)) / D;
    const float4 c = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
    const float var = has ? (c.x * c.x + c.y * c.y) + (c.z * c.z + c.w * c.w) : 0.0f;
    const float inv = rsqrtf(warp_sum(var) / D + 1e-6f);
    if (has)
      st4(y + static_cast<long>(row) * ldy + 4 * lane,
          make_float4(c.x * inv * sc.x + bi.x, c.y * inv * sc.y + bi.y,
                      c.z * inv * sc.z + bi.z, c.w * inv * sc.w + bi.w));
  }
}

// Softmax over each of R rows of length N (row stride ld), in place; 8
// lanes a row, 32 rows at a time.
__device__ __noinline__ void softmax_rows(float* s, int R, int N, int ld) {
  constexpr int kLanes = 8;
  const int group = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
  for (int r0 = 0; r0 < R; r0 += kThreads / kLanes) {  // uniform trip count
    const int row = r0 + group;
    const bool live = row < R;
    float* r = s + static_cast<long>(live ? row : 0) * ld;
    float m = -INFINITY;
    if (live)
      for (int j = l; j < N; j += kLanes) m = fmaxf(m, r[j]);
    for (int o = kLanes / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float sum = 0.0f;
    if (live)
      for (int j = l; j < N; j += kLanes) {
        const float e = expf(r[j] - m);
        r[j] = e;
        sum += e;
      }
    for (int o = kLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    if (live)
      for (int j = l; j < N; j += kLanes) r[j] = r[j] / sum;
  }
}

// out[row] = x[row, :] . v, one warp per row.
__device__ __noinline__ void row_dots(const float* x, int L, int D,
                                      const float* v, float* out) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int row = warp; row < L; row += kWarps) {
    const float* xr = x + static_cast<long>(row) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += kWarp) s += xr[d] * v[d];
    s = warp_sum(s);
    if (lane == 0) out[row] = s;
  }
}

// x (L x D) in place: kConvLayers x {LN -> depthwise k=7 SAME, zero padding
// at both ends of L, mask ignored -> pointwise + bias -> relu -> + residual}.
template <bool kBf16>
__device__ __noinline__ void conv_block(float* xs, int L, const Ctx& x, const ConvBlockW& w,
                           float* h, float* acc) {
  const int D = x.D;
  for (int i = 0; i < kConvLayers; ++i) {
    layer_norm(xs, h, D, L, D, w.ln[i]);
    __syncthreads();
    const float* f = w.dw[i];
    const int nq = D / 4;  // four channels a thread
    for (int e = threadIdx.x; e < L * nq; e += blockDim.x) {
      const int t = e / nq, c = (e - t * nq) * 4;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < kConvK; ++k) {
        const int s = t + k - kConvK / 2;
        if (s >= 0 && s < L) {
          const float4 hv = ld4(h + s * D + c), fv = ld4(f + k * D + c);
          a.x += hv.x * fv.x;
          a.y += hv.y * fv.y;
          a.z += hv.z * fv.z;
          a.w += hv.w * fv.w;
        }
      }
      st4(acc + t * D + c, a);
    }
    __syncthreads();
    dense<kBf16>(acc, D, L, D, D, w.pw[i], x, [=](int m, int n, float v, float r) {
      xs[m * D + n] = fmaxf(v, 0.0f) + r;
    }, xs);
    __syncthreads();
  }
}

// Starts copying `rows` rows of `cols` floats (src rows cols apart) to dst
// (rows ldd apart) with cp.async.
__device__ void copy_rows(float* dst, int ldd, const float* src, int rows,
                          int cols) {
  if (rows_aligned(src, cols, cols) && ldd % 4 == 0) {
    const int q = cols / 4;
    for (int e = threadIdx.x; e < rows * q; e += kThreads) {
      const int r = e / q, c = (e - r * q) * 4;
      cp_async<16>(dst + r * ldd + c, src + static_cast<long>(r) * cols + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      cp_async<4>(dst + r * ldd + c, src + static_cast<long>(r) * cols + c, true);
    }
  }
}

// epi(bi, m, n, f32(sum_k A_bi[m, k] * B_bi[k, n])) for bi < nb, m < M,
// n < N, with both operands in shared memory, read in place (zeros past M,
// N and K): A_bi[m, k] = a[bi * a_bs + m * lda + k]; B_bi[k, n] =
// b[bi * b_bs + k * ldb + n], or with kBNT b[bi * b_bs + n * ldb + k].  The
// warps take (bi, 32x32 tile) jobs in turn, with no barrier: nothing is
// staged.  Products and sums in f64 on the tensor cores, or with kBf16 on
// bf16 operands with f32 sums.
template <bool kBNT, bool kBf16, class Epi>
__device__ __noinline__ void gemm_smem(int nb, int M, int N, int K,
                                       const float* a, int a_bs, int lda,
                                       const float* b, int b_bs, int ldb,
                                       Epi epi_arg) {
  using Acc = std::conditional_t<kBf16, float, double>;
  const Epi epi = epi_arg;  // a local copy: no reloads after stores
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (M + kTile - 1) / kTile, nt = (N + kTile - 1) / kTile;
  for (int job = warp; job < nb * mt * nt; job += kWarps) {
    const int bi = job / (mt * nt), r = job - bi * mt * nt;
    const int m0 = r / nt * kTile, n0 = r % nt * kTile;
    const float* A = a + bi * a_bs;
    const float* Bm = b + bi * b_bs;
    const int mi_n = min(2, (M - m0 + 15) / 16);  // live 16-row fragments
    const int nj_n = min(4, (N - n0 + 7) / 8);    // live 8-column fragments
    Acc acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;
    if constexpr (kBf16) {
      // k16 steps, zeros past M, N and K
      auto at = [&](int m, int k) {
        return k < K && m < M ? A[m * lda + k] : 0.0f;
      };
      auto bt = [&](int k, int n) {
        return k < K && n < N ? (kBNT ? Bm[n * ldb + k] : Bm[k * ldb + n]) : 0.0f;
      };
      for (int k0 = 0; k0 < K; k0 += 16) {
        const int k = k0 + 2 * t;
        uint32_t av[2][4], bv[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + i * 16 + g;
          av[i][0] = bf16x2(at(m, k), at(m, k + 1));
          av[i][1] = bf16x2(at(m + 8, k), at(m + 8, k + 1));
          av[i][2] = bf16x2(at(m, k + 8), at(m, k + 9));
          av[i][3] = bf16x2(at(m + 8, k + 8), at(m + 8, k + 9));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j * 8 + g;
          bv[j][0] = bf16x2(bt(k, n), bt(k + 1, n));
          bv[j][1] = bf16x2(bt(k + 8, n), bt(k + 9, n));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i < mi_n && j < nj_n)  // warp-uniform
              hmma_16x8x16(acc[i][j], av[i], bv[j][0], bv[j][1]);
      }
    } else {
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 4) {
        const int k = k0 + t;
        const bool kin = k < K;
        double av[2][2], bv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + i * 16 + g;
          av[i][0] = kin && m < M ? A[m * lda + k] : 0.0f;
          av[i][1] = kin && m + 8 < M ? A[(m + 8) * lda + k] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j * 8 + g;
          bv[j] = kin && n < N ? (kBNT ? Bm[n * ldb + k] : Bm[k * ldb + n]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i < mi_n && j < nj_n)  // warp-uniform
              dmma_16x8x4(acc[i][j], av[i][0], av[i][1], bv[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i >= mi_n || j >= nj_n) continue;
        const int m = m0 + i * 16 + g, n = n0 + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows m and m + 8
          if (m + 8 * h >= M) continue;
          if (n < N) epi(bi, m + 8 * h, n, static_cast<float>(acc[i][j][2 * h]));
          if (n + 1 < N)
            epi(bi, m + 8 * h, n + 1, static_cast<float>(acc[i][j][2 * h + 1]));
        }
      }
  }
}

// Multi-head attention over q (Tq x D), k and v (Tk x D):
//   S_h = (q_h k_h^T) * scale + (1 - fm[i] * tm[j]) * -1e30
//   out[:, h*hd:(h+1)*hd] = softmax_rows(S_h) @ v_h
// q, k and v are copied to shared memory once; then x.heads heads at a
// time: their scores, the masked softmax over the real Tk, and p.v, all in
// shared memory.  An all-padding `from` row gets -1e30 on every score: the
// finite part is absorbed and the row attends uniformly over the real Tk.
template <bool kBf16>
__device__ __noinline__ void attention(const float* q, const float* k,
                                       const float* v, const float* fm,
                                       const float* tm, int Tq, int Tk,
                                       const Ctx& x, float scale, float* out) {
  const int D = x.D, hd = D / x.H, lds = x.lds, G = x.heads;
  const int ldq = D + 4, ldv = D + 8;
  float* Qs = x.stage;  // the stages are free between products
  float* Ks = Qs + x.Lm * ldq;
  float* Vs = Ks + x.Lm * ldq;
  float* S = x.S;
  const int s_bs = Tq * lds;  // one head's scores
  copy_rows(Qs, ldq, q, Tq, D);
  copy_rows(Ks, ldq, k, Tk, D);
  copy_rows(Vs, ldv, v, Tk, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int h0 = 0; h0 < x.H; h0 += G) {
    // the scale multiplies the f32 sum, after the product, as in JAX
    gemm_smem<true, kBf16>(G, Tq, Tk, hd, Qs + h0 * hd, hd, ldq, Ks + h0 * hd,
                           hd, ldq, [=](int g, int i, int j, float acc) {
                             S[g * s_bs + i * lds + j] =
                                 acc * scale + (1.0f - fm[i] * tm[j]) * kMask;
                           });
    __syncthreads();
    softmax_rows(S, G * Tq, Tk, lds);
    __syncthreads();
    gemm_smem<false, kBf16>(G, Tq, hd, Tk, S, s_bs, lds, Vs + h0 * hd, hd, ldv,
                            [=](int g, int i, int c, float acc) {
                              out[i * D + (h0 + g) * hd + c] = acc;
                            });
    __syncthreads();
  }
}

struct Scratch {
  float* buf[9];  // Lm x D each
};

// One dual-attention layer in one direction: from (Tq rows) attends to
// itself and to `to` (Tk rows); the result goes to dest (Tq x D).
template <bool kBf16>
__device__ __noinline__ void dual_attn(const float* from, const float* to, const float* fm,
                          const float* tm, int Tq, int Tk, const Ctx& x,
                          const DualW& w, float scale, const Scratch& s,
                          float* dest) {
  const int D = x.D, D2 = 2 * D;
  // cat (scratch 0 and 1 as Lm rows of 2D): [out | ton], then [out | outputs]
  float *cat = s.buf[0], *out = cat, *ton = cat + D, *qp = s.buf[2],
        *fk = s.buf[3], *fv = s.buf[4], *tk = s.buf[5], *tv = s.buf[6],
        *sout = s.buf[7], *xout = s.buf[8];

  layer_norm(from, out, D2, Tq, D, w.ln1);
  layer_norm(to, ton, D2, Tk, D, w.lnt);
  __syncthreads();
  auto store = [&](float* y) {
    return [=](int m, int n, float v, float) { y[m * D + n] = v; };
  };
  dense<kBf16>(out, D2, Tq, D, D, w.query, x, store(qp));
  dense<kBf16>(out, D2, Tq, D, D, w.f_key, x, store(fk));
  dense<kBf16>(out, D2, Tq, D, D, w.f_value, x, store(fv));
  dense<kBf16>(ton, D2, Tk, D, D, w.t_key, x, store(tk));
  dense<kBf16>(ton, D2, Tk, D, D, w.t_value, x, store(tv));
  __syncthreads();
  attention<kBf16>(qp, fk, fv, fm, fm, Tq, Tq, x, scale, sout);
  attention<kBf16>(qp, tk, tv, fm, tm, Tq, Tk, x, scale, xout);
  __syncthreads();
  float *s_val = qp, *x_val = fk, *s_gate = fv, *x_gate = tk;
  dense<kBf16>(sout, D, Tq, D, D, w.s_dense, x, store(s_val));
  dense<kBf16>(xout, D, Tq, D, D, w.x_dense, x, store(x_val));
  __syncthreads();
  dense<kBf16>(s_val, D, Tq, D, D, w.s_gate, x, [=](int m, int n, float v, float) {
    s_gate[m * D + n] = sigmoidf(v);
  });
  dense<kBf16>(x_val, D, Tq, D, D, w.x_gate, x, [=](int m, int n, float v, float) {
    x_gate[m * D + n] = sigmoidf(v);
  });
  __syncthreads();
  float* mix = sout;
  for (int e = 4 * threadIdx.x; e < Tq * D; e += 4 * blockDim.x) {
    const float4 sg = ld4(s_gate + e), xv = ld4(x_val + e), xg = ld4(x_gate + e),
                 sv = ld4(s_val + e);
    st4(mix + e, make_float4(sg.x * xv.x + xg.x * sv.x, sg.y * xv.y + xg.y * sv.y,
                             sg.z * xv.z + xg.z * sv.z, sg.w * xv.w + xg.w * sv.w));
  }
  __syncthreads();
  float* outputs = cat + D;  // over ton, which is spent
  dense<kBf16>(mix, D, Tq, D, D, w.guided, x,
        [=](int m, int n, float v, float) { outputs[m * D2 + n] = v; });
  __syncthreads();
  // bilinear_k = out @ d1 + outputs @ d2 + b as one product with K = 2D:
  // [out | outputs] @ [d1; d2] (packed next to each other), summed in f64
  // and rounded once, where the plain version rounds both products
  float *scores = tv, *values = sout;
  dense<kBf16>(cat, D2, Tq, D2, D, Dense{w.b1d1, w.b1b}, x, store(scores));
  dense<kBf16>(cat, D2, Tq, D2, D, Dense{w.b2d1, w.b2b}, x, store(values));
  __syncthreads();
  // gate: sigmoid(scores*m + -1e30*(1-m)) * values, exactly 0 on padded rows
  float* gated = qp;
  for (int e = threadIdx.x; e < Tq * D; e += blockDim.x) {
    const float m = fm[e / D];
    gated[e] = sigmoidf(scores[e] * m + kMask * (1.0f - m)) * values[e];
  }
  __syncthreads();
  float* res = fk;
  dense<kBf16>(gated, D, Tq, D, D, w.dense_1, x,
        [=](int m, int n, float v, float r) { res[m * D + n] = v + r; }, from);
  __syncthreads();
  layer_norm(res, fv, D, Tq, D, w.ln2);
  __syncthreads();
  dense<kBf16>(fv, D, Tq, D, D, w.dense_2, x,
        [=](int m, int n, float v, float r) { dest[m * D + n] = v + r; }, res);
  __syncthreads();
}

// CQ attention: x1 (T1 rows) against x2 (T2 rows) -> out (T1 x D).
//   score = x1.w0 + (x2.w1)^T + (x1*wm) @ x2^T
//   score_  = row softmax masking the `to` columns (m2)
//   score_t = column softmax over T1 masking the `from` rows (m1)
//   out = [x1, c2q, x1*c2q, x1*q2c] @ dense, c2q = score_ @ x2,
//   q2c = (score_ @ score_t^T) @ x1
// The four T1 x T2 / T1 x T1 matrices live in the workspace (cqreg).
template <bool kBf16>
__device__ __noinline__ void cq_attention(const float* x1, const float* x2, const float* m1,
                             const float* m2, int T1, int T2, const Ctx& x,
                             const CQW& w, float* x1wm, float* sub0,
                             float* sub1, float* cqreg, float* att,
                             float* out) {
  const int D = x.D;
  const long lm2 = static_cast<long>(x.Lm) * x.Lm;
  float *sc = cqreg, *s_ = cqreg + lm2, *st = cqreg + 2 * lm2,
        *m1m = cqreg + 3 * lm2;
  row_dots(x1, T1, D, w.w0, sub0);
  row_dots(x2, T2, D, w.w1, sub1);
  for (int e = threadIdx.x; e < T1 * D; e += blockDim.x)
    x1wm[e] = x1[e] * w.wm[e % D];
  __syncthreads();
  gemm<true, kBf16>(T1, T2, D, Mat{x1wm, D}, Mat{x2, D}, nullptr, nullptr, x,
                    [=](int i, int j, float acc, float) {
                      sc[i * T2 + j] = (sub0[i] + sub1[j]) + acc;
                    });
  __syncthreads();
  {
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    // row softmax (over j) of score*m2 + -1e30*(1-m2)
    for (int i = warp; i < T1; i += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < T2; j += kWarp) {
        const float v = sc[i * T2 + j] * m2[j] + kMask * (1.0f - m2[j]);
        s_[i * T2 + j] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int j = lane; j < T2; j += kWarp) {
        const float e = expf(s_[i * T2 + j] - mx);
        s_[i * T2 + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < T2; j += kWarp) s_[i * T2 + j] = s_[i * T2 + j] / sum;
    }
    // column softmax (over i) of score*m1 + -1e30*(1-m1)
    for (int j = warp; j < T2; j += kWarps) {
      float mx = -INFINITY;
      for (int i = lane; i < T1; i += kWarp) {
        const float v = sc[i * T2 + j] * m1[i] + kMask * (1.0f - m1[i]);
        st[i * T2 + j] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int i = lane; i < T1; i += kWarp) {
        const float e = expf(st[i * T2 + j] - mx);
        st[i * T2 + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int i = lane; i < T1; i += kWarp) st[i * T2 + j] = st[i * T2 + j] / sum;
    }
  }
  __syncthreads();
  const int D4 = 4 * D;
  // c2q = score_ @ x2 straight into att[:, D:2D] and x1*c2q into att[:, 2D:3D]
  gemm<false, kBf16>(T1, D, T2, Mat{s_, T2}, Mat{x2, D}, nullptr, nullptr, x,
                     [=](int i, int c, float acc, float) {
                       att[i * D4 + c] = x1[i * D + c];
                       att[i * D4 + D + c] = acc;
                       att[i * D4 + 2 * D + c] = x1[i * D + c] * acc;
                     });
  // score_ @ score_t^T (T1 x T1)
  gemm<true, kBf16>(T1, T1, T2, Mat{s_, T2}, Mat{st, T2}, nullptr, nullptr, x,
                    [=](int i, int i2, float acc, float) { m1m[i * T1 + i2] = acc; });
  __syncthreads();
  gemm<false, kBf16>(T1, D, T1, Mat{m1m, T1}, Mat{x1, D}, nullptr, nullptr, x,
                     [=](int i, int c, float acc, float) {
                       att[i * D4 + 3 * D + c] = x1[i * D + c] * acc;
                     });
  __syncthreads();
  dense<kBf16>(att, D4, T1, D4, D, w.dense, x,
        [=](int m, int n, float v, float) { out[m * D + n] = v; });
  __syncthreads();
}

struct FEW {
  const float* pos;
  ConvBlockW conv;
  LN ln1, ln2;
  Dense q, k, v, dense;
};

// Feature encoder: y = x + pos -> conv block -> LN -> self-attention
// (+ residual) -> LN -> dense (+ residual); y may not alias x.
template <bool kBf16>
__device__ __noinline__ void feature_encoder(const float* in, const float* vm, const Ctx& x,
                                const FEW& w, float scale, const Scratch& s,
                                float* y) {
  const int T = x.T, D = x.D;
  for (int e = 4 * threadIdx.x; e < T * D; e += 4 * blockDim.x) {
    const float4 a = ld4(in + e), b = ld4(w.pos + e);
    st4(y + e, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  }
  __syncthreads();
  conv_block<kBf16>(y, T, x, w.conv, s.buf[0], s.buf[1]);
  float *o = s.buf[0], *q = s.buf[1], *k = s.buf[2], *v = s.buf[3],
        *att = s.buf[4], *res = s.buf[5], *ln2 = s.buf[6];
  layer_norm(y, o, D, T, D, w.ln1);
  __syncthreads();
  auto store = [&](float* out) {
    return [=](int m, int n, float val, float) { out[m * D + n] = val; };
  };
  dense<kBf16>(o, D, T, D, D, w.q, x, store(q));
  dense<kBf16>(o, D, T, D, D, w.k, x, store(k));
  dense<kBf16>(o, D, T, D, D, w.v, x, store(v));
  __syncthreads();
  attention<kBf16>(q, k, v, vm, vm, T, T, x, scale, att);
  __syncthreads();
  for (int e = 4 * threadIdx.x; e < T * D; e += 4 * blockDim.x) {
    const float4 a = ld4(att + e), b = ld4(y + e);
    st4(res + e, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  }
  __syncthreads();
  layer_norm(res, ln2, D, T, D, w.ln2);
  __syncthreads();
  dense<kBf16>(ln2, D, T, D, D, w.dense, x,
        [=](int m, int n, float val, float r) { y[m * D + n] = val + r; }, res);
  __syncthreads();
}

// The sample's workspace (x.ws, rows x.ld floats apart): buffers 0-3 hold
// the two streams and their next layer, 4-12 are scratch, then the CQ
// attention's 4 Lm x Lm matrices and the small vectors.  After the
// dual-attention stack the spent pair takes q2v and v2q, then the feature
// encoders' outputs; the final pair takes fuse and outp.  `wide` (Lm x 4D)
// is scratch 1-4.  Pointers are derived from x at each use: x lives in
// memory that every stage function sees, so they are reloaded after a call
// instead of being held (and spilled) across it.
__device__ __forceinline__ float* buf(const Ctx& x, int i) {
  return x.ws + i * x.ld;
}

__device__ __forceinline__ float* vec(const Ctx& x, int i) {  // Lm floats each
  return x.ws + kBuffers * x.ld + 4L * x.Lm * x.Lm + static_cast<long>(i) * x.Lm;
}

// Shared positional embedding and conv block on both streams, then the
// dual-attention stack.  Returns the buffer of the final video stream (0 or
// 2); the query stream follows it.
template <bool kBf16>
__device__ __noinline__ int encode(const Ctx& x, Cursor& c, const float* vfb,
                                   const float* qfb, const float* vm,
                                   const float* qm, int P, int attn_layer,
                                   float scale, const Scratch& s) {
  const int T = x.T, W = x.W, D = x.D;
  const float* pos = c.take(static_cast<long>(P) * D);
  const ConvBlockW cb = take_conv_block(c, D);
  for (int e = 4 * threadIdx.x; e < T * D; e += 4 * blockDim.x) {
    const float4 a = ld4(vfb + e), b = ld4(pos + e);
    st4(buf(x, 0) + e, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  }
  for (int e = 4 * threadIdx.x; e < W * D; e += 4 * blockDim.x) {
    const float4 a = ld4(qfb + e), b = ld4(pos + e);
    st4(buf(x, 1) + e, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  }
  __syncthreads();
  conv_block<kBf16>(buf(x, 0), T, x, cb, s.buf[0], s.buf[1]);
  conv_block<kBf16>(buf(x, 1), W, x, cb, s.buf[0], s.buf[1]);
  int cur = 0;
  for (int li = 0; li < attn_layer; ++li) {
    const DualW dw = take_dual(c, D);
    dual_attn<kBf16>(buf(x, cur), buf(x, cur + 1), vm, qm, T, W, x, dw, scale, s,
              buf(x, 2 - cur));
    dual_attn<kBf16>(buf(x, cur + 1), buf(x, cur), qm, vm, W, T, x, dw, scale, s,
              buf(x, 3 - cur));
    cur = 2 - cur;
  }
  return cur;
}

// CQ fusion both ways, weighted pooling, cq_cat, the matching softmax (to
// ms_out) and the soft label embedding: fuse and then outp in the final
// streams' buffers.
template <bool kBf16>
__device__ __noinline__ void fuse(const Ctx& x, Cursor& c, const float* vm,
                                  const float* qm, int cur, const Scratch& s,
                                  float* ms_out, int use_gumbel, float tau) {
  const int T = x.T, W = x.W, D = x.D, D2 = 2 * D;
  const int xv = cur, xq = cur + 1, q2v = 2 - cur, v2q = 3 - cur;
  float* cqreg = buf(x, kBuffers);
  const CQW q2v_w = take_cq(c, D);
  const CQW v2q_w = take_cq(c, D);
  cq_attention<kBf16>(buf(x, xv), buf(x, xq), vm, qm, T, W, x, q2v_w, s.buf[0],
               vec(x, 0), vec(x, 1), cqreg, s.buf[1], buf(x, q2v));
  cq_attention<kBf16>(buf(x, xq), buf(x, xv), qm, vm, W, T, x, v2q_w, s.buf[0],
               vec(x, 0), vec(x, 1), cqreg, s.buf[1], buf(x, v2q));
  const float* wp = c.take(D);
  const Dense cq_cat = take_dense(c, 2 * D, D);
  row_dots(buf(x, v2q), W, D, wp, vec(x, 2));
  __syncthreads();
  if (threadIdx.x < kWarp) {  // masked softmax over W, one warp
    float* poolx = vec(x, 2);
    const int lane = threadIdx.x;
    float mx = -INFINITY;
    for (int j = lane; j < W; j += kWarp) {
      poolx[j] = poolx[j] * qm[j] + kMask * (1.0f - qm[j]);
      mx = fmaxf(mx, poolx[j]);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < W; j += kWarp) {
      poolx[j] = expf(poolx[j] - mx);
      sum += poolx[j];
    }
    sum = warp_sum(sum);
    for (int j = lane; j < W; j += kWarp) poolx[j] = poolx[j] / sum;
  }
  __syncthreads();
  {
    const float *v2qp = buf(x, v2q), *poolx = vec(x, 2);
    float* pooled = vec(x, 3 + kLabels);
    for (int c2 = threadIdx.x; c2 < D; c2 += blockDim.x) {
      float a = 0.0f;
      for (int j = 0; j < W; ++j) a += v2qp[j * D + c2] * poolx[j];
      pooled[c2] = a;
    }
  }
  __syncthreads();
  {
    const float *q2vp = buf(x, q2v), *pooled = vec(x, 3 + kLabels);
    float* wide = s.buf[1];
    for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
      const int t = e / D, c2 = e % D;
      wide[t * D2 + c2] = q2vp[e];
      wide[t * D2 + D + c2] = pooled[c2];
    }
  }
  __syncthreads();
  float* fuse_out = buf(x, xv);  // the streams are spent
  dense<kBf16>(s.buf[1], D2, T, D2, D, cq_cat, x,
        [=](int m, int n, float v, float) { fuse_out[m * D + n] = v; });
  __syncthreads();

  // matching head + soft label embedding
  const Dense match = take_dense(c, D, kLabels);
  const float* label_emb = c.take(kLabels * D);
  float* mlog = vec(x, 3);
  // an mm in the JAX kernel: it rounds on the bf16 path too
  narrow_dense<kBf16>(buf(x, xv), T, D, kLabels, match.w,
                      [=](int m, int n, float v) { mlog[m * kLabels + n] = v + match.b[n]; });
  __syncthreads();
  mlog = vec(x, 3);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float l[kLabels];
    float mx = -INFINITY;
    for (int k = 0; k < kLabels; ++k) {
      l[k] = mlog[t * kLabels + k];
      if (use_gumbel) l[k] = l[k] / tau;  // the deterministic part only
      mx = fmaxf(mx, l[k]);
    }
    float sum = 0.0f;
    for (int k = 0; k < kLabels; ++k) {
      l[k] = expf(l[k] - mx);
      sum += l[k];
    }
    for (int k = 0; k < kLabels; ++k) {
      const float prob = l[k] / sum;
      mlog[t * kLabels + k] = prob;
      ms_out[t * kLabels + k] = prob;
    }
  }
  __syncthreads();
  {
    const float* fz = buf(x, xv);
    float* outp = buf(x, xq);
    for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
      const int t = e / D, c2 = e % D;
      float soft = 0.0f;
      for (int k = 0; k < kLabels; ++k) {
        // mm(mscores, label_emb) in the JAX kernel: it rounds on the bf16 path
        const float p = mlog[t * kLabels + k], l = label_emb[k * D + c2];
        soft += kBf16 ? round_bf16(p) * round_bf16(l) : p * l;
      }
      outp[e] = (fz[e] + soft) * vm[t];
    }
  }
  __syncthreads();
}

// The conditioned predictor: the feature encoder twice (into the spent
// pair's buffers), then per side [LN(feats), outp] @ hidden + b -> relu
// -> . dense + b.
template <bool kBf16>
__device__ __noinline__ void predict(const Ctx& x, Cursor& c, const float* vm,
                                     int cur, int P, float scale,
                                     const Scratch& s, float* start_logits,
                                     float* end_logits) {
  const int T = x.T, D = x.D, D2 = 2 * D;
  const int outp = cur + 1, start_f = 2 - cur, end_f = 3 - cur;
  FEW fe;
  fe.pos = c.take(static_cast<long>(P) * D);
  fe.conv = take_conv_block(c, D);
  fe.ln1 = take_ln(c, D);
  fe.q = take_dense(c, D, D);
  fe.k = take_dense(c, D, D);
  fe.v = take_dense(c, D, D);
  fe.ln2 = take_ln(c, D);
  fe.dense = take_dense(c, D, D);
  feature_encoder<kBf16>(buf(x, outp), vm, x, fe, scale, s, buf(x, start_f));
  feature_encoder<kBf16>(buf(x, start_f), vm, x, fe, scale, s, buf(x, end_f));
  const LN lns[2] = {take_ln(c, D), take_ln(c, D)};
  Dense hidden[2], last[2];
  hidden[0] = take_dense(c, D2, D);
  hidden[1] = take_dense(c, D2, D);
  last[0] = take_dense(c, D, 1);
  last[1] = take_dense(c, D, 1);
  for (int which = 0; which < 2; ++which) {
    float* wide = s.buf[1];
    layer_norm(buf(x, which ? end_f : start_f), wide, D2, T, D, lns[which]);
    const float* op = buf(x, outp);
    for (int e = threadIdx.x; e < T * D; e += blockDim.x)
      wide[(e / D) * D2 + D + e % D] = op[e];
    __syncthreads();
    float* hid = s.buf[0];
    dense<kBf16>(wide, D2, T, D2, D, hidden[which], x,
                 [=](int m, int n, float v, float) { hid[m * D + n] = fmaxf(v, 0.0f); });
    __syncthreads();
    const float* lb = last[which].b;
    float* out = which ? end_logits : start_logits;
    narrow_dense<false>(s.buf[0], T, D, 1, last[which].w,
                        [=](int m, int, float v) { out[m] = v + lb[0]; });
    __syncthreads();
  }
}

struct Params {
  const float* weights;
  const float* vf;        // (B, T, D)
  const float* qf;        // (B, W, D)
  const int32_t* v_mask;  // (B, T)
  const int32_t* q_mask;  // (B, W)
  float* start_logits;    // (B, T)
  float* end_logits;      // (B, T)
  float* match_scores;    // (B, T, 4)
  float* workspace;
  long ws_floats;  // per sample
  int T, W, D, H, attn_layer, P;
  float tau;
  int use_gumbel;
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    fused_forward_kernel(const Params p) {
  const int b = blockIdx.x;
  const int T = p.T, W = p.W, D = p.D;
  const int Lm = max(T, W);
  const long ld = static_cast<long>(Lm) * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / p.H));

  extern __shared__ __align__(16) float smem[];
  const SmemLayout lay(T, W, D, p.H);
  Ctx x;
  x.T = T;
  x.W = W;
  x.D = D;
  x.H = p.H;
  x.Lm = Lm;
  x.stage = smem;
  x.stage_floats = lay.a_floats + lay.b_floats;
  x.a_floats = lay.a_floats;
  x.S = smem + lay.region;
  x.lds = lay.score_ld;
  x.heads = lay.heads;
  float* vm = x.S + static_cast<long>(lay.heads) * lay.head_floats;  // (T)
  float* qm = vm + T;                  // (W) query mask
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    vm[t] = static_cast<float>(p.v_mask[static_cast<long>(b) * T + t]);
  for (int t = threadIdx.x; t < W; t += blockDim.x)
    qm[t] = static_cast<float>(p.q_mask[static_cast<long>(b) * W + t]);

  x.ws = p.workspace + b * p.ws_floats;
  x.ld = ld;
  Scratch s;
  for (int i = 0; i < 9; ++i) s.buf[i] = buf(x, 4 + i);
  Cursor c{p.weights};
  const int cur = encode<kBf16>(x, c, p.vf + static_cast<long>(b) * T * D,
                         p.qf + static_cast<long>(b) * W * D, vm, qm, p.P,
                         p.attn_layer, scale, s);
  fuse<kBf16>(x, c, vm, qm, cur, s,
              p.match_scores + static_cast<long>(b) * T * kLabels, p.use_gumbel,
              p.tau);
  predict<kBf16>(x, c, vm, cur, p.P, scale, s,
                 p.start_logits + static_cast<long>(b) * T,
                 p.end_logits + static_cast<long>(b) * T);
}

// Opts the kernel's instantiation in to `smem` bytes of dynamic shared
// memory and launches it; returns the first CUDA error.
template <bool kBf16>
int launch(const Params& p, int B, int smem, cudaStream_t stream) {
  const cudaError_t rc = cudaFuncSetAttribute(
      fused_forward_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_forward_kernel<kBf16><<<B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long fused_forward_weight_floats(int D, int attn_layer, int P) {
  const long long conv = kConvLayers * (2LL * D + kConvK * D + D * D + D);
  const long long dual = 6LL * D + 10LL * (D * D + D) + 2LL * (2 * D * D + D) +
                         2LL * (D * D + D);
  const long long cq = 3LL * D + 4LL * D * D;
  return 1LL * P * D + conv + attn_layer * dual + 2 * cq +
         (D + 2LL * D * D + D) + (D * kLabels + kLabels) + kLabels * D +
         (1LL * P * D + conv + 2LL * D + 3LL * (D * D + D) + 2LL * D +
          (D * D + D)) +
         4LL * D + 2LL * (2 * D * D + D) + 2LL * (D + 1);
}

extern "C" long long fused_forward_workspace_floats(int T, int W, int D, int H) {
  (void)H;  // attention scores live in shared memory
  const long long lm = T > W ? T : W;
  const long long n = kBuffers * lm * D + 4 * lm * lm + (3 + kLabels) * lm + D;
  return (n + 31) / 32 * 32;  // 128-byte aligned samples
}

extern "C" long long fused_forward_smem_bytes(int T, int W, int D, int H) {
  return SmemLayout(T, W, D, H).floats() * static_cast<long long>(sizeof(float));
}

extern "C" int fused_forward_heads_per_group(int T, int W, int D, int H) {
  return SmemLayout(T, W, D, H).heads;
}

extern "C" int fused_forward_threads() { return kThreads; }

extern "C" int fused_forward_max_len() { return kMaxLen; }

extern "C" int fused_forward_max_dim() { return kMaxDim; }

extern "C" int fused_forward_f32(const void* weights, const void* vf,
                                 const void* qf, const void* v_mask,
                                 const void* q_mask, void* start_logits,
                                 void* end_logits, void* match_scores,
                                 void* workspace, int B, int T, int W, int D,
                                 int H, int attn_layer, int P, float tau,
                                 int use_gumbel, int mxu_bf16, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || W < 1 || T > kMaxLen || W > kMaxLen || D > kMaxDim ||
      D % 4 != 0 || H < 1 || D % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.weights = static_cast<const float*>(weights);
  p.vf = static_cast<const float*>(vf);
  p.qf = static_cast<const float*>(qf);
  p.v_mask = static_cast<const int32_t*>(v_mask);
  p.q_mask = static_cast<const int32_t*>(q_mask);
  p.start_logits = static_cast<float*>(start_logits);
  p.end_logits = static_cast<float*>(end_logits);
  p.match_scores = static_cast<float*>(match_scores);
  p.workspace = static_cast<float*>(workspace);
  p.ws_floats = fused_forward_workspace_floats(T, W, D, H);
  p.T = T;
  p.W = W;
  p.D = D;
  p.H = H;
  p.attn_layer = attn_layer;
  p.P = P;
  p.tau = tau;
  p.use_gumbel = use_gumbel;
  const int smem = static_cast<int>(fused_forward_smem_bytes(T, W, D, H));
  return mxu_bf16 ? launch<true>(p, B, smem, static_cast<cudaStream_t>(stream))
                  : launch<false>(p, B, smem, static_cast<cudaStream_t>(stream));
}
