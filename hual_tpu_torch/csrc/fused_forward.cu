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
// 0.23 ms at 67 TFLOP/s (the fp32 peak outside the tensor cores, and the
// fp64 peak of the tensor cores); the bytes (3.9 MB of packed weights,
// 4.0 MB of inputs and outputs at B=96) take ~2.4 us at 3.35 TB/s.
//
// Design, layout (a) of the two offered: ONE kernel, one 256-thread block
// per sample, walking every stage with __syncthreads() between them.  It is
// the simplest layout that keeps the whole forward in one launch and keeps
// samples apart by construction.  The activations live in a per-sample
// workspace in device memory (the wrapper allocates it with torch.empty;
// fused_forward_workspace_floats gives its size, ~0.8 MB a sample at T=64),
// read back through the SM's L1 and the 50 MB L2; the masks sit in shared
// memory.  Every product is this file's own code: a register-tiled FMA loop
// (4x4 outputs per thread, operands through L1), with no cuBLAS, no TF32
// and no tensor cores.  Operands and stored activations are f32; each
// product's sum runs in f64 and is rounded to f32 once.  The reason is the
// parity bound on the match scores (atol 1e-5): at B=96 an f32 forward is
// itself ~1e-5 away from the exact one (chip_smoke.py prints the plain
// version's f32 error), so K2 is held against the plain version in f64
// and has to be more exact than f32 summation.  expf and true division
// throughout, no fast math: K1 decodes these logits, and its indices flip
// on near-ties.  What this leaves on the table, for later work: one block
// per sample uses B of the 132 SMs with 8 warps each, so the FMA loops are
// latency-bound; staging operand tiles in shared memory and wgmma on bf16
// are the next steps.
//
// Plain C interface, bound from Python with ctypes; the entry point returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kConvK = 7;       // depthwise kernel width
constexpr int kConvLayers = 4;  // layers of a conv block
constexpr int kLabels = 4;      // matching-head classes
constexpr float kMask = -1e30f;

// Per-sample workspace: kBuffers buffers of Lm x D (Lm = max(T, W)), one of
// Lm x 4D, a score region of max(2H, 4) x Lm x Lm and 5 small vectors.
constexpr int kBuffers = 19;

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
// Batched strided product: for bi < nb, m < M, n < N
//   epi(bi, m, n, sum_k A[bi*a_b + m*a_m + k*a_k] * B[bi*b_b + k*b_k + n*b_n])
// Each thread owns 4x4 tiles of outputs; consecutive threads take
// consecutive column tiles, so a warp reads one A value (broadcast) and 128
// consecutive B values per k when b_n == 1.  The f32 operands are
// multiplied and summed in f64, in order over k, and the sum is rounded to
// f32 once (see the note at the top).
template <class Epi>
__device__ void gemm(int nb, int M, int N, int K, const float* A, long a_b,
                     int a_m, int a_k, const float* B, long b_b, int b_k,
                     int b_n, Epi epi) {
  const int tm = (M + 3) / 4, tn = (N + 3) / 4;
  const int per_b = tm * tn;
  const int tiles = nb * per_b;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int bi = t / per_b;
    const int r = t - bi * per_b;
    const int m0 = (r / tn) * 4, n0 = (r % tn) * 4;
    const float* Ab = A + bi * a_b;
    const float* Bb = B + bi * b_b;
    int am[4], bn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      am[i] = min(m0 + i, M - 1) * a_m;  // clamped rows: computed, not stored
      bn[i] = min(n0 + i, N - 1) * b_n;
    }
    double acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ab[am[i] + k * a_k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bb[k * b_k + bn[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + i < M && n0 + j < N)
          epi(bi, m0 + i, n0 + j, static_cast<float>(acc[i][j]));
  }
}

// y[m, n] = epi(m, n, x[m, :] @ W[:, n]) for a dense layer; x is (M, K)
// row-major with row stride K.
template <class Epi>
__device__ void dense(const float* x, int M, int K, int N, const float* w,
                      Epi epi) {
  gemm(1, M, N, K, x, 0, K, 1, w, 0, N, 1,
       [&](int, int m, int n, float acc) { epi(m, n, acc); });
}

// LayerNorm over the last axis (eps 1e-6), one warp per row; y has row
// stride ldy.
__device__ void layer_norm(const float* x, float* y, int ldy, int L, int D,
                           LN p) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int row = warp; row < L; row += kWarps) {
    const float* xr = x + static_cast<long>(row) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += kWarp) s += xr[d];
    const float mean = warp_sum(s) / D;
    float v = 0.0f;
    for (int d = lane; d < D; d += kWarp) {
      const float c = xr[d] - mean;
      v += c * c;
    }
    const float inv = rsqrtf(warp_sum(v) / D + 1e-6f);
    float* yr = y + static_cast<long>(row) * ldy;
    for (int d = lane; d < D; d += kWarp)
      yr[d] = (xr[d] - mean) * inv * p.scale[d] + p.bias[d];
  }
}

// Softmax over each of R rows of length N (row stride ld), in place; one
// warp per row.
__device__ void softmax_rows(float* s, int R, int N, int ld) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int row = warp; row < R; row += kWarps) {
    float* r = s + static_cast<long>(row) * ld;
    float m = -INFINITY;
    for (int j = lane; j < N; j += kWarp) m = fmaxf(m, r[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < N; j += kWarp) {
      const float e = expf(r[j] - m);
      r[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += kWarp) r[j] = r[j] / sum;
  }
}

// out[row] = x[row, :] . v, one warp per row.
__device__ void row_dots(const float* x, int L, int D, const float* v,
                         float* out) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int row = warp; row < L; row += kWarps) {
    const float* xr = x + static_cast<long>(row) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += kWarp) s += xr[d] * v[d];
    s = warp_sum(s);
    if (lane == 0) out[row] = s;
  }
}

struct Dims {
  int T, W, D, H, Lm;
};

// x (L x D) in place: kConvLayers x {LN -> depthwise k=7 SAME, zero padding
// at both ends of L, mask ignored -> pointwise + bias -> relu -> + residual}.
__device__ void conv_block(float* x, int L, const Dims& d, const ConvBlockW& w,
                           float* h, float* acc) {
  const int D = d.D;
  for (int i = 0; i < kConvLayers; ++i) {
    layer_norm(x, h, D, L, D, w.ln[i]);
    __syncthreads();
    const float* f = w.dw[i];
    for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
      const int t = e / D, c = e % D;
      float a = 0.0f;
      for (int k = 0; k < kConvK; ++k) {
        const int s = t + k - kConvK / 2;
        if (s >= 0 && s < L) a += h[s * D + c] * f[k * D + c];
      }
      acc[e] = a;
    }
    __syncthreads();
    const float* b = w.pw[i].b;
    dense(acc, L, D, D, w.pw[i].w, [&](int m, int n, float v) {
      float* o = x + m * D + n;
      *o = fmaxf(v + b[n], 0.0f) + *o;
    });
    __syncthreads();
  }
}

// Multi-head attention scores for nb = H heads:
//   S[h, i, j] = (q_h[i] . k_h[j]) * scale + (1 - fm[i] * tm[j]) * -1e30
// An all-padding `from` row gets -1e30 on every score: the finite part is
// absorbed and the row attends uniformly over the whole Tk.
__device__ void attn_scores(const float* q, const float* k, const float* fm,
                            const float* tm, int Tq, int Tk, const Dims& d,
                            float scale, float* S) {
  const int hd = d.D / d.H;
  const long per_head = static_cast<long>(Tq) * Tk;
  gemm(d.H, Tq, Tk, hd, q, hd, d.D, 1, k, hd, 1, d.D,
       [&](int h, int i, int j, float acc) {
         S[h * per_head + i * Tk + j] =
             acc * scale + (1.0f - fm[i] * tm[j]) * kMask;
       });
}

// out[i, h*hd + c] = sum_j P[h, i, j] * v[j, h*hd + c]
__device__ void attn_values(const float* P, const float* v, int Tq, int Tk,
                            const Dims& d, float* out) {
  const int hd = d.D / d.H;
  const int D = d.D;
  gemm(d.H, Tq, hd, Tk, P, static_cast<long>(Tq) * Tk, Tk, 1, v, hd, D, 1,
       [&](int h, int i, int c, float acc) { out[i * D + h * hd + c] = acc; });
}

struct Scratch {
  float* buf[9];  // Lm x D each
  float* S;       // score region
};

// One dual-attention layer in one direction: from (Tq rows) attends to
// itself and to `to` (Tk rows); the result goes to dest (Tq x D).
__device__ void dual_attn(const float* from, const float* to, const float* fm,
                          const float* tm, int Tq, int Tk, const Dims& d,
                          const DualW& w, float scale, const Scratch& s,
                          float* dest) {
  const int D = d.D;
  float *out = s.buf[0], *ton = s.buf[1], *qp = s.buf[2], *fk = s.buf[3],
        *fv = s.buf[4], *tk = s.buf[5], *tv = s.buf[6], *sout = s.buf[7],
        *xout = s.buf[8];
  float* S1 = s.S;                                       // H x Tq x Tq
  float* S2 = s.S + static_cast<long>(d.H) * d.Lm * d.Lm;  // H x Tq x Tk

  layer_norm(from, out, D, Tq, D, w.ln1);
  layer_norm(to, ton, D, Tk, D, w.lnt);
  __syncthreads();
  auto store = [&](float* y, const float* b) {
    return [=](int m, int n, float v) { y[m * D + n] = v + b[n]; };
  };
  dense(out, Tq, D, D, w.query.w, store(qp, w.query.b));
  dense(out, Tq, D, D, w.f_key.w, store(fk, w.f_key.b));
  dense(out, Tq, D, D, w.f_value.w, store(fv, w.f_value.b));
  dense(ton, Tk, D, D, w.t_key.w, store(tk, w.t_key.b));
  dense(ton, Tk, D, D, w.t_value.w, store(tv, w.t_value.b));
  __syncthreads();
  attn_scores(qp, fk, fm, fm, Tq, Tq, d, scale, S1);
  attn_scores(qp, tk, fm, tm, Tq, Tk, d, scale, S2);
  __syncthreads();
  softmax_rows(S1, d.H * Tq, Tq, Tq);
  softmax_rows(S2, d.H * Tq, Tk, Tk);
  __syncthreads();
  attn_values(S1, fv, Tq, Tq, d, sout);
  attn_values(S2, tv, Tq, Tk, d, xout);
  __syncthreads();
  float *s_val = qp, *x_val = fk, *s_gate = fv, *x_gate = tk;
  dense(sout, Tq, D, D, w.s_dense.w, store(s_val, w.s_dense.b));
  dense(xout, Tq, D, D, w.x_dense.w, store(x_val, w.x_dense.b));
  __syncthreads();
  const float *sgb = w.s_gate.b, *xgb = w.x_gate.b;
  dense(s_val, Tq, D, D, w.s_gate.w, [&](int m, int n, float v) {
    s_gate[m * D + n] = sigmoidf(v + sgb[n]);
  });
  dense(x_val, Tq, D, D, w.x_gate.w, [&](int m, int n, float v) {
    x_gate[m * D + n] = sigmoidf(v + xgb[n]);
  });
  __syncthreads();
  float* mix = sout;
  for (int e = threadIdx.x; e < Tq * D; e += blockDim.x)
    mix[e] = s_gate[e] * x_val[e] + x_gate[e] * s_val[e];
  __syncthreads();
  float* outputs = xout;
  dense(mix, Tq, D, D, w.guided.w, store(outputs, w.guided.b));
  __syncthreads();
  // bilinear_k = out @ d1 + outputs @ d2 + b; the second product's epilogue
  // reads what the first stored at the same (m, n), which the same thread
  // wrote (both products have the same shape, hence the same tiling)
  float *scores = tv, *values = sout;
  dense(out, Tq, D, D, w.b1d1, [&](int m, int n, float v) { scores[m * D + n] = v; });
  dense(out, Tq, D, D, w.b2d1, [&](int m, int n, float v) { values[m * D + n] = v; });
  const float *b1b = w.b1b, *b2b = w.b2b;
  dense(outputs, Tq, D, D, w.b1d2, [&](int m, int n, float v) {
    float* o = scores + m * D + n;
    *o = (*o + v) + b1b[n];
  });
  dense(outputs, Tq, D, D, w.b2d2, [&](int m, int n, float v) {
    float* o = values + m * D + n;
    *o = (*o + v) + b2b[n];
  });
  __syncthreads();
  // gate: sigmoid(scores*m + -1e30*(1-m)) * values, exactly 0 on padded rows
  float* gated = qp;
  for (int e = threadIdx.x; e < Tq * D; e += blockDim.x) {
    const float m = fm[e / D];
    gated[e] = sigmoidf(scores[e] * m + kMask * (1.0f - m)) * values[e];
  }
  __syncthreads();
  float* res = fk;
  const float* d1b = w.dense_1.b;
  dense(gated, Tq, D, D, w.dense_1.w, [&](int m, int n, float v) {
    res[m * D + n] = (v + d1b[n]) + from[m * D + n];
  });
  __syncthreads();
  layer_norm(res, fv, D, Tq, D, w.ln2);
  __syncthreads();
  const float* d2b = w.dense_2.b;
  dense(fv, Tq, D, D, w.dense_2.w, [&](int m, int n, float v) {
    dest[m * D + n] = (v + d2b[n]) + res[m * D + n];
  });
  __syncthreads();
}

// CQ attention: x1 (T1 rows) against x2 (T2 rows) -> out (T1 x D).
//   score = x1.w0 + (x2.w1)^T + (x1*wm) @ x2^T
//   score_  = row softmax masking the `to` columns (m2)
//   score_t = column softmax over T1 masking the `from` rows (m1)
//   out = [x1, c2q, x1*c2q, x1*q2c] @ dense, c2q = score_ @ x2,
//   q2c = (score_ @ score_t^T) @ x1
__device__ void cq_attention(const float* x1, const float* x2, const float* m1,
                             const float* m2, int T1, int T2, const Dims& d,
                             const CQW& w, float* x1wm, float* sub0,
                             float* sub1, float* Sreg, float* att,
                             float* out) {
  const int D = d.D;
  const long lm2 = static_cast<long>(d.Lm) * d.Lm;
  float *sc = Sreg, *s_ = Sreg + lm2, *st = Sreg + 2 * lm2, *m1m = Sreg + 3 * lm2;
  row_dots(x1, T1, D, w.w0, sub0);
  row_dots(x2, T2, D, w.w1, sub1);
  for (int e = threadIdx.x; e < T1 * D; e += blockDim.x)
    x1wm[e] = x1[e] * w.wm[e % D];
  __syncthreads();
  gemm(1, T1, T2, D, x1wm, 0, D, 1, x2, 0, 1, D,
       [&](int, int i, int j, float acc) {
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
  gemm(1, T1, D, T2, s_, 0, T2, 1, x2, 0, D, 1,
       [&](int, int i, int c, float acc) {
         att[i * D4 + c] = x1[i * D + c];
         att[i * D4 + D + c] = acc;
         att[i * D4 + 2 * D + c] = x1[i * D + c] * acc;
       });
  // score_ @ score_t^T (T1 x T1)
  gemm(1, T1, T1, T2, s_, 0, T2, 1, st, 0, 1, T2,
       [&](int, int i, int i2, float acc) { m1m[i * T1 + i2] = acc; });
  __syncthreads();
  gemm(1, T1, D, T1, m1m, 0, T1, 1, x1, 0, D, 1,
       [&](int, int i, int c, float acc) {
         att[i * D4 + 3 * D + c] = x1[i * D + c] * acc;
       });
  __syncthreads();
  dense(att, T1, D4, D, w.dense.w,
        [&](int m, int n, float v) { out[m * D + n] = v; });
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
__device__ void feature_encoder(const float* x, const float* vm, const Dims& d,
                                const FEW& w, float scale, const Scratch& s,
                                float* y) {
  const int T = d.T, D = d.D;
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) y[e] = x[e] + w.pos[e];
  __syncthreads();
  conv_block(y, T, d, w.conv, s.buf[0], s.buf[1]);
  float *o = s.buf[0], *q = s.buf[1], *k = s.buf[2], *v = s.buf[3],
        *att = s.buf[4], *res = s.buf[5], *ln2 = s.buf[6];
  layer_norm(y, o, D, T, D, w.ln1);
  __syncthreads();
  auto store = [&](float* out, const float* b) {
    return [=](int m, int n, float val) { out[m * D + n] = val + b[n]; };
  };
  dense(o, T, D, D, w.q.w, store(q, w.q.b));
  dense(o, T, D, D, w.k.w, store(k, w.k.b));
  dense(o, T, D, D, w.v.w, store(v, w.v.b));
  __syncthreads();
  attn_scores(q, k, vm, vm, T, T, d, scale, s.S);
  __syncthreads();
  softmax_rows(s.S, d.H * T, T, T);
  __syncthreads();
  attn_values(s.S, v, T, T, d, att);
  __syncthreads();
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) res[e] = att[e] + y[e];
  __syncthreads();
  layer_norm(res, ln2, D, T, D, w.ln2);
  __syncthreads();
  const float* db = w.dense.b;
  dense(ln2, T, D, D, w.dense.w, [&](int m, int n, float val) {
    y[m * D + n] = (val + db[n]) + res[m * D + n];
  });
  __syncthreads();
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

__global__ void __launch_bounds__(kThreads)
    fused_forward_kernel(const Params p) {
  const int b = blockIdx.x;
  const int T = p.T, W = p.W, D = p.D;
  Dims d{T, W, D, p.H, max(T, W)};
  const long ld = static_cast<long>(d.Lm) * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / p.H));

  extern __shared__ float smem[];
  float* vm = smem;      // (T) video mask
  float* qm = smem + T;  // (W) query mask
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    vm[t] = static_cast<float>(p.v_mask[static_cast<long>(b) * T + t]);
  for (int t = threadIdx.x; t < W; t += blockDim.x)
    qm[t] = static_cast<float>(p.q_mask[static_cast<long>(b) * W + t]);

  float* ws = p.workspace + b * p.ws_floats;
  float* buf[kBuffers];
  for (int i = 0; i < kBuffers; ++i) buf[i] = ws + i * ld;
  float* wide = ws + kBuffers * ld;                 // Lm x 4D
  float* Sreg = wide + 4 * ld;                      // max(2H, 4) x Lm x Lm
  float* vec = Sreg + static_cast<long>(max(2 * p.H, 4)) * d.Lm * d.Lm;
  float *sub0 = vec, *sub1 = vec + d.Lm, *poolx = vec + 2 * d.Lm,
        *mlog = vec + 3 * d.Lm, *pooled = vec + 3 * d.Lm + kLabels * d.Lm;
  float *xv = buf[0], *xq = buf[1], *nv = buf[2], *nq = buf[3];
  Scratch s;
  for (int i = 0; i < 9; ++i) s.buf[i] = buf[4 + i];
  s.S = Sreg;
  float *q2v = buf[13], *v2q = buf[14], *fuse = buf[15], *outp = buf[16],
        *start_f = buf[17], *end_f = buf[18];

  // -- encoder: shared positional embedding + conv block on both streams
  Cursor c{p.weights};
  const float* pos = c.take(static_cast<long>(p.P) * D);
  const ConvBlockW cb = take_conv_block(c, D);
  const float* vfb = p.vf + static_cast<long>(b) * T * D;
  const float* qfb = p.qf + static_cast<long>(b) * W * D;
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) xv[e] = vfb[e] + pos[e];
  for (int e = threadIdx.x; e < W * D; e += blockDim.x) xq[e] = qfb[e] + pos[e];
  __syncthreads();
  conv_block(xv, T, d, cb, s.buf[0], s.buf[1]);
  conv_block(xq, W, d, cb, s.buf[0], s.buf[1]);

  // -- dual attention stack, both directions per layer
  for (int li = 0; li < p.attn_layer; ++li) {
    const DualW dw = take_dual(c, D);
    dual_attn(xv, xq, vm, qm, T, W, d, dw, scale, s, nv);
    dual_attn(xq, xv, qm, vm, W, T, d, dw, scale, s, nq);
    float* t = xv;
    xv = nv;
    nv = t;
    t = xq;
    xq = nq;
    nq = t;
  }

  // -- CQ fusion
  const CQW q2v_w = take_cq(c, D);
  const CQW v2q_w = take_cq(c, D);
  cq_attention(xv, xq, vm, qm, T, W, d, q2v_w, s.buf[0], sub0, sub1, Sreg,
               wide, q2v);
  cq_attention(xq, xv, qm, vm, W, T, d, v2q_w, s.buf[0], sub0, sub1, Sreg,
               wide, v2q);
  const float* wp = c.take(D);
  const Dense cq_cat = take_dense(c, 2 * D, D);
  row_dots(v2q, W, D, wp, poolx);
  __syncthreads();
  if (threadIdx.x < kWarp) {  // masked softmax over W, one warp
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
  for (int c2 = threadIdx.x; c2 < D; c2 += blockDim.x) {
    float a = 0.0f;
    for (int j = 0; j < W; ++j) a += v2q[j * D + c2] * poolx[j];
    pooled[c2] = a;
  }
  __syncthreads();
  const int D2 = 2 * D;
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
    const int t = e / D, c2 = e % D;
    wide[t * D2 + c2] = q2v[e];
    wide[t * D2 + D + c2] = pooled[c2];
  }
  __syncthreads();
  dense(wide, T, D2, D, cq_cat.w,
        [&](int m, int n, float v) { fuse[m * D + n] = v + cq_cat.b[n]; });
  __syncthreads();

  // -- matching head + soft label embedding
  const Dense match = take_dense(c, D, kLabels);
  const float* label_emb = c.take(kLabels * D);
  dense(fuse, T, D, kLabels, match.w, [&](int m, int n, float v) {
    mlog[m * kLabels + n] = v + match.b[n];
  });
  __syncthreads();
  float* ms_out = p.match_scores + static_cast<long>(b) * T * kLabels;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float l[kLabels];
    float mx = -INFINITY;
    for (int k = 0; k < kLabels; ++k) {
      l[k] = mlog[t * kLabels + k];
      if (p.use_gumbel) l[k] = l[k] / p.tau;  // the deterministic part only
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
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
    const int t = e / D, c2 = e % D;
    float soft = 0.0f;
    for (int k = 0; k < kLabels; ++k)
      soft += mlog[t * kLabels + k] * label_emb[k * D + c2];
    outp[e] = (fuse[e] + soft) * vm[t];
  }
  __syncthreads();

  // -- conditioned predictor
  FEW fe;
  fe.pos = c.take(static_cast<long>(p.P) * D);
  fe.conv = take_conv_block(c, D);
  fe.ln1 = take_ln(c, D);
  fe.q = take_dense(c, D, D);
  fe.k = take_dense(c, D, D);
  fe.v = take_dense(c, D, D);
  fe.ln2 = take_ln(c, D);
  fe.dense = take_dense(c, D, D);
  const LN start_ln = take_ln(c, D), end_ln = take_ln(c, D);
  const Dense start_hidden = take_dense(c, D2, D);
  const Dense end_hidden = take_dense(c, D2, D);
  const Dense start_dense = take_dense(c, D, 1);
  const Dense end_dense = take_dense(c, D, 1);
  feature_encoder(outp, vm, d, fe, scale, s, start_f);
  feature_encoder(start_f, vm, d, fe, scale, s, end_f);

  float* hid = s.buf[0];
  const float* feats[2] = {start_f, end_f};
  const LN lns[2] = {start_ln, end_ln};
  const Dense hidden[2] = {start_hidden, end_hidden};
  const Dense last[2] = {start_dense, end_dense};
  float* logits[2] = {p.start_logits + static_cast<long>(b) * T,
                      p.end_logits + static_cast<long>(b) * T};
  for (int which = 0; which < 2; ++which) {
    // [LN(feats), outputs] @ hidden + b -> relu -> . dense + b
    layer_norm(feats[which], wide, D2, T, D, lns[which]);
    for (int e = threadIdx.x; e < T * D; e += blockDim.x)
      wide[(e / D) * D2 + D + e % D] = outp[e];
    __syncthreads();
    const float* hb = hidden[which].b;
    dense(wide, T, D2, D, hidden[which].w, [&](int m, int n, float v) {
      hid[m * D + n] = fmaxf(v + hb[n], 0.0f);
    });
    __syncthreads();
    const float* lb = last[which].b;
    float* out = logits[which];
    dense(hid, T, D, 1, last[which].w,
          [&](int m, int, float v) { out[m] = v + lb[0]; });
    __syncthreads();
  }
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
  const long long lm = T > W ? T : W;
  const long long heads = 2 * H > 4 ? 2 * H : 4;
  return kBuffers * lm * D + 4 * lm * D + heads * lm * lm +
         (3 + kLabels) * lm + D;
}

extern "C" int fused_forward_f32(const void* weights, const void* vf,
                                 const void* qf, const void* v_mask,
                                 const void* q_mask, void* start_logits,
                                 void* end_logits, void* match_scores,
                                 void* workspace, int B, int T, int W, int D,
                                 int H, int attn_layer, int P, float tau,
                                 int use_gumbel, void* stream) {
  if (B <= 0) return 0;
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
  const size_t smem = static_cast<size_t>(T + W) * sizeof(float);
  fused_forward_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
