// Span decode on Hopper: masked softmax of start and end logits, then
//   start = argmax_i max_{j>=i} s_i * e_j,   end = argmax_j max_{i<=j} s_i * e_j
// with ties going to the first index.
//
// Replaces the TPU kernel hual_tpu/ops/pallas/span_decode.py::
// _span_decode_kernel (wrapper span_decode_pallas), which keeps the
// (B, T, T) outer product in VMEM.  Here it never exists at all: f32
// multiplication by a non-negative number is monotone, so
//   max_{j>=i} fl(s_i * e_j) == fl(s_i * max_{j>=i} e_j)
// exactly, and each row / column maximum is one product against a running
// maximum over the triangle.  The indices equal the plain PyTorch decode
// (hual_tpu_torch/ops/decode.py) bit for bit.
//
// Bound on the H100: bytes.  It reads three (B, T) arrays and writes two (B,)
// ones: 3*B*T*4 + 2*B*4 bytes, about 74 KB at B=96, T=64, i.e. ~22 ns at
// 3.35 TB/s.  So one launch costs more than the work: the kernel is
// launch-bound, and no design can reach that bound: it lies below a launch's
// latency.  The design keeps it to a single launch with no scratch in
// device memory: one warp per row, kRowsPerBlock rows per block, the row's
// probabilities in shared memory, warp shuffles for the max, sum and argmax
// reductions, expf (not __expf) so the probabilities match the plain
// version's.  The running maxima are warp scans over 32-position chunks:
// a prefix max of s (__shfl_up_sync), walking the chunks forwards, and a
// suffix max of e (__shfl_down_sync), walking them backwards, each carrying
// the maximum across chunks: O(T/32) steps a lane, where rescanning the
// row for each position would be O(T^2/32).  max is exact and independent
// of order, so every product and index equals the plain decode's.
//
// Plain C interface, bound from Python with ctypes; the entry point returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Index of the warp-wide maximum; equal values go to the smaller index.
__device__ __forceinline__ int warp_argmax(float v, int idx) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  return idx;
}

// Softmax of x*mask + (1-mask)*-1e30 over one row, written to p[0..T).
// The sum runs as PyTorch's warp softmax runs it: each lane adds its
// elements in order, then a butterfly across the warp.
__device__ void masked_softmax_row(const float* __restrict__ x,
                                   const int32_t* __restrict__ mask,
                                   float* p, int T, int lane) {
  float m = -INFINITY;
  for (int i = lane; i < T; i += kWarp) {
    const float mk = static_cast<float>(mask[i]);
    const float v = x[i] * mk + kMaskValue * (1.0f - mk);
    p[i] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float sum = 0.0f;
  for (int i = lane; i < T; i += kWarp) {
    const float a = expf(p[i] - m);
    p[i] = a;
    sum += a;
  }
  sum = warp_sum(sum);
  for (int i = lane; i < T; i += kWarp) p[i] = p[i] / sum;
}

__global__ void span_decode_kernel(const float* __restrict__ start_logits,
                                   const float* __restrict__ end_logits,
                                   const int32_t* __restrict__ mask,
                                   int32_t* __restrict__ start_index,
                                   int32_t* __restrict__ end_index, int B,
                                   int T) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= B) return;  // whole warps leave; the block never synchronises

  float* sp = smem + warp * 2 * T;
  float* ep = sp + T;
  const size_t off = static_cast<size_t>(row) * T;
  masked_softmax_row(start_logits + off, mask + off, sp, T, lane);
  masked_softmax_row(end_logits + off, mask + off, ep, T, lane);
  __syncwarp();

  // Each lane owns positions lane, lane+32, ...  Start: s_k * max_{j>=k} e_j,
  // chunks walked backwards, so a lane keeps the LAST maximum it meets (>=),
  // which is its smallest index; end: e_k * max_{i<=k} s_i, chunks walked
  // forwards, keeping the first (>).  warp_argmax then keeps the smallest
  // index of the warp.  Positions past T read 0, below every probability's
  // maximum, so they change no running maximum.
  const int chunks = (T + kWarp - 1) / kWarp;
  float carry = 0.0f, best_s = -1.0f, best_e = -1.0f;
  int arg_s = 0, arg_e = 0;
  for (int c = chunks - 1; c >= 0; --c) {
    const int k = c * kWarp + lane;
    float m = k < T ? ep[k] : 0.0f;  // suffix max of e within the chunk
    for (int o = 1; o < kWarp; o <<= 1) {
      const float y = __shfl_down_sync(kFull, m, o);
      if (lane + o < kWarp) m = fmaxf(m, y);
    }
    m = fmaxf(m, carry);
    carry = __shfl_sync(kFull, m, 0);
    if (k < T) {
      const float r = sp[k] * m;
      if (r >= best_s) {
        best_s = r;
        arg_s = k;
      }
    }
  }
  carry = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int k = c * kWarp + lane;
    float m = k < T ? sp[k] : 0.0f;  // prefix max of s within the chunk
    for (int o = 1; o < kWarp; o <<= 1) {
      const float y = __shfl_up_sync(kFull, m, o);
      if (lane >= o) m = fmaxf(m, y);
    }
    m = fmaxf(m, carry);
    carry = __shfl_sync(kFull, m, kWarp - 1);
    if (k < T) {
      const float e = ep[k] * m;
      if (e > best_e) {
        best_e = e;
        arg_e = k;
      }
    }
  }
  arg_s = warp_argmax(best_s, arg_s);
  arg_e = warp_argmax(best_e, arg_e);
  if (lane == 0) {
    start_index[row] = arg_s;
    end_index[row] = arg_e;
  }
}

}  // namespace

extern "C" int span_decode_f32(const void* start_logits, const void* end_logits,
                               const void* mask, void* start_index,
                               void* end_index, int B, int T, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * kWarp);
  const size_t smem = static_cast<size_t>(kRowsPerBlock) * 2 * T * sizeof(float);
  span_decode_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(start_logits),
      static_cast<const float*>(end_logits), static_cast<const int32_t*>(mask),
      static_cast<int32_t*>(start_index), static_cast<int32_t*>(end_index), B,
      T);
  return static_cast<int>(cudaGetLastError());
}
