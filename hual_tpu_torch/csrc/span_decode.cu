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
// launch-bound.  The design keeps it to a single launch with no scratch in
// device memory: one warp per row, kRowsPerBlock rows per block, the row's
// probabilities in shared memory, warp shuffles for the max, sum and argmax
// reductions, expf (not __expf) so the probabilities match the plain
// version's.  Each lane rescans the row for the running maxima of its own
// positions, O(T^2/32) shared-memory reads: simple, and small at T <= 100,
// but it makes the in-kernel time grow with T^2 (PERF.md).
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

  // Each lane owns positions lane, lane+32, ...; it walks them in order and
  // keeps the first maximum, and warp_argmax keeps the smallest index.
  float best_s = -1.0f, best_e = -1.0f;
  int arg_s = 0, arg_e = 0;
  for (int k = lane; k < T; k += kWarp) {
    float e_max = 0.0f;  // max_{j>=k} e_j
    for (int j = k; j < T; ++j) e_max = fmaxf(e_max, ep[j]);
    float s_max = 0.0f;  // max_{i<=k} s_i
    for (int i = 0; i <= k; ++i) s_max = fmaxf(s_max, sp[i]);
    const float r = sp[k] * e_max;
    const float c = ep[k] * s_max;
    if (r > best_s) {
      best_s = r;
      arg_s = k;
    }
    if (c > best_e) {
      best_e = c;
      arg_e = k;
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
