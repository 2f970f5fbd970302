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
// order of pack_order (a cursor walks it); the bf16 path reads the leaves
// it rounds from the pack's bf16 companion instead.
//
// Bound on the H100: operations.  About 161 MFLOP a sample at Charades
// width (T=64, W=13, D=128, 8 heads, 2 layers), 15.5 GFLOP at B=96, i.e.
// 0.23 ms at 67 TFLOP/s (the f64 peak of the tensor cores) on the f64
// path, 0.0156 ms at 989 TFLOP/s (the dense bf16 peak) on the bf16 path;
// the bytes (3.9 MB of packed weights, 4.0 MB of inputs and outputs at
// B=96) take ~2.4 us at 3.35 TB/s.  One block a sample holds one SM, so
// this layout can reach at most one SM's share of the peak: 161 MFLOP at
// 989/132 TFLOP/s = 21.5 us, the bf16 path's bound at any B <= 132.
//
// Design.  One block of 8 warps per sample walks every stage, with
// __syncthreads() between them.
// - Two product paths, chosen per launch (the JAX kernel's mxu_bf16): a
//   template flag kBf16 of the kernel, threaded through the stages to the
//   product routines (dense, gemm, attention, narrow_dense); everything
//   else is shared source, and the f64 instantiation has no branch of the
//   other path (a runtime switch cost it 3%, PERF.md).  Every product at
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
//   * bf16 (mxu_bf16), redesigned for Hopper (PERF.md): bf16
//     operands rounded to nearest even, f32 sums.  The products that round
//     follow the JAX kernel's mm/mmt: also the matching head and the soft
//     label embedding (CUDA cores, operands rounded); the pooling, the
//     tile, the row dots and the final (D,1) denses are elementwise sums or
//     layout moves there and stay f32.  The attention scale multiplies the
//     f32 sum, after the product, as in JAX.  Rounding gives the same bits
//     wherever it happens, so a weight rounded at pack time and an
//     activation rounded once into an image are the operands JAX
//     multiplies.  Against the first port of this path (mma.sync on the f64
//     path's f32 staging, every fragment converted in the k-loop):
//     - Weights: pack_weights keeps a bf16 companion of the leaves mm
//       rounds, each already the shared-memory image its product reads
//       (w^T, K-major core matrices of 8 rows x 8 values, 128 contiguous
//       bytes, no swizzle, in slabs of 64 k): half the f32 bytes, and no
//       conversion in the k-loop.
//     - The weight ring: the products' order is static, so the pack's
//       schedule lists every slab in product order; kRing = 6 slots of 16
//       KB, each landing on its mbarrier from one bulk copy
//       (cp.async.bulk, no tensor map) that thread 0 issues as soon as the
//       block is past the slot's last product.  The next products' weights
//       are in flight while a product and the stages between run: no
//       product waits for a first slab.  A slot holds 128 output columns
//       and a product takes at most 4 slabs (K <= 256) at once, so a dense
//       of more runs in column passes and in chunks of k, every chunk but
//       the last keeping its sums in the workspace for the next (the CQ
//       attentions' (4D x D) denses are two such chunks at D=128); rows
//       past 128 run in row passes under the same slabs (dense_bf16).
//     - Activations: the whole block rounds a product's rows once into the
//       A image in shared memory (16-byte stores in the image's order,
//       loads issued 4 chunks ahead); products that read the same rows
//       (query/f_key/f_value, t_key/t_value, the feature encoder's q/k/v,
//       the two bilinears) share one image.  The f32 values stay in the
//       device workspace for the residuals and LayerNorms.
//     - Instructions: a dense of more than 48 rows whose leaves are whole
//       slabs (D a multiple of 64: every product at Charades width but the
//       query stream's) runs on wgmma, A and B by descriptor: up to 64
//       rows m64n64k16 with the warpgroups across N, up to 128 rows
//       m64n128k16 with them across M, 4 to 16 instructions in one run
//       with no branch between them (a loop or divergent code there makes
//       ptxas serialise them and move the accumulators through local
//       memory, PERF.md).  The rest (the query stream at W=13 or 30, the
//       CQ products of two activations, ragged widths) runs mma.sync
//       m16n8k16 on the same images with fragments from ldmatrix, each
//       warp summing one 16 x 16 job at a time over the resident slabs.
//       Attention runs mma.sync too, one warp per (head, 16 query rows): q,
//       k and v rounded into per-head images (rows of up16(hd) values + 8,
//       conflict-free; a group of heads at a time where all do not fit),
//       q.k^T into registers (a row of up to 112 keys), the masked softmax
//       there (a row lies in the 4 lanes of a quad), p.v with p rounded
//       straight from the scores' accumulators, whose layout is the A
//       fragments'.  Over more than 112 keys it streams: one head and 128
//       query rows at a time, the keys in chunks of 64 and the head dims in
//       chunks of 64 staged in turn, a first pass for each row's running
//       maximum and sum and a second for p.v (attention_bf16_streamed).
//       Zero fill covers ragged k (hd=8, Tk=13) and padded keys; padded
//       rows and columns are never stored.
//     - Shared memory (Bf16Layout): the image region (a dense's A image,
//       the CQ products' two images or attention's q/k/v), the ring, its
//       barriers and the masks: 172,388 bytes at T=64, 227,896 at T=100.
//       Each stage's images take their resident form where it fits; the
//       CQ products tile (cq_tile rows, columns and k, up to 128) and the
//       attention groups its heads where it does not, so the block fits at
//       any shape.
//     What stays: the CUDA-core stages (LayerNorm, depthwise taps, softmaxes,
//     gates, CQ dots) and the activations' trips through the workspace.
//     Fragments (CUTLASS's SM80_16x8x16_F32BF16BF16F32_TN):
//     A[g][2t..2t+1], A[g+8][2t..2t+1], A[g][2t+8..2t+9],
//     A[g+8][2t+8..2t+9]; B[2t..2t+1][g], B[2t+8..2t+9][g]; C as above.
//     wgmma accumulators: thread 32w' + l of a warpgroup holds, for each 8
//     columns j, rows 16w' + g and 16w' + g + 8 at columns 8j + 2t, 8j + 2t +
//     1 (4 values a j).
// The f64 path's products and attention:
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
// - The A stage holds one pass's rows (at most 256), whatever T.
// - Attention in shared memory (SmemLayout's routes, see
//   fused_forward_routes): q, k and v are copied there once a call (over the
//   stages, which are free between products); then a group of heads at a
//   time (as many as fit: 4 of 8 at T=64, 1 at T=100) gets its Tq x Tk
//   scores there, the masked softmax over the real Tk (8 lanes a row), and
//   p.v, with both operands read in place and no barrier inside a product:
//   the warps take (head, tile) jobs in turn.  Where q, k and v of every
//   head do not fit beside one head's scores (T=W=128 at D=128), a group
//   of heads has its q, k and v copied in turn, its scores beside them;
//   where one head's scores do not fit either (T=256), each head's scores
//   go to the workspace through the staged products, the same sums in the
//   same order.
// Both paths:
// - The activations between stages stay in a per-sample workspace in
//   device memory (fused_forward_workspace_floats: 0.53 MB a sample at
//   T=64, 0.88 MB at T=100): 13 buffers of Lm x D, shared by activations
//   whose lifetimes do not overlap, the CQ attention's four Lm x Lm
//   matrices, 5 small vectors, a place for the masks where shared memory
//   has none left, and a split product's partial sums, read back through
//   L1 and L2.
// - Narrow products stay on the CUDA cores, summed in f64: the matching
//   head (N=4; on the bf16 path its kernel from the companion) and the
//   final (D,1) denses; the pooling and trilinear dots in f32.  LayerNorm
//   holds a row in registers (a float4 a lane) at D <= 128, a multiple of
//   4, and loops over chunks of 32 columns otherwise; the depthwise conv
//   and the elementwise stages go 4 channels a thread, or one where D is
//   not a multiple of 4.
// - Each bilinear of a dual-attention layer is one product with K = 2D:
//   out and the guided output share a buffer as the two halves of each
//   row, and the packed dense_1 and dense_2 kernels are adjacent, so
//   [out | outputs] @ [d1; d2] needs no read-modify-write epilogue (the
//   bf16 path reads the two leaves' slabs one after the other).
// - Epilogues capture by value, a product keeps its operands in locals,
//   and it loads the lane's bias values and residuals before its first
//   store (the bf16 path 16 outputs or one job at a time), handing them to
//   the epilogue: a load that follows a store it
//   may alias waits for it, output by output (PERF.md: 8% and 3% of the
//   call).
// - expf and true division throughout, no fast math: K1 decodes these
//   logits, and its indices flip on near-ties.  LayerNorm, softmaxes and
//   gates stay f32.
// Registers: every stage (encode, fuse, predict, conv block, attention,
// dual attention, CQ attention, feature encoder, LayerNorm, softmax) and
// every product is a separate function (__noinline__), and the kernel's
// pointers into the workspace are derived from the Ctx at each use, so no
// function holds more across a call than the ABI keeps: ptxas reports 236
// registers (f64 path) and 204 (bf16 path) for the resident build, 255 and
// 239 for the general one, no spills in either (sm_90a, CUDA 12.8).  ptxas
// allocates registers across the calls, a caller's live values above its
// callees', so the general build keeps its call chains short: the tiled
// dense runs from the stage itself (dense(): tiled_pass per pass, each
// derived from a counter), the streamed attentions are their own
// functions, and the streamed bf16 attention holds 64 keys a row.
// Resources: 256 threads; dynamic shared memory (fused_forward_smem_bytes,
// fused_forward_bf16_smem_bytes) of the stages or q/k/v, a head group's
// scores and the masks: 174 KB at T=64, 213 KB at T=100 (the bf16 path's
// above), opted in above 48 KB with cudaFuncSetAttribute.
// Shapes: any T >= 1, W >= 1 and D that H divides, as the Pallas kernel
// takes them; past what fits in kSmemLimit every stage tiles, with shared
// memory bounded whatever the shape (the wrapper's check_kernel_shape is
// the remainder).  Two builds of this file: the resident kernel
// (K2_GENERAL 0, this file) takes the shapes whose every stage is resident
// (fused_forward_takes: D <= 128 and a multiple of 4, at most 112 keys,
// every image in shared memory) with the code those shapes ran before the
// tiled routes existed; the general kernel (fused_forward_general.cu) takes
// every shape.  Compiled into one kernel, the routes the shipped shapes
// never run cost them up to 7% (PERF.md): they moved the resident
// code's register allocation and layout.
//
// Plain C interface, bound from Python with ctypes; the entry point returns
// the first CUDA error of its attribute call or launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The instantiations this library holds: the resident kernel (0), whose
// stages are the shapes' of the old limit and whose code is what it was
// before the tiled routes; or, built from fused_forward_general.cu, the
// general kernel (1), every route.
#ifndef K2_GENERAL
#define K2_GENERAL 0
#endif

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
constexpr long kSmemLimit = 232448;   // bytes of shared memory a block may use

// the bf16 path (mxu_bf16)
constexpr int kRing = 6;              // weight slabs in flight
constexpr int kKSlab = 64;            // k depth of a weight slab
constexpr int kRingRows = 128;        // output columns of a slot: a column pass
constexpr int kSlotValues = kRingRows * kKSlab;  // bf16 values of a ring slot
constexpr int kChunkSlabs = 4;        // slabs of one product: k <= 256 a chunk
constexpr int kRowPass = 128;         // rows of a dense's A image: a row pass
constexpr int kSyncRows = 48;         // products of up to 48 rows run on mma.sync
constexpr int kMaxKeyFrags = 14;      // 8-key fragments of a score row
constexpr int kKeyChunk = 8 * kMaxKeyFrags;  // keys a warp holds at once (112)
constexpr int kStreamFrags = 8;       // the streamed attention's chunk: 64 keys
constexpr int kStreamKeys = 8 * kStreamFrags;
constexpr int kQBlock = 16 * kWarps;  // query rows of a streamed attention block
constexpr int kDimChunk = 64;         // head dims a streamed attention stages
constexpr int kCqTileMax = 128;       // widest tile of a tiled CQ product

// attention routes of the f64 path (SmemLayout)
constexpr int kResident = 0, kGrouped = 1, kStreamed = 2;

// Per-sample workspace: kBuffers buffers of Lm x D (Lm = max(T, W)), the
// CQ attention's 4 matrices of Lm x Lm, 5 small vectors, the two masks
// (used when they do not fit in shared memory) and the partial sums of a
// product split over k (Lm x max(Lm, D)).  Buffers whose lifetimes do not
// overlap share one (see the kernel).
constexpr int kBuffers = 13;

__host__ __device__ constexpr long lmax(long a, long b) { return a > b ? a : b; }

// Dynamic shared memory of the f64 path, in floats: the stage region (the
// two stages of a staged product, each an A slab of up to one pass's rows,
// then a B slab), then the masks.  Attention takes the first of three
// routes that fits in kSmemLimit:
// - kResident: q, k and v of every head in the region, then the score tiles
//   of `heads` heads (Lm rows each) after it;
// - kGrouped: q, k and v of `heads` heads at a time, their scores right
//   after them, all in the region (which grows to hold them);
// - kStreamed: one head's scores in the workspace (the CQ attention's
//   matrices, free then), its products staged as the dense layers' are.
// Q and K rows are w+4 floats apart, V rows w+8 (w the staged columns),
// score rows lm_pad+4: conflict-free fragment loads.  `heads` is the
// largest divisor of H that fits.  The masks go to the workspace when even
// the stages leave no room for them.
struct SmemLayout {
  long region, head_floats;
  int a_floats, b_floats, score_ld, heads, attn, masks;
  bool masks_smem;
  __host__ __device__ SmemLayout(int T, int W, int D, int H) {
    const int lm = T > W ? T : W, hd = D / H;
    const int lm_pad = (lm + kTile - 1) / kTile * kTile;
    a_floats = (lm_pad < kTile * kWarps ? lm_pad : kTile * kWarps) * kSlabLd;
    const int row_major = kSlab * (kMaxPassN + 8), nt = kMaxPassN * kSlabLd;
    b_floats = row_major > nt ? row_major : nt;
    const long stages = 2L * (a_floats + b_floats), limit = kSmemLimit / 4;
    score_ld = lm_pad + 4;
    head_floats = static_cast<long>(lm) * score_ld;
    masks = T + W;
    masks_smem = true;
    attn = kResident;
    region = lmax(stages, static_cast<long>(lm) * (3 * D + 16));
    for (heads = H; heads >= 1; --heads)
      if (H % heads == 0 && floats() <= limit) return;
    attn = kGrouped;
    for (heads = H; heads >= 1; --heads) {
      if (H % heads) continue;
      region = lmax(stages, static_cast<long>(lm) * (3 * heads * hd + 16) +
                                heads * head_floats);
      if (floats() <= limit) return;
    }
    attn = kStreamed;
    heads = 1;
    region = stages;
    masks_smem = floats() <= limit;
  }
  __host__ __device__ long floats() const {
    return region + (attn == kResident ? heads * head_floats : 0) +
           (masks_smem ? masks : 0);
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

// A bf16 value (its bits) as an f32.
__device__ __forceinline__ float bf16f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
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

// -- PTX of the bf16 path: ldmatrix, wgmma, mbarriers, bulk copies ----------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 matrices of 16-bit values from shared memory: lane l gives the
// address of row l%8 of matrix l/8 (16 bytes); r[i] gets, of matrix i, row
// l/4, columns 2(l%4) and 2(l%4)+1 (the lower column in the low half), or
// with .trans row 2(l%4) and 2(l%4)+1 of column l/4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// A wgmma operand descriptor: K-major, no swizzle (core matrices of 8 rows
// x 16 bytes, 128 contiguous bytes each); lbo: bytes between core matrices
// adjacent in K, sbo: between core matrices adjacent in M or N.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy writes of shared memory made visible to wgmma and bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits until the phase of `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from device
// to shared memory; the copy arrives on `bar`, which expects the bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// d (+)= a . b over one k16 step of a 64 x 64 tile: a and b by descriptor
// from shared memory (K-major), f32 sums; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= a . b over one k16 step of a 64 x 128 tile: a and b by descriptor
// from shared memory (K-major), f32 sums; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }

// Rows of a bf16 product's A image: mma.sync tiles of 16 up to kSyncRows
// rows, wgmma tiles of 64 above.
__host__ __device__ constexpr int bf16_rows(int M) {
  return M <= kSyncRows ? up16(M) : (M + 63) / 64 * 64;
}

// Bytes of a streamed attention's images (attention_bf16_streamed): a
// block of query rows, a chunk of keys and of values, up to kDimChunk head
// dims each.
__host__ __device__ constexpr long streamed_attention_bytes(int hd) {
  return 2L * (kQBlock + 2 * kStreamKeys) *
         ((up16(hd) < kDimChunk ? up16(hd) : kDimChunk) + 8);
}

// Dynamic shared memory of the bf16 path, in bytes: the image region, the
// ring of weight slabs, its mbarriers and the two masks.  The region holds
// a dense's A image (a row pass of up to kRowPass rows, a chunk of up to
// kChunkSlabs slabs), a product of two activations' A and B images
// (resident, or with cq_tile > 0 tiles of cq_tile rows, columns and k),
// or an attention's q, k and v images (`heads` heads at a time; every
// attention over more than kKeyChunk keys, or all of them when no head
// fits, streams its images).  Each takes its resident form where that fits
// beside the ring and the masks; the masks go to the workspace when even
// the smallest forms leave no room for them.
struct Bf16Layout {
  long ring, bars, masks, bytes;
  int qkv_rows;  // rows of a head's q, k or v image
  int heads, cq_tile;
  bool masks_smem;
  __host__ __device__ Bf16Layout(int T, int W, int D, int H) {
    const int lm = imax(T, W), hd = D / H;
    const long fixed = 2L * kRing * kSlotValues + 8L * kRing, mask = 4L * (T + W);
    // the widest chunk: a bilinear's two D-deep leaves, the CQ denses' two
    // 2D-deep halves
    const int kdense = 2 * up16(2 * D);
    const long dense = 2L * bf16_rows(lm < kRowPass ? lm : kRowPass) *
                       (kdense < kChunkSlabs * kKSlab ? kdense : kChunkSlabs * kKSlab);
    const long stream = streamed_attention_bytes(hd);
    const long least = lmax(lmax(dense, lm > kKeyChunk ? stream : 0), 4L * 16 * 16);
    masks_smem = fixed + (least + 127) / 128 * 128 + mask <= kSmemLimit;
    const long budget = (kSmemLimit - fixed - (masks_smem ? mask : 0)) / 128 * 128;
    const int kact = up16(imax(lm, D));
    long act = 2L * bf16_rows(lm) * kact + 2L * kact * kact;
    cq_tile = 0;
    if (act > budget) {
      for (cq_tile = kCqTileMax; cq_tile > 16 && 4L * cq_tile * cq_tile > budget;)
        cq_tile -= 16;
      act = 4L * cq_tile * cq_tile;
    }
    qkv_rows = up16(lm);
    const long head = 2L * 3 * qkv_rows * (up16(hd) + 8);
    for (heads = H; heads >= 1; --heads)
      if (H % heads == 0 && heads * head <= budget) break;
    const long attn = lmax(heads * head, lm > kKeyChunk || heads == 0 ? stream : 0);
    const long region = lmax(lmax(dense, act), attn);
    ring = (region + 127) / 128 * 128;
    bars = ring + 2L * kRing * kSlotValues;
    masks = bars + 8L * kRing;
    bytes = masks + (masks_smem ? mask : 0);
  }
};

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
  int lds, heads;    // (the bf16 path: heads whose images fit, 0 for none)
  int attn;          // the f64 path's attention route (SmemLayout)
  int cq_tile;       // the bf16 path's CQ product tile, 0 for resident
  float* ws;         // the sample's workspace: buffers of ld floats
  long ld;
  float* part;       // partial sums of a product split over k (workspace)
  // the bf16 path
  uint16_t* img;          // the image region (Bf16Layout)
  uint16_t* ring;         // kRing slots of kSlotValues
  uint64_t* full;         // per slot: its slab has landed
  const uint16_t* wbf;    // the bf16 companion of the packed weights
  const int* sched;       // the ring's slabs in order: byte offset, bytes
  int nsched, qkv_rows, match_bf, label_bf;
  mutable int slab;       // the next slab this thread consumes
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
// of f32; each fragment is converted to f64 in the k-loop, products and
// sums in f64 (DMMA).  Ends with the block synchronised after its last
// read of shared memory.
template <bool kBNT, class Epi>
__device__ __noinline__ void gemm_f64(int M, int N, int K, Mat a, Mat b,
                                      const float* bias, const float* res,
                                      const Ctx& x, Epi epi_arg) {
  using Acc = double;
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


// A dense layer of narrow N (the matching head, the (D,1) denses): one
// thread per output on the CUDA cores, f64 sums in order over k; with
// kRound the activations are rounded to bf16 first and w holds bf16 values
// (the companion's copy of the weight).
template <bool kRound, class Epi>
__device__ __noinline__ void narrow_dense(
    const float* in, int M, int K, int N,
    const std::conditional_t<kRound, uint16_t, float>* w, Epi epi) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    const float* xr = in + static_cast<long>(m) * K;
    double acc = 0.0;
    for (int k = 0; k < K; ++k) {
      const float a = kRound ? round_bf16(xr[k]) : xr[k];
      float b;
      if constexpr (kRound)
        b = bf16f(w[k * N + n]);
      else
        b = w[k * N + n];
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

// LayerNorm (layer_norm) at any other D than one float4 a lane, in the
// general kernel: one warp per row, the row in chunks of 32 columns, one a
// lane, read from L1 three times (mean, variance, output).
__device__ __noinline__ void layer_norm_chunks(const float* __restrict__ x,
                                               float* __restrict__ y, int ldy, int L,
                                               int D, LN p) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int row = warp; row < L; row += kWarps) {
    const float* xr = x + static_cast<long>(row) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += kWarp) s += xr[d];
    const float mean = warp_sum(s) / D;
    float var = 0.0f;
    for (int d = lane; d < D; d += kWarp) {
      const float c = xr[d] - mean;
      var += c * c;
    }
    const float inv = rsqrtf(warp_sum(var) / D + 1e-6f);
    float* yr = y + static_cast<long>(row) * ldy;
    for (int d = lane; d < D; d += kWarp)
      yr[d] = (xr[d] - mean) * inv * p.scale[d] + p.bias[d];
  }
}

// LayerNorm at any D: layer_norm where a float4 a lane holds a row,
// layer_norm_chunks elsewhere (the general kernel only).
template <bool kGen>
__device__ __forceinline__ void ln(const float* x, float* y, int ldy, int L, int D, LN p) {
  if (kGen && (D > 4 * kWarp || D % 4 != 0))
    layer_norm_chunks(x, y, ldy, L, D, p);
  else
    layer_norm(x, y, ldy, L, D, p);
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

// -- the bf16 path's products -------------------------------------------------
// Images.  Every bf16 operand in shared memory is K-major in core matrices
// of 8 rows x 8 values (128 contiguous bytes, no swizzle): for an image kw
// values wide, core matrix (r/8, c/8) starts at value ((r/8) * (kw/8) +
// c/8) * 64 and row r%8 of it 8 values further on.  That is the canonical
// layout a wgmma descriptor names with layout type 0 (LBO 128 bytes between
// core matrices along K, SBO kw * 16 bytes between 8-row groups), and each
// core matrix is one 8x8 matrix of ldmatrix, free of bank conflicts.

// Rounds rows [0, M) of the f32 matrix `in` (row stride lda) into an image
// kw = up16(k0) + up16(k1) values wide: image columns [0, k0) from
// in[:, 0:k0], [up16(k0), up16(k0) + k1) from in[:, k0:k0 + k1], zeros in
// the rest of those rows.  Rows past M are left as they are: they only
// reach outputs that are never stored.  Thread e writes bytes [16e, 16e+16).
__device__ __noinline__ void stage_image(uint16_t* img, const float* in, int lda,
                                         int M, int k0, int k1) {
  constexpr int kBatch = 4;  // chunks a thread loads before it stores
  const int s0 = up16(k0), chunks = (s0 + up16(k1)) / 8;
  const int total = (M + 7) / 8 * chunks * 8;
  const bool vec = rows_aligned(in, lda, k0) && k1 % 4 == 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    float4 a[kBatch], b[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      const int r = (e >> 3) / chunks * 8 + (e & 7), c = ((e >> 3) % chunks) * 8;
      a[i] = b[i] = zero;
      if (e >= total || r >= M) continue;
      const bool first = c < s0;
      const int col = first ? c : k0 + c - s0;      // the chunk's source column
      const int n = first ? k0 - c : k1 - (c - s0);  // its values in the matrix
      const float* src = in + static_cast<long>(r) * lda + col;
      if (vec) {
        if (n > 0) a[i] = ld4(src);
        if (n > 4) b[i] = ld4(src + 4);
      } else {
        a[i] = make_float4(n > 0 ? src[0] : 0.0f, n > 1 ? src[1] : 0.0f,
                           n > 2 ? src[2] : 0.0f, n > 3 ? src[3] : 0.0f);
        b[i] = make_float4(n > 4 ? src[4] : 0.0f, n > 5 ? src[5] : 0.0f,
                           n > 6 ? src[6] : 0.0f, n > 7 ? src[7] : 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      if (e >= total || (e >> 3) / chunks * 8 + (e & 7) >= M) continue;
      *reinterpret_cast<uint4*>(img + 8L * e) =
          make_uint4(bf16x2(a[i].x, a[i].y), bf16x2(a[i].z, a[i].w),
                     bf16x2(b[i].x, b[i].y), bf16x2(b[i].z, b[i].w));
    }
  }
}

// The same for the transpose of a row-major K x N matrix: image row n <
// N holds src[k * ld + n] for k < K, zeros to up16(K).
__device__ __noinline__ void stage_image_t(uint16_t* img, const float* src, int ld,
                                           int N, int K) {
  constexpr int kBatch = 2;
  const int chunks = up16(K) / 8, total = (N + 7) / 8 * chunks * 8;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      const int n = (e >> 3) / chunks * 8 + (e & 7), c = ((e >> 3) % chunks) * 8;
      const bool live = e < total && n < N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = live && c + j < K ? src[static_cast<long>(c + j) * ld + n] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      if (e >= total || (e >> 3) / chunks * 8 + (e & 7) >= N) continue;
      *reinterpret_cast<uint4*>(img + 8L * e) =
          make_uint4(bf16x2(v[i][0], v[i][1]), bf16x2(v[i][2], v[i][3]),
                     bf16x2(v[i][4], v[i][5]), bf16x2(v[i][6], v[i][7]));
    }
  }
}

// The weight ring.  The products that read a packed weight walk the bf16
// companion's slabs (kKSlab values of k of one leaf, its N rows, an image
// of its own) in the order x.sched lists them, which is the order of the
// products: slab s lands in slot s % kRing, announced by full[slot] in
// phase s / kRing.  A product waits for all its slabs (at most kRing),
// runs its products on them in one batch, and once the block is past them
// thread 0 refills their slots with the slabs kRing further on: the next
// products' weights are in flight while this one and the stages between
// run.  Nothing divergent runs between a product's wgmma instructions.
__device__ __forceinline__ const uint16_t* ring_slot(const Ctx& x, int s) {
  return x.ring + (s % kRing) * kSlotValues;
}

__device__ __forceinline__ void ring_wait(const Ctx& x, int s) {
  mbar_wait(x.full + s % kRing, (s / kRing) & 1);
}

// After a barrier past every read of slabs [s0, s0 + n): their slots take
// slabs s0 + kRing, ... (thread 0 issues the bulk copies).
__device__ __forceinline__ void ring_refill(const Ctx& x, int s0, int n) {
  if (threadIdx.x == 0)
    for (int s = s0 + kRing; s < s0 + kRing + n && s < x.nsched; ++s)
      bulk_copy(x.ring + (s % kRing) * kSlotValues,
                reinterpret_cast<const char*>(x.wbf) + x.sched[2 * s],
                x.sched[2 * s + 1], x.full + s % kRing);
}

__device__ __forceinline__ void hmma4(float& d0, float& d1, float& d2, float& d3,
                                      const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bias values (and a split product's partial sums, before them) an
// output adds to its sum: bias[n] alone where there is no part, so that an
// unsplit product adds exactly what it did before products were split.
__device__ __forceinline__ float addend(const float* bias, const float* part, int m,
                                        int n, int N) {
  const float b = bias != nullptr ? bias[n] : 0.0f;
  return part != nullptr ? part[static_cast<long>(m) * N + n] + b : b;
}

// The bf16 products on mma.sync: epi(m, n, sum [+ part[m, n] + bias[n]],
// res[m, n] or 0) for m in [r0, r0 + mn), n in [c0, c0 + nn), both below M
// and N (res and part have rows of N), of C = A . B^T summed over `ns`
// slabs: the A image holds rows [r0, r0 + mn), slab(i, b, kw, ka) gives
// slab i's B image b (columns [c0, c0 + nn), kw values wide, a multiple of
// 16) and its columns [ka, ka + kw) of the A image (a_kw values wide).
// Every slab is in shared memory: the warps take 16 x 16 jobs in turn, each
// summed over all slabs with fragments from ldmatrix and stored at once
// (its bias values and residuals loaded before its first store).
template <class SlabFn, class Epi>
__device__ __forceinline__ void sync_products(const uint16_t* A, int a_kw, int ns,
                                              SlabFn slab, int r0, int mn, int M,
                                              int c0, int nn, int N,
                                              const float* bias, const float* res,
                                              const float* part, Epi epi) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (nn + 15) / 16, jobs = (mn + 15) / 16 * nt;
  for (int job = warp; job < jobs; job += kWarps) {
    const int m0 = job / nt * 16, n0 = job % nt * 16;
    float acc[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] = 0.0f;
    // lane l addresses row l%8 of matrix l/8: A's are (rows 0-7, k 0-7),
    // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); B's (n 0-7, k 0-7), (0-7,
    // 8-15), (8-15, 0-7), (8-15, 8-15)
    const int ar = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int br = n0 + (lane & 7) + 8 * (lane >> 4);
    for (int i = 0; i < ns; ++i) {
      const uint16_t* b;
      int kw, ka;
      slab(i, b, kw, ka);
      const int ac = ka + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
      const uint16_t* ap = A + ((ar >> 3) * (a_kw >> 3) + (ac >> 3)) * 64 + (ar & 7) * 8;
      const uint16_t* bp = b + ((br >> 3) * (kw >> 3) + (bc >> 3)) * 64 + (br & 7) * 8;
      for (int kk = 0; kk < kw / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldsm_x4(fa, ap + kk * 128);
        ldsm_x4(fb, bp + kk * 128);
        hmma4(acc[0], acc[1], acc[2], acc[3], fa, fb[0], fb[1]);
        hmma4(acc[4], acc[5], acc[6], acc[7], fa, fb[2], fb[3]);
      }
    }
    // acc[4f + 2h + q]: row r0 + m0 + g + 8h, column c0 + n0 + 8f + 2t + q
    float bv[8], rv[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int m = r0 + m0 + g + 8 * ((v >> 1) & 1),
                n = c0 + n0 + 8 * (v >> 2) + 2 * t + (v & 1);
      const bool ok = m < M && n < N;
      bv[v] = ok ? addend(bias, part, m, n, N) : 0.0f;
      rv[v] = res != nullptr && ok ? res[static_cast<long>(m) * N + n] : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int m = r0 + m0 + g + 8 * ((v >> 1) & 1),
                n = c0 + n0 + 8 * (v >> 2) + 2 * t + (v & 1);
      if (m >= M || n >= N) continue;
      float r = acc[v];
      if (bias != nullptr || part != nullptr) r = r + bv[v];
      epi(m, n, r, rv[v]);
    }
  }
}

// The wgmma products of a dense layer whose kSlabs slabs (from slab s0 of
// the ring) are each kKSlab deep: A is the image of kSlabs * kKSlab values
// of k.  kRows 64: warpgroup w takes the 64 x 64 tile of columns [64w,
// 64w + 64) (m64n64k16); kRows 128: rows [64w, 64w + 64), all 128 columns
// (m64n128k16).  The instructions are issued in one straight run (no
// branch between them), committed and waited for once; then the
// epilogue, 16 outputs at a time (their bias values and residuals loaded
// first).  A warpgroup whose columns lie past N computes them all the same
// and stores none.  The image holds rows [r0, r0 + kRows) and the slots
// columns [c0, c0 + kRingRows) of the output; thread 0 refills the slots
// when `refill` (the last row pass over them).
template <int kRows, int kSlabs, class Epi>
__device__ __forceinline__ void wgmma_products(const Ctx& x, int s0, int r0, int M,
                                               int c0, int N, const float* bias,
                                               const float* res, const float* part,
                                               bool refill, Epi epi) {
  constexpr int kN = kRows == 64 ? 32 : 64, kAkw = kSlabs * kKSlab;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3, wg = warp / 4;
  const int m0 = kRows == 64 ? 0 : 64 * wg, n0 = kRows == 64 ? 64 * wg : 0;
  const uint64_t da = wgmma_desc(x.img + (m0 >> 3) * (kAkw >> 3) * 64, 128, kAkw * 16);
  uint64_t db[kSlabs];
#pragma unroll
  for (int i = 0; i < kSlabs; ++i)
    db[i] = wgmma_desc(ring_slot(x, s0 + i) + (n0 >> 3) * (kKSlab >> 3) * 64, 128,
                       kKSlab * 16);
  float acc[kN];
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kSlabs; ++i)
#pragma unroll
    for (int kk = 0; kk < kKSlab / 16; ++kk) {  // + 256 bytes: 16 in the address field
      const uint64_t a = da + 16 * (kKSlab / 16 * i + kk), b = db[i] + 16 * kk;
      if constexpr (kRows == 64)
        wgmma_m64n64k16(acc, a, b, i + kk > 0);
      else
        wgmma_m64n128k16(acc, a, b, i + kk > 0);
    }
  wgmma_commit();
  wgmma_wait();
  reg_fence(acc);
  __syncthreads();  // the A image and the slots are free
  if (refill) ring_refill(x, s0, kSlabs);
  // acc[4j + 2h + q]: row r0 + m0 + 16 (warp % 4) + g + 8h, column c0 + n0 +
  // 8j + 2t + q
#pragma unroll
  for (int c = 0; c < kN; c += 16) {
    float bv[16], rv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = c + i;
      const int m = r0 + m0 + 16 * (warp % 4) + g + 8 * ((v >> 1) & 1);
      const int n = c0 + n0 + 8 * (v >> 2) + 2 * t + (v & 1);
      const bool ok = m < M && n < N;
      bv[i] = ok ? addend(bias, part, m, n, N) : 0.0f;
      rv[i] = res != nullptr && ok ? res[static_cast<long>(m) * N + n] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = c + i;
      const int m = r0 + m0 + 16 * (warp % 4) + g + 8 * ((v >> 1) & 1);
      const int n = c0 + n0 + 8 * (v >> 2) + 2 * t + (v & 1);
      if (m >= M || n >= N) continue;
      float r = acc[v];
      if (bias != nullptr || part != nullptr) r = r + bv[i];
      epi(m, n, r, rv[i]);
    }
  }
}

// The tiled route of a bf16 dense (dense_bf16): `in` (M x K) @ W + bias
// into x.part (M x N), W's slabs from the ring as the pack's schedule lists
// them.  The product runs in
// - chunks of up to kChunkSlabs consecutive slabs (K <= 256 a chunk), each
//   with its own A image, every chunk after the first adding the sums the
//   one before left in x.part (the split-K route);
// - column passes of up to kRingRows outputs, a ring slot's rows, each
//   waiting for the chunk's slabs cut to its columns (the schedule lists
//   them chunk by chunk, pass by pass);
// - row passes of up to kRowPass rows: past that, each pass rounds its own
//   rows into the A image, under the same slabs.
// One instantiation serves every dense (its epilogue only stores), so the
// build does not grow with the epilogues and no epilogue's registers sit
// beside the loops'.  Ends with the block synchronised after its last
// store to x.part.
// The tiled route of a bf16 dense (dense_bf16): `in` (M x K) @ W + bias
// into x.part (M x N), W's slabs from the ring as the pack's schedule lists
// them.  The product runs in
// - chunks of up to kChunkSlabs consecutive slabs (K <= 256 a chunk), each
//   with its own A image, every chunk after the first adding the sums the
//   one before left in x.part (the split-K route);
// - column passes of up to kRingRows outputs, a ring slot's rows, each
//   waiting for the chunk's slabs cut to its columns (the schedule lists
//   them chunk by chunk, pass by pass);
// - row passes of up to kRowPass rows: past that, each pass rounds its own
//   rows into the A image, under the same slabs.
// tiled_pass runs pass `it` of them (chunk-major, then column, then row),
// everything derived from the counter, so that its caller holds little
// across the call; one instantiation serves every dense (it only stores).
// Ends with the block synchronised after its last read of shared memory;
// a wgmma pass stores after that barrier (the caller syncs before reading).
__device__ __forceinline__ int tiled_passes(int M, int K, int N, int seg) {
  const int slabs = (up16(seg) + kKSlab - 1) / kKSlab +
                    (up16(K - seg) + kKSlab - 1) / kKSlab;
  return (slabs + kChunkSlabs - 1) / kChunkSlabs * ((N + kRingRows - 1) / kRingRows) *
         ((M + kRowPass - 1) / kRowPass);
}

__device__ __noinline__ void tiled_pass(const float* in, int lda, int M, int K, int N,
                                        const float* bias, int seg, int it,
                                        const Ctx& x) {
  const int k1 = K - seg, kp0 = up16(seg), kp1 = up16(k1);
  const int n0s = (kp0 + kKSlab - 1) / kKSlab, n1s = (kp1 + kKSlab - 1) / kKSlab;
  const int slabs = n0s + n1s, chunks = (slabs + kChunkSlabs - 1) / kChunkSlabs;
  const int passes_n = (N + kRingRows - 1) / kRingRows;
  const int passes_m = (M + kRowPass - 1) / kRowPass;
  const int pm = it % passes_m, pn = it / passes_m % passes_n, ch = it / passes_m / passes_n;
  const int c0 = ch * kChunkSlabs, ns = min(kChunkSlabs, slabs - c0);
  // the chunk's columns of `in`: slabs of the first segment from column
  // c0 * kKSlab (w0 values), then the second segment's from its start
  // (w1), or the second segment's alone from column b1 of it
  int src, w0, w1;
  if (c0 < n0s) {
    src = c0 * kKSlab;
    w0 = min(seg, (c0 + ns) * kKSlab) - src;
    w1 = c0 + ns > n0s ? min(k1, (c0 + ns - n0s) * kKSlab) : 0;
  } else {
    const int b1 = (c0 - n0s) * kKSlab;
    src = seg + b1;
    w0 = min(k1, (c0 + ns - n0s) * kKSlab) - b1;
    w1 = 0;
  }
  // the first row pass of a column pass takes its slabs from the ring
  int s0 = x.slab;
  if (pm == 0) {
    x.slab = s0 + ns;
    for (int i = 0; i < ns; ++i) ring_wait(x, s0 + i);
    __syncwarp();
  } else {
    s0 -= ns;
  }
  float* const part = x.part;
  const float* bias_c = ch == chunks - 1 ? bias : nullptr;
  const float* part_in = ch > 0 ? part : nullptr;
  const int r0 = pm * kRowPass, c0n = pn * kRingRows;
  const int mn = min(kRowPass, M - r0), a_kw = up16(w0) + up16(w1);
  const bool refill = pm == passes_m - 1;
  auto ep = [=](int m, int n, float v, float) { part[static_cast<long>(m) * N + n] = v; };
  stage_image(x.img, in + static_cast<long>(r0) * lda + src, lda, mn, w0, w1);
  fence_proxy_async();
  __syncthreads();
  const bool whole = a_kw == ns * kKSlab && mn > kSyncRows;
  const int shape = whole ? (mn > 64 ? 8 : 0) + ns : 0;
  switch (shape) {
#define HUAL_WGMMA(R, S)                                                         \
  wgmma_products<R, S>(x, s0, r0, M, c0n, N, bias_c, nullptr, part_in, refill, ep); \
  return;
    case 1: HUAL_WGMMA(64, 1)
    case 2: HUAL_WGMMA(64, 2)
    case 4: HUAL_WGMMA(64, 4)
    case 9: HUAL_WGMMA(128, 1)
    case 10: HUAL_WGMMA(128, 2)
    case 12: HUAL_WGMMA(128, 4)
#undef HUAL_WGMMA
    default: break;
  }
  // slab i: the first segment's, then the second's
  sync_products(x.img, a_kw, ns, [&](int i, const uint16_t*& b, int& kw, int& ka) {
    const int j = c0 + i;
    if (j < n0s) {
      kw = min(kKSlab, kp0 - j * kKSlab);
      ka = (j - c0) * kKSlab;
    } else {
      const int j1 = j - n0s, first = c0 > n0s ? c0 - n0s : 0;
      kw = min(kKSlab, kp1 - j1 * kKSlab);
      ka = up16(w0) * (c0 < n0s) + (j1 - first) * kKSlab;
    }
    b = ring_slot(x, s0 + i);
  }, r0, mn, M, c0n, min(kRingRows, N - c0n), N, bias_c, nullptr, part_in, ep);
  __syncthreads();  // the A image and the slots are free
  if (refill) ring_refill(x, s0, ns);
}

// epi(m, n, x.part[m, n], res[m, n] or 0) for the M x N sums a tiled route
// left in x.part; out of line, so that the products' functions keep their
// resident code as it was.
template <class Epi>
__device__ __noinline__ void apply_sums(int M, int N, const float* res, const Ctx& x,
                                        Epi epi) {
  const float* part = x.part;
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N;
    epi(m, e - m * N, part[e], res != nullptr ? res[e] : 0.0f);
  }
}

// A dense layer on the bf16 path: epi(m, n, in[m, :] @ W[:, n] + bias[n],
// res[m, n] or 0), `in` (M x K, rows lda floats apart) rounded into the A
// image, W from the ring: one leaf or leaf part (K x N), or with seg < K
// two (seg x N, then (K - seg) x N: a bilinear's [d1; d2], or the CQ
// attentions' (4D x D) denses as their halves), each padded to 16 values
// of k and cut into slabs of kKSlab.  At most kChunkSlabs slabs (K <= 256),
// N <= kRingRows and M <= kRowPass (every product at D <= 128, T <= 128
// but the CQ denses at D=128) it is one product on slabs that are all in
// the ring at once; past that the general kernel tiles it (dense(): the
// passes of tiled_pass, then apply_sums).  `staged`: the A image already holds these
// rows (the previous product read the same input).  Products of more than
// kSyncRows rows whose leaves are whole slabs deep (D a multiple of 64) run
// on wgmma, the rest on mma.sync.  Ends with the block synchronised after
// its last read of shared memory.
template <class Epi>
__device__ __noinline__ void dense_bf16(const float* in, int lda, int M, int K,
                                        int N, const float* bias, const float* res,
                                        int seg, bool staged, const Ctx& x,
                                        Epi epi) {
  const int k1 = K - seg, kp0 = up16(seg), kp1 = up16(k1), a_kw = kp0 + kp1;
  const int n0 = (kp0 + kKSlab - 1) / kKSlab, n1 = (kp1 + kKSlab - 1) / kKSlab;
  const int ns = n0 + n1;
  const int s0 = x.slab;
  x.slab = s0 + ns;
  if (!staged) {
    stage_image(x.img, in, lda, M, seg, k1);
    fence_proxy_async();
    __syncthreads();
  }
  for (int i = 0; i < ns; ++i) ring_wait(x, s0 + i);
  __syncwarp();
  const bool whole = kp0 % kKSlab == 0 && kp1 % kKSlab == 0 && M > kSyncRows;
  const int shape = whole ? (M > 64 ? 8 : 0) + ns : 0;
  switch (shape) {
#define HUAL_WGMMA(R, S)                                                          \
  wgmma_products<R, S>(x, s0, 0, M, 0, N, bias, res, nullptr, true, epi); \
  return;
    case 1: HUAL_WGMMA(64, 1)
    case 2: HUAL_WGMMA(64, 2)
    case 4: HUAL_WGMMA(64, 4)
    case 9: HUAL_WGMMA(128, 1)
    case 10: HUAL_WGMMA(128, 2)
    case 12: HUAL_WGMMA(128, 4)
#undef HUAL_WGMMA
    default: break;
  }
  // slab i: the first leaf's, then the second's
  sync_products(x.img, a_kw, ns, [&](int i, const uint16_t*& b, int& kw, int& ka) {
    const int k0 = (i < n0 ? i : i - n0) * kKSlab;
    kw = min(kKSlab, (i < n0 ? kp0 : kp1) - k0);
    ka = (i < n0 ? 0 : kp0) + k0;
    b = ring_slot(x, s0 + i);
  }, 0, M, M, 0, N, N, bias, res, nullptr, epi);
  __syncthreads();  // the A image and the slots are free
  ring_refill(x, s0, ns);
}

// The tiled route of a product of two activations (gemm_bf16): the sums
// into x.part (M x N), in tiles of x.cq_tile rows and columns, k in chunks
// of cq_tile, each chunk's images staged in turn and every chunk after the
// first adding the sums the one before left.  Ends with the block
// synchronised after its last store to x.part.
template <bool kBNT>
__device__ __noinline__ void gemm_bf16_tiled(int M, int N, int K, Mat a, Mat b,
                                             const Ctx& x) {
  const int tile = x.cq_tile;
  float* const part = x.part;
  uint16_t* bimg = x.img + tile * tile;
  for (int r0 = 0; r0 < M; r0 += tile)
    for (int c0 = 0; c0 < N; c0 += tile)
      for (int k0 = 0; k0 < K; k0 += tile) {
        const int mn = min(tile, M - r0), nn = min(tile, N - c0), kk = min(tile, K - k0);
        const int kp = up16(kk);
        stage_image(x.img, a.p + static_cast<long>(r0) * a.ld + k0, a.ld, mn, kk, 0);
        if (kBNT)
          stage_image(bimg, b.p + static_cast<long>(c0) * b.ld + k0, b.ld, nn, kk, 0);
        else
          stage_image_t(bimg, b.p + static_cast<long>(k0) * b.ld + c0, b.ld, nn, kk);
        __syncthreads();
        sync_products(x.img, kp, 1, [&](int, const uint16_t*& bp, int& kw, int& ka) {
          bp = bimg;
          kw = kp;
          ka = 0;
        }, r0, mn, M, c0, nn, N, nullptr, nullptr, k0 > 0 ? part : nullptr,
           [=](int m, int n, float v, float) { part[static_cast<long>(m) * N + n] = v; });
        __syncthreads();  // the images are free
      }
}

// A product of two activations on the bf16 path (the CQ attention's):
// epi(m, n, sum_k A[m, k] * B[k, n], 0), A row-major M x K, B row-major
// K x N or with kBNT stored N x K, both rounded into images; on mma.sync.
// Resident (x.cq_tile 0): one image each; tiled: gemm_bf16_tiled, then the
// epilogue reads the sums back.  Ends with the block synchronised after its
// last read of shared memory.
template <bool kBNT, bool kGen, class Epi>
__device__ __noinline__ void gemm_bf16(int M, int N, int K, Mat a, Mat b,
                                       const Ctx& x, Epi epi) {
  if (kGen && x.cq_tile > 0) {
    gemm_bf16_tiled<kBNT>(M, N, K, a, b, x);
    apply_sums(M, N, nullptr, x, epi);
    return;
  }
  const int kp = up16(K);
  uint16_t* bimg = x.img + static_cast<long>(bf16_rows(M)) * kp;
  stage_image(x.img, a.p, a.ld, M, K, 0);
  if (kBNT)
    stage_image(bimg, b.p, b.ld, N, K, 0);
  else
    stage_image_t(bimg, b.p, b.ld, N, K);
  __syncthreads();
  sync_products(x.img, kp, 1, [&](int, const uint16_t*& bp, int& kw, int& ka) {
    bp = bimg;
    kw = kp;
    ka = 0;
  }, 0, M, M, 0, N, N, nullptr, nullptr, nullptr,
     [&](int m, int n, float v, float) { epi(m, n, v, 0.0f); });
  __syncthreads();  // the images are free
}

// A dense layer: epi(m, n, x[m, :] @ d.w[:, n] + d.b[n], res[m, n] or 0);
// x is (M, K) row-major with rows lda floats apart, d.w (K, N), d.b (N,)
// or null, res (M, N) or null.  The bf16 path reads the weight from the
// ring (see dense_bf16 for seg and staged).
template <bool kBf16, bool kGen, class Epi>
__device__ void dense(const float* in, int lda, int M, int K, int N, Dense d,
                      const Ctx& x, Epi epi, const float* res = nullptr,
                      int seg = 0, bool staged = false) {
  if constexpr (kBf16) {
    seg = seg > 0 ? seg : K;
    const int slabs = (up16(seg) + kKSlab - 1) / kKSlab + (up16(K - seg) + kKSlab - 1) / kKSlab;
    if (kGen && (slabs > kChunkSlabs || N > kRingRows || M > kRowPass)) {
      // the tiled route, called from the stage itself: one call level less
      // between the stage and the products
      for (int it = 0, n = tiled_passes(M, K, N, seg); it < n; ++it)
        tiled_pass(in, lda, M, K, N, d.b, seg, it, x);
      __syncthreads();  // the sums are in x.part (wgmma stores after its barrier)
      apply_sums(M, N, res, x, epi);
    } else {
      dense_bf16(in, lda, M, K, N, d.b, res, seg, staged, x, epi);
    }
  }
  else
    gemm_f64<false>(M, N, K, Mat{in, lda}, Mat{d.w, N}, d.b, res, x, epi);
}

// A product of two activations (see gemm_f64 and gemm_bf16).
template <bool kBNT, bool kBf16, bool kGen, class Epi>
__device__ void gemm(int M, int N, int K, Mat a, Mat b, const float* bias,
                     const float* res, const Ctx& x, Epi epi) {
  if constexpr (kBf16)
    gemm_bf16<kBNT, kGen>(M, N, K, a, b, x, epi);
  else
    gemm_f64<kBNT>(M, N, K, a, b, bias, res, x, epi);
}

// The depthwise taps of conv_block one channel a thread, for D not a
// multiple of 4 (rows not 16-byte aligned); out of line.
__device__ __noinline__ void depthwise_scalar(const float* h, const float* f, float* acc,
                                              int L, int D) {
  for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
    const int t = e / D, c = e - t * D;
    float a = 0.0f;
    for (int k = 0; k < kConvK; ++k) {
      const int s = t + k - kConvK / 2;
      if (s >= 0 && s < L) a += h[s * D + c] * f[k * D + c];
    }
    acc[e] = a;
  }
}

// x (L x D) in place: kConvLayers x {LN -> depthwise k=7 SAME, zero padding
// at both ends of L, mask ignored -> pointwise + bias -> relu -> + residual}.
template <bool kBf16, bool kGen>
__device__ __noinline__ void conv_block(float* xs, int L, const Ctx& x, const ConvBlockW& w,
                           float* h, float* acc) {
  const int D = x.D;
  for (int i = 0; i < kConvLayers; ++i) {
    ln<kGen>(xs, h, D, L, D, w.ln[i]);
    __syncthreads();
    const float* f = w.dw[i];
    const int nq = D / 4;  // four channels a thread
    if (kGen && D % 4 != 0) depthwise_scalar(h, f, acc, L, D);
    for (int e = threadIdx.x; (!kGen || D % 4 == 0) && e < L * nq; e += blockDim.x) {
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
    dense<kBf16, kGen>(acc, D, L, D, D, w.pw[i], x, [=](int m, int n, float v, float r) {
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

// Starts copying `rows` rows of `cols` floats (src rows lds apart) to dst
// (rows ldd apart) with cp.async: the general kernel's copy_rows.
__device__ void copy_cols(float* dst, int ldd, const float* src, int lds, int rows,
                          int cols) {
  if (rows_aligned(src, lds, cols) && ldd % 4 == 0) {
    const int q = cols / 4;
    for (int e = threadIdx.x; e < rows * q; e += kThreads) {
      const int r = e / q, c = (e - r * q) * 4;
      cp_async<16>(dst + r * ldd + c, src + static_cast<long>(r) * lds + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      cp_async<4>(dst + r * ldd + c, src + static_cast<long>(r) * lds + c, true);
    }
  }
}

// epi(bi, m, n, f32(sum_k A_bi[m, k] * B_bi[k, n])) for bi < nb, m < M,
// n < N, with both operands in shared memory, read in place (zeros past M,
// N and K): A_bi[m, k] = a[bi * a_bs + m * lda + k]; B_bi[k, n] =
// b[bi * b_bs + k * ldb + n], or with kBNT b[bi * b_bs + n * ldb + k].  The
// warps take (bi, 32x32 tile) jobs in turn, with no barrier: nothing is
// staged.  Products and sums in f64 on the tensor cores.
template <bool kBNT, class Epi>
__device__ __noinline__ void gemm_smem(int nb, int M, int N, int K,
                                       const float* a, int a_bs, int lda,
                                       const float* b, int b_bs, int ldb,
                                       Epi epi_arg) {
  using Acc = double;
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
    {
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
// The general kernel's attention over one head's scores in the workspace
// at a time (SmemLayout's kStreamed): the staged products, the scale and
// mask, the softmax there.
__device__ __noinline__ void attention_f64_streamed(const float* q, const float* k,
                                                    const float* v, const float* fm,
                                                    const float* tm, int Tq, int Tk,
                                                    const Ctx& x, float scale,
                                                    float* out) {
  const int D = x.D, H = x.H, hd = D / H;
  float* S = x.S;
  for (int h = 0; h < H; ++h) {
    gemm_f64<true>(Tq, Tk, hd, Mat{q + h * hd, D}, Mat{k + h * hd, D}, nullptr,
                   nullptr, x, [=](int i, int j, float acc, float) { S[i * Tk + j] = acc; });
    __syncthreads();
    // the scale and mask apart: the product's epilogue only stores
    for (int e = threadIdx.x; e < Tq * Tk; e += kThreads) {
      const int i = e / Tk;
      S[e] = S[e] * scale + (1.0f - fm[i] * tm[e - i * Tk]) * kMask;
    }
    __syncthreads();
    softmax_rows(S, Tq, Tk, Tk);
    __syncthreads();
    gemm_f64<false>(Tq, hd, Tk, Mat{S, Tk}, Mat{v + h * hd, D}, nullptr, nullptr,
                    x, [=](int i, int c, float acc, float) {
                      out[i * D + h * hd + c] = acc;
                    });
    __syncthreads();
  }
}

// The attention's route (SmemLayout): kResident copies q, k and v of every
// head to shared memory once, kGrouped those of x.heads heads at a time;
// then x.heads heads at a time get their scores, the masked softmax over
// the real Tk, and p.v, all in shared memory.  kStreamed: one head at a
// time, the scores in the workspace (x.S) through the staged products, the
// softmax there; the same sums in the same order, so the same bits.  An
// all-padding `from` row gets -1e30 on every score: the finite part is
// absorbed and the row attends uniformly over the real Tk.
__device__ __noinline__ void attention_f64(const float* q, const float* k,
                                           const float* v, const float* fm,
                                           const float* tm, int Tq, int Tk,
                                           const Ctx& x, float scale, float* out) {
  if (x.attn == kStreamed) {
    attention_f64_streamed(q, k, v, fm, tm, Tq, Tk, x, scale, out);
    return;
  }
  const int D = x.D, H = x.H, hd = D / H, lds = x.lds, G = x.heads;
  const int staged = x.attn == kResident ? H : G;  // heads a copy brings in
  const int w = staged * hd, ldq = w + 4, ldv = w + 8;
  float* Qs = x.stage;  // the stages are free between products
  float* Ks = Qs + x.Lm * ldq;
  float* Vs = Ks + x.Lm * ldq;
  float* S = x.attn == kResident ? x.S : Vs + x.Lm * ldv;
  const int s_bs = Tq * lds;  // one head's scores
  for (int hs = 0; hs < H; hs += staged) {
    copy_cols(Qs, ldq, q + hs * hd, D, Tq, w);
    copy_cols(Ks, ldq, k + hs * hd, D, Tk, w);
    copy_cols(Vs, ldv, v + hs * hd, D, Tk, w);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int h0 = hs; h0 < hs + staged; h0 += G) {
      const int c = (h0 - hs) * hd;  // the group's first staged column
      // the scale multiplies the f32 sum, after the product, as in JAX
      gemm_smem<true>(G, Tq, Tk, hd, Qs + c, hd, ldq, Ks + c, hd, ldq,
                      [=](int g, int i, int j, float acc) {
                        S[g * s_bs + i * lds + j] =
                            acc * scale + (1.0f - fm[i] * tm[j]) * kMask;
                      });
      __syncthreads();
      softmax_rows(S, G * Tq, Tk, lds);
      __syncthreads();
      gemm_smem<false>(G, Tq, hd, Tk, S, s_bs, lds, Vs + c, hd, ldv,
                       [=](int g, int i, int cc, float acc) {
                         out[i * D + (h0 + g) * hd + cc] = acc;
                       });
      __syncthreads();
    }
  }
}

// Rounds rows [0, L) of G heads' columns of src (rows ld floats apart, head
// h's columns [hd h, hd h + hd)) into images of rows of `pitch` values:
// head h to img + h * head, row r at r * pitch; zeros in columns [hd,
// up16(hd)) and rows [L, up16(L)).
__device__ __forceinline__ void stage_head_cols(uint16_t* img, const float* src, int L,
                                                int ld, int hd,
                            int G, int pitch, long head) {
  constexpr int kBatch = 4;  // values of 4 a thread loads before it stores
  const int q4 = up16(hd) / 4, L16 = up16(L), total = G * L16 * q4;
  const bool vec = rows_aligned(src, ld, hd);
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      const int c = e % q4 * 4, r = e / q4 % L16, h = e / (q4 * L16);
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e >= total || r >= L) continue;
      const float* p = src + static_cast<long>(r) * ld + h * hd + c;
      if (vec) {
        if (c < hd) v[i] = ld4(p);
      } else {
        v[i] = make_float4(c < hd ? p[0] : 0.0f, c + 1 < hd ? p[1] : 0.0f,
                           c + 2 < hd ? p[2] : 0.0f, c + 3 < hd ? p[3] : 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      if (e >= total) continue;
      const int c = e % q4 * 4, r = e / q4 % L16, h = e / (q4 * L16);
      *reinterpret_cast<uint2*>(img + h * head + r * pitch + c) =
          make_uint2(bf16x2(v[i].x, v[i].y), bf16x2(v[i].z, v[i].w));
    }
  }
}

// The pieces of a warp's attention job on the bf16 path (16 query rows,
// r0 to r0 + 15 of the Q image; lane l holds rows r0 + l/4 and r0 + l/4 +
// 8).  s[f] += q.k^T over image columns [0, kd) (a multiple of 16) against
// nkp 16-key blocks of the K image: a score row of up to 8 kF keys in
// registers, the accumulators' layout the A fragments' of p.v.
template <int kF>
__device__ __forceinline__ void qk_scores(float (&s)[kF][4],
                                          const uint16_t* Qh, const uint16_t* Kh,
                                          int r0, int nkp, int kd, int pitch) {
  const int lane = threadIdx.x % kWarp;
  for (int kc = 0; kc < kd; kc += 16) {
    uint32_t a[4];
    ldsm_x4(a, Qh + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + kc +
                   8 * (lane >> 4));
#pragma unroll
    for (int fp = 0; fp < kF / 2; ++fp) {
      if (fp >= nkp) break;  // warp-uniform
      // matrices: keys 0-7 dims 0-7, keys 0-7 dims 8-15, keys 8-15 dims
      // 0-7, keys 8-15 dims 8-15 of the block
      uint32_t b[4];
      ldsm_x4(b, Kh + (16 * fp + (lane & 7) + 8 * (lane >> 4)) * pitch + kc +
                     8 * ((lane >> 3) & 1));
      hmma4(s[2 * fp][0], s[2 * fp][1], s[2 * fp][2], s[2 * fp][3], a, b[0], b[1]);
      hmma4(s[2 * fp + 1][0], s[2 * fp + 1][1], s[2 * fp + 1][2], s[2 * fp + 1][3],
            a, b[2], b[3]);
    }
  }
}

// The scale and mask on the scores against keys j < nk (tm their masks;
// f0, f1 the two rows' `from` masks): the scale multiplies the f32 sum, as
// in JAX; the other keys leave the softmax (-inf).  m0, m1: the rows'
// maxima over these keys.
template <int kF>
__device__ __forceinline__ void mask_scores(float (&s)[kF][4],
                                            const float* tm, int nk, int nkp,
                                            float f0, float f1, float scale,
                                            float& m0, float& m1) {
  const int t = threadIdx.x & 3;
  m0 = -INFINITY;
  m1 = -INFINITY;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f >= 2 * nkp) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * f + 2 * t + c;
      if (j < nk) {
        const float tj = tm[j];
        s[f][c] = s[f][c] * scale + (1.0f - f0 * tj) * kMask;
        s[f][2 + c] = s[f][2 + c] * scale + (1.0f - f1 * tj) * kMask;
      } else {  // padding: out of the softmax
        s[f][c] = -INFINITY;
        s[f][2 + c] = -INFINITY;
      }
      m0 = fmaxf(m0, s[f][c]);
      m1 = fmaxf(m1, s[f][2 + c]);
    }
  }
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, o));
  }
}

// s = expf(s - m), summed over the row's keys into sum0, sum1 (the quad's
// lanes reduced).
template <int kF>
__device__ __forceinline__ void exp_scores(float (&s)[kF][4], int nkp,
                                           float m0, float m1, float& sum0,
                                           float& sum1) {
  sum0 = 0.0f;
  sum1 = 0.0f;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f >= 2 * nkp) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      s[f][c] = expf(s[f][c] - m0);
      s[f][2 + c] = expf(s[f][2 + c] - m1);
      sum0 += s[f][c];
      sum1 += s[f][2 + c];
    }
  }
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(kFull, sum0, o);
    sum1 += __shfl_xor_sync(kFull, sum1, o);
  }
}

template <int kF>
__device__ __forceinline__ void divide_scores(float (&s)[kF][4], int nkp,
                                              float sum0, float sum1) {
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f >= 2 * nkp) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      s[f][c] = s[f][c] / sum0;
      s[f][2 + c] = s[f][2 + c] / sum1;
    }
  }
}

// p.v with p rounded from s (nkp key blocks) and v from the V image's
// columns [0, up16(cols)): out[row * D + col] for rows r0 + l/4 (+ 8) below
// Tq and col < cols, or with `add` added to what is there.
template <int kF>
__device__ __forceinline__ void pv_product(const float (&s)[kF][4],
                                           const uint16_t* Vh, int nkp, int cols,
                                           int pitch, int r0, int Tq, float* out,
                                           int D, bool add) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  for (int dc = 0; dc < up16(cols); dc += 16) {
    float o[2][4] = {};
#pragma unroll
    for (int kb = 0; kb < kF / 2; ++kb) {
      if (kb >= nkp) break;
      const uint32_t a[4] = {bf16x2(s[2 * kb][0], s[2 * kb][1]),
                             bf16x2(s[2 * kb][2], s[2 * kb][3]),
                             bf16x2(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                             bf16x2(s[2 * kb + 1][2], s[2 * kb + 1][3])};
      // transposed: keys 0-7 dims 0-7, keys 8-15 dims 0-7, keys 0-7 dims
      // 8-15, keys 8-15 dims 8-15 of the block
      uint32_t b[4];
      ldsm_x4_t(b, Vh + (16 * kb + (lane & 7) + 8 * ((lane >> 3) & 1)) * pitch +
                       dc + 8 * (lane >> 4));
      hmma4(o[0][0], o[0][1], o[0][2], o[0][3], a, b[0], b[1]);
      hmma4(o[1][0], o[1][1], o[1][2], o[1][3], a, b[2], b[3]);
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = r0 + g + 8 * hh, col = dc + 8 * f + 2 * t + c;
          if (row < Tq && col < cols) {
            float* p = out + row * D + col;
            *p = add ? *p + o[f][2 * hh + c] : o[f][2 * hh + c];
          }
        }
  }
}

// Multi-head attention on the bf16 path over more than kKeyChunk keys, or
// where no head's images fit: one head and one block of kQBlock query rows
// at a time, a warp a 16-row job, the keys in chunks of up to kStreamKeys
// (64: a shorter score row than the resident route's, for registers) and
// the head dims in chunks of up to kDimChunk, each chunk's images
// staged in turn (streamed_attention_bytes).  Over one key chunk the
// softmax is the resident route's; over several, a first pass takes each
// row's running maximum and sum (rescaled as the maximum grows), a second
// recomputes the scores, divides, and adds each chunk's p.v to the output.
__device__ __noinline__ void attention_bf16_streamed(const float* q, const float* k,
                                                     const float* v, const float* fm,
                                                     const float* tm, int Tq, int Tk,
                                                     const Ctx& x, float scale,
                                                     float* out) {
  const int D = x.D, H = x.H, hd = D / H, ec = imin(up16(hd), kDimChunk),
            pitch = ec + 8;
  uint16_t* Qs = x.img;
  uint16_t* Ks = Qs + kQBlock * pitch;
  uint16_t* Vs = Ks + kStreamKeys * pitch;
  const int warp = threadIdx.x / kWarp, g = (threadIdx.x % kWarp) >> 2;
  const int r0 = 16 * warp;  // the warp's rows in the block
  const int chunks = (Tk + kStreamKeys - 1) / kStreamKeys, dims = (hd + ec - 1) / ec;
  for (int h = 0; h < H; ++h)
    for (int rb = 0; rb < Tq; rb += kQBlock) {
      const int rows = min(kQBlock, Tq - rb);
      const bool live = r0 < rows;  // warp-uniform
      const int i0 = rb + r0 + g, i1 = i0 + 8;
      const float f0 = i0 < Tq ? fm[i0] : 0.0f, f1 = i1 < Tq ? fm[i1] : 0.0f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
      for (int pass = chunks > 1 ? 0 : 1; pass < 2; ++pass)
        for (int c = 0; c < chunks; ++c) {
          const int j0 = c * kStreamKeys, nk = min(kStreamKeys, Tk - j0), nkp = (nk + 15) / 16;
          float s[kStreamFrags][4];
#pragma unroll
          for (int f = 0; f < kStreamFrags; ++f)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[f][i] = 0.0f;
          for (int e = 0; e < dims; ++e) {
            const int e0 = e * ec, cols = min(ec, hd - e0);
            __syncthreads();  // the images are free
            stage_head_cols(Qs, q + static_cast<long>(rb) * D + h * hd + e0, rows, D, cols,
                        1, pitch, 0);
            stage_head_cols(Ks, k + static_cast<long>(j0) * D + h * hd + e0, nk, D, cols,
                        1, pitch, 0);
            __syncthreads();
            if (live) qk_scores(s, Qs, Ks, r0, nkp, up16(cols), pitch);
          }
          if (live) {
            float c0, c1, a0, a1;
            mask_scores(s, tm + j0, nk, nkp, f0, f1, scale, c0, c1);
            if (pass == 0) {  // the running maximum and sum
              const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
              exp_scores(s, nkp, n0, n1, a0, a1);
              l0 = l0 * expf(m0 - n0) + a0;
              l1 = l1 * expf(m1 - n1) + a1;
              m0 = n0;
              m1 = n1;
            } else if (chunks == 1) {
              exp_scores(s, nkp, c0, c1, l0, l1);
              divide_scores(s, nkp, l0, l1);
            } else {
              exp_scores(s, nkp, m0, m1, a0, a1);
              divide_scores(s, nkp, l0, l1);
            }
          }
          if (pass == 0) continue;
          for (int e = 0; e < dims; ++e) {
            const int e0 = e * ec, cols = min(ec, hd - e0);
            __syncthreads();  // the images are free
            stage_head_cols(Vs, v + static_cast<long>(j0) * D + h * hd + e0, nk, D, cols,
                        1, pitch, 0);
            __syncthreads();
            if (live)
              pv_product(s, Vs, nkp, cols, pitch, r0, rows,
                         out + static_cast<long>(rb) * D + h * hd + e0, D, c > 0);
          }
        }
    }
  __syncthreads();  // the images are free
}

// Multi-head attention on the bf16 path, the function of attention_f64:
// q, k and v of x.heads heads at a time (all of them where they fit)
// rounded into per-head images (rows of up16(hd) values and 8 of padding,
// so ldmatrix is free of bank conflicts), then one warp per (head, 16 query
// rows): q.k^T on mma.sync into registers (a row of up to kKeyChunk keys),
// the scale and mask, the softmax over the real Tk in registers (a row's
// values lie in the 4 lanes of a quad), and p.v with p rounded as the A
// fragments: the scores' accumulator layout is the A fragment layout.  More
// keys, or no head that fits, stream (attention_bf16_streamed).
template <bool kGen>
__device__ __noinline__ void attention_bf16(const float* q, const float* k,
                                            const float* v, const float* fm,
                                            const float* tm, int Tq, int Tk,
                                            const Ctx& x, float scale, float* out) {
  if (kGen && (Tk > kKeyChunk || x.heads == 0)) {
    attention_bf16_streamed(q, k, v, fm, tm, Tq, Tk, x, scale, out);
    return;
  }
  const int D = x.D, H = x.H, G = x.heads, hd = D / H, pitch = up16(hd) + 8;
  const long head = static_cast<long>(x.qkv_rows) * pitch;
  uint16_t* Qs = x.img;
  uint16_t* Ks = Qs + G * head;
  uint16_t* Vs = Ks + G * head;
  const int warp = threadIdx.x / kWarp, g = (threadIdx.x % kWarp) >> 2;
  const int nqt = (Tq + 15) / 16, nkp = (Tk + 15) / 16;  // 16-key blocks
  for (int h0 = 0; h0 < H; h0 += G) {
    stage_head_cols(Qs, q + h0 * hd, Tq, D, hd, G, pitch, head);
    stage_head_cols(Ks, k + h0 * hd, Tk, D, hd, G, pitch, head);
    stage_head_cols(Vs, v + h0 * hd, Tk, D, hd, G, pitch, head);
    __syncthreads();
    for (int job = warp; job < G * nqt; job += kWarps) {
      const int h = job / nqt, r0 = job % nqt * 16;
      float s[kMaxKeyFrags][4];
#pragma unroll
      for (int f = 0; f < kMaxKeyFrags; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[f][i] = 0.0f;
      qk_scores(s, Qs + h * head, Ks + h * head, r0, nkp, up16(hd), pitch);
      // rows r0 + g and r0 + g + 8
      const int i0 = r0 + g, i1 = i0 + 8;
      const float f0 = i0 < Tq ? fm[i0] : 0.0f, f1 = i1 < Tq ? fm[i1] : 0.0f;
      float m0, m1, sum0, sum1;
      mask_scores(s, tm, Tk, nkp, f0, f1, scale, m0, m1);
      exp_scores(s, nkp, m0, m1, sum0, sum1);
      divide_scores(s, nkp, sum0, sum1);
      pv_product(s, Vs + h * head, nkp, hd, pitch, r0, Tq, out + (h0 + h) * hd, D,
                 false);
    }
    __syncthreads();  // the images are free
  }
}

// The resident kernel's attention on the f64 path (every head's q, k and v
// staged at once), kept apart from the general one (attention_f64): shared,
// the general code timed slower in the resident kernel, where the bf16
// path's shared attention did not.  Multi-head attention over
// q (Tq x D), k and v (Tk x D):
//   S_h = (q_h k_h^T) * scale + (1 - fm[i] * tm[j]) * -1e30
//   out[:, h*hd:(h+1)*hd] = softmax_rows(S_h) @ v_h
// q, k and v are copied to shared memory once; then x.heads heads at a
// time: their scores, the masked softmax over the real Tk, and p.v, all in
// shared memory.  An all-padding `from` row gets -1e30 on every score: the
// finite part is absorbed and the row attends uniformly over the real Tk.
__device__ __noinline__ void attention_f64_resident(const float* q, const float* k,
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
    gemm_smem<true>(G, Tq, Tk, hd, Qs + h0 * hd, hd, ldq, Ks + h0 * hd,
                           hd, ldq, [=](int g, int i, int j, float acc) {
                             S[g * s_bs + i * lds + j] =
                                 acc * scale + (1.0f - fm[i] * tm[j]) * kMask;
                           });
    __syncthreads();
    softmax_rows(S, G * Tq, Tk, lds);
    __syncthreads();
    gemm_smem<false>(G, Tq, hd, Tk, S, s_bs, lds, Vs + h0 * hd, hd, ldv,
                            [=](int g, int i, int c, float acc) {
                              out[i * D + (h0 + g) * hd + c] = acc;
                            });
    __syncthreads();
  }
}

template <bool kBf16, bool kGen>
__device__ __forceinline__ void attention(const float* q, const float* k,
                                          const float* v, const float* fm,
                                          const float* tm, int Tq, int Tk,
                                          const Ctx& x, float scale, float* out) {
  if constexpr (kBf16)
    attention_bf16<kGen>(q, k, v, fm, tm, Tq, Tk, x, scale, out);
  else if constexpr (kGen)
    attention_f64(q, k, v, fm, tm, Tq, Tk, x, scale, out);
  else
    attention_f64_resident(q, k, v, fm, tm, Tq, Tk, x, scale, out);
}

struct Scratch {
  float* buf[9];  // Lm x D each
};

// mix = s_gate * x_val + x_gate * s_val one value a thread, for D not a
// multiple of 4; out of line.
__device__ __noinline__ void mix_scalar(float* mix, const float* s_gate, const float* x_val,
                                        const float* x_gate, const float* s_val, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    mix[e] = s_gate[e] * x_val[e] + x_gate[e] * s_val[e];
}

// One dual-attention layer in one direction: from (Tq rows) attends to
// itself and to `to` (Tk rows); the result goes to dest (Tq x D).
template <bool kBf16, bool kGen>
__device__ __noinline__ void dual_attn(const float* from, const float* to, const float* fm,
                          const float* tm, int Tq, int Tk, const Ctx& x,
                          const DualW& w, float scale, const Scratch& s,
                          float* dest) {
  const int D = x.D, D2 = 2 * D;
  // cat (scratch 0 and 1 as Lm rows of 2D): [out | ton], then [out | outputs]
  float *cat = s.buf[0], *out = cat, *ton = cat + D, *qp = s.buf[2],
        *fk = s.buf[3], *fv = s.buf[4], *tk = s.buf[5], *tv = s.buf[6],
        *sout = s.buf[7], *xout = s.buf[8];

  ln<kGen>(from, out, D2, Tq, D, w.ln1);
  ln<kGen>(to, ton, D2, Tk, D, w.lnt);
  __syncthreads();
  auto store = [&](float* y) {
    return [=](int m, int n, float v, float) { y[m * D + n] = v; };
  };
  dense<kBf16, kGen>(out, D2, Tq, D, D, w.query, x, store(qp));
  // on the bf16 path f_key, f_value and t_value read the A image in place
  dense<kBf16, kGen>(out, D2, Tq, D, D, w.f_key, x, store(fk), nullptr, 0, true);
  dense<kBf16, kGen>(out, D2, Tq, D, D, w.f_value, x, store(fv), nullptr, 0, true);
  dense<kBf16, kGen>(ton, D2, Tk, D, D, w.t_key, x, store(tk));
  dense<kBf16, kGen>(ton, D2, Tk, D, D, w.t_value, x, store(tv), nullptr, 0, true);
  __syncthreads();
  attention<kBf16, kGen>(qp, fk, fv, fm, fm, Tq, Tq, x, scale, sout);
  attention<kBf16, kGen>(qp, tk, tv, fm, tm, Tq, Tk, x, scale, xout);
  __syncthreads();
  float *s_val = qp, *x_val = fk, *s_gate = fv, *x_gate = tk;
  dense<kBf16, kGen>(sout, D, Tq, D, D, w.s_dense, x, store(s_val));
  dense<kBf16, kGen>(xout, D, Tq, D, D, w.x_dense, x, store(x_val));
  __syncthreads();
  dense<kBf16, kGen>(s_val, D, Tq, D, D, w.s_gate, x, [=](int m, int n, float v, float) {
    s_gate[m * D + n] = sigmoidf(v);
  });
  dense<kBf16, kGen>(x_val, D, Tq, D, D, w.x_gate, x, [=](int m, int n, float v, float) {
    x_gate[m * D + n] = sigmoidf(v);
  });
  __syncthreads();
  float* mix = sout;
  if (kGen && D % 4 != 0) mix_scalar(mix, s_gate, x_val, x_gate, s_val, Tq * D);
  for (int e = 4 * threadIdx.x; (!kGen || D % 4 == 0) && e < Tq * D; e += 4 * blockDim.x) {
    const float4 sg = ld4(s_gate + e), xv = ld4(x_val + e), xg = ld4(x_gate + e),
                 sv = ld4(s_val + e);
    st4(mix + e, make_float4(sg.x * xv.x + xg.x * sv.x, sg.y * xv.y + xg.y * sv.y,
                             sg.z * xv.z + xg.z * sv.z, sg.w * xv.w + xg.w * sv.w));
  }
  __syncthreads();
  float* outputs = cat + D;  // over ton, which is spent
  dense<kBf16, kGen>(mix, D, Tq, D, D, w.guided, x,
        [=](int m, int n, float v, float) { outputs[m * D2 + n] = v; });
  __syncthreads();
  // bilinear_k = out @ d1 + outputs @ d2 + b as one product with K = 2D:
  // [out | outputs] @ [d1; d2] (packed next to each other), summed in f64
  // and rounded once, where the plain version rounds both products
  float *scores = tv, *values = sout;
  dense<kBf16, kGen>(cat, D2, Tq, D2, D, Dense{w.b1d1, w.b1b}, x, store(scores), nullptr, D);
  dense<kBf16, kGen>(cat, D2, Tq, D2, D, Dense{w.b2d1, w.b2b}, x, store(values), nullptr, D,
               true);
  __syncthreads();
  // gate: sigmoid(scores*m + -1e30*(1-m)) * values, exactly 0 on padded rows
  float* gated = qp;
  for (int e = threadIdx.x; e < Tq * D; e += blockDim.x) {
    const float m = fm[e / D];
    gated[e] = sigmoidf(scores[e] * m + kMask * (1.0f - m)) * values[e];
  }
  __syncthreads();
  float* res = fk;
  dense<kBf16, kGen>(gated, D, Tq, D, D, w.dense_1, x,
        [=](int m, int n, float v, float r) { res[m * D + n] = v + r; }, from);
  __syncthreads();
  ln<kGen>(res, fv, D, Tq, D, w.ln2);
  __syncthreads();
  dense<kBf16, kGen>(fv, D, Tq, D, D, w.dense_2, x,
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
template <bool kBf16, bool kGen>
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
  gemm<true, kBf16, kGen>(T1, T2, D, Mat{x1wm, D}, Mat{x2, D}, nullptr, nullptr, x,
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
  gemm<false, kBf16, kGen>(T1, D, T2, Mat{s_, T2}, Mat{x2, D}, nullptr, nullptr, x,
                     [=](int i, int c, float acc, float) {
                       att[i * D4 + c] = x1[i * D + c];
                       att[i * D4 + D + c] = acc;
                       att[i * D4 + 2 * D + c] = x1[i * D + c] * acc;
                     });
  // score_ @ score_t^T (T1 x T1)
  gemm<true, kBf16, kGen>(T1, T1, T2, Mat{s_, T2}, Mat{st, T2}, nullptr, nullptr, x,
                    [=](int i, int i2, float acc, float) { m1m[i * T1 + i2] = acc; });
  __syncthreads();
  gemm<false, kBf16, kGen>(T1, D, T1, Mat{m1m, T1}, Mat{x1, D}, nullptr, nullptr, x,
                     [=](int i, int c, float acc, float) {
                       att[i * D4 + 3 * D + c] = x1[i * D + c] * acc;
                     });
  __syncthreads();
  if constexpr (kBf16 && !kGen) {
    // two products of K = 2D (the ring holds at most 256 values of k), the
    // second adding the first's sums: the companion images the kernel's
    // two halves apart
    dense<kBf16, kGen>(att, D4, T1, 2 * D, D, w.dense, x,
                       [=](int m, int n, float v, float) { out[m * D + n] = v; });
    __syncthreads();
    dense<kBf16, kGen>(att + 2 * D, D4, T1, 2 * D, D, w.dense, x,
                       [=](int m, int n, float v, float r) { out[m * D + n] = r + v; },
                       out);
  } else {
    // on the general bf16 path its two halves are imaged apart (seg 2D) and
    // run as chunks of k <= 256 (tiled_pass)
    dense<kBf16, kGen>(att, D4, T1, D4, D, w.dense, x,
                       [=](int m, int n, float v, float) { out[m * D + n] = v; }, nullptr,
                       2 * D);
  }
  __syncthreads();
}

__device__ __noinline__ void add_scalar(float* out, const float* a, const float* b,
                                        int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[e] = a[e] + b[e];
}

// out[e] = a[e] + b[e] for e < n: four a thread where `vec` (D a multiple
// of 4: every row 16-byte aligned), else one (add_scalar, out of line).
__device__ __forceinline__ void add_rows(float* out, const float* a, const float* b,
                                         int n, bool vec) {
  if (!vec) {
    add_scalar(out, a, b, n);
    return;
  }
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x) {
    const float4 u = ld4(a + e), w = ld4(b + e);
    st4(out + e, make_float4(u.x + w.x, u.y + w.y, u.z + w.z, u.w + w.w));
  }
}

struct FEW {
  const float* pos;
  ConvBlockW conv;
  LN ln1, ln2;
  Dense q, k, v, dense;
};

// Feature encoder: y = x + pos -> conv block -> LN -> self-attention
// (+ residual) -> LN -> dense (+ residual); y may not alias x.
template <bool kBf16, bool kGen>
__device__ __noinline__ void feature_encoder(const float* in, const float* vm, const Ctx& x,
                                const FEW& w, float scale, const Scratch& s,
                                float* y) {
  const int T = x.T, D = x.D;
  add_rows(y, in, w.pos, T * D, !kGen || D % 4 == 0);
  __syncthreads();
  conv_block<kBf16, kGen>(y, T, x, w.conv, s.buf[0], s.buf[1]);
  float *o = s.buf[0], *q = s.buf[1], *k = s.buf[2], *v = s.buf[3],
        *att = s.buf[4], *res = s.buf[5], *ln2 = s.buf[6];
  ln<kGen>(y, o, D, T, D, w.ln1);
  __syncthreads();
  auto store = [&](float* out) {
    return [=](int m, int n, float val, float) { out[m * D + n] = val; };
  };
  dense<kBf16, kGen>(o, D, T, D, D, w.q, x, store(q));
  dense<kBf16, kGen>(o, D, T, D, D, w.k, x, store(k), nullptr, 0, true);
  dense<kBf16, kGen>(o, D, T, D, D, w.v, x, store(v), nullptr, 0, true);
  __syncthreads();
  attention<kBf16, kGen>(q, k, v, vm, vm, T, T, x, scale, att);
  __syncthreads();
  add_rows(res, att, y, T * D, !kGen || D % 4 == 0);
  __syncthreads();
  ln<kGen>(res, ln2, D, T, D, w.ln2);
  __syncthreads();
  dense<kBf16, kGen>(ln2, D, T, D, D, w.dense, x,
        [=](int m, int n, float val, float r) { y[m * D + n] = val + r; }, res);
  __syncthreads();
}

// The sample's workspace (x.ws, rows x.ld floats apart): buffers 0-3 hold
// the two streams and their next layer, 4-12 are scratch, then the CQ
// attention's 4 Lm x Lm matrices, the small vectors (the last, `pooled`,
// D floats), the masks' spare place (T + W) and the split products'
// partial sums (Lm x max(Lm, D)).  After the
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

__device__ __forceinline__ float* ws_masks(const Ctx& x) {
  return vec(x, 3 + kLabels) + x.D;
}

// Shared positional embedding and conv block on both streams, then the
// dual-attention stack.  Returns the buffer of the final video stream (0 or
// 2); the query stream follows it.
template <bool kBf16, bool kGen>
__device__ __noinline__ int encode(const Ctx& x, Cursor& c, const float* vfb,
                                   const float* qfb, const float* vm,
                                   const float* qm, int P, int attn_layer,
                                   float scale, const Scratch& s) {
  const int T = x.T, W = x.W, D = x.D;
  const float* pos = c.take(static_cast<long>(P) * D);
  const ConvBlockW cb = take_conv_block(c, D);
  add_rows(buf(x, 0), vfb, pos, T * D, !kGen || D % 4 == 0);
  add_rows(buf(x, 1), qfb, pos, W * D, !kGen || D % 4 == 0);
  __syncthreads();
  conv_block<kBf16, kGen>(buf(x, 0), T, x, cb, s.buf[0], s.buf[1]);
  conv_block<kBf16, kGen>(buf(x, 1), W, x, cb, s.buf[0], s.buf[1]);
  int cur = 0;
  for (int li = 0; li < attn_layer; ++li) {
    const DualW dw = take_dual(c, D);
    dual_attn<kBf16, kGen>(buf(x, cur), buf(x, cur + 1), vm, qm, T, W, x, dw, scale, s,
              buf(x, 2 - cur));
    dual_attn<kBf16, kGen>(buf(x, cur + 1), buf(x, cur), qm, vm, W, T, x, dw, scale, s,
              buf(x, 3 - cur));
    cur = 2 - cur;
  }
  return cur;
}

// CQ fusion both ways, weighted pooling, cq_cat, the matching softmax (to
// ms_out) and the soft label embedding: fuse and then outp in the final
// streams' buffers.
template <bool kBf16, bool kGen>
__device__ __noinline__ void fuse(const Ctx& x, Cursor& c, const float* vm,
                                  const float* qm, int cur, const Scratch& s,
                                  float* ms_out, int use_gumbel, float tau) {
  const int T = x.T, W = x.W, D = x.D, D2 = 2 * D;
  const int xv = cur, xq = cur + 1, q2v = 2 - cur, v2q = 3 - cur;
  float* cqreg = buf(x, kBuffers);
  const CQW q2v_w = take_cq(c, D);
  const CQW v2q_w = take_cq(c, D);
  cq_attention<kBf16, kGen>(buf(x, xv), buf(x, xq), vm, qm, T, W, x, q2v_w, s.buf[0],
               vec(x, 0), vec(x, 1), cqreg, s.buf[1], buf(x, q2v));
  cq_attention<kBf16, kGen>(buf(x, xq), buf(x, xv), qm, vm, W, T, x, v2q_w, s.buf[0],
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
  dense<kBf16, kGen>(s.buf[1], D2, T, D2, D, cq_cat, x,
        [=](int m, int n, float v, float) { fuse_out[m * D + n] = v; });
  __syncthreads();

  // matching head + soft label embedding
  const Dense match = take_dense(c, D, kLabels);
  const float* label_emb = c.take(kLabels * D);
  float* mlog = vec(x, 3);
  // an mm in the JAX kernel: it rounds on the bf16 path too (the weight
  // from the companion)
  auto head = [=](int m, int n, float v) { mlog[m * kLabels + n] = v + match.b[n]; };
  if constexpr (kBf16)
    narrow_dense<true>(buf(x, xv), T, D, kLabels, x.wbf + x.match_bf, head);
  else
    narrow_dense<false>(buf(x, xv), T, D, kLabels, match.w, head);
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
        const float p = mlog[t * kLabels + k];
        if constexpr (kBf16)
          soft += round_bf16(p) * bf16f(x.wbf[x.label_bf + k * D + c2]);
        else
          soft += p * label_emb[k * D + c2];
      }
      outp[e] = (fz[e] + soft) * vm[t];
    }
  }
  __syncthreads();
}

// The conditioned predictor: the feature encoder twice (into the spent
// pair's buffers), then per side [LN(feats), outp] @ hidden + b -> relu
// -> . dense + b.
template <bool kBf16, bool kGen>
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
  feature_encoder<kBf16, kGen>(buf(x, outp), vm, x, fe, scale, s, buf(x, start_f));
  feature_encoder<kBf16, kGen>(buf(x, start_f), vm, x, fe, scale, s, buf(x, end_f));
  const LN lns[2] = {take_ln(c, D), take_ln(c, D)};
  Dense hidden[2], last[2];
  hidden[0] = take_dense(c, D2, D);
  hidden[1] = take_dense(c, D2, D);
  last[0] = take_dense(c, D, 1);
  last[1] = take_dense(c, D, 1);
  for (int which = 0; which < 2; ++which) {
    float* wide = s.buf[1];
    ln<kGen>(buf(x, which ? end_f : start_f), wide, D2, T, D, lns[which]);
    const float* op = buf(x, outp);
    for (int e = threadIdx.x; e < T * D; e += blockDim.x)
      wide[(e / D) * D2 + D + e % D] = op[e];
    __syncthreads();
    float* hid = s.buf[0];
    dense<kBf16, kGen>(wide, D2, T, D2, D, hidden[which], x,
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
  const uint16_t* wbf;  // the bf16 path: the companion, its ring schedule
  const int* sched;
  int nsched, match_bf, label_bf;
  int T, W, D, H, attn_layer, P;
  float tau;
  int use_gumbel;
};

template <bool kBf16, bool kGen>
__global__ void __launch_bounds__(kThreads, 1)
    fused_forward_kernel(const Params p) {
  const int b = blockIdx.x;
  const int T = p.T, W = p.W, D = p.D;
  const int Lm = max(T, W);
  const long ld = static_cast<long>(Lm) * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / p.H));

  extern __shared__ __align__(16) float smem[];
  Ctx x;
  x.T = T;
  x.W = W;
  x.D = D;
  x.H = p.H;
  x.Lm = Lm;
  x.ws = p.workspace + b * p.ws_floats;
  x.ld = ld;
  x.part = ws_masks(x) + T + W;
  float* vm = ws_masks(x);  // (T) video mask, in shared memory where it fits
  if constexpr (kBf16) {
    const Bf16Layout lay(T, W, D, p.H);
    char* base = reinterpret_cast<char*>(smem);
    x.img = reinterpret_cast<uint16_t*>(base);
    x.ring = reinterpret_cast<uint16_t*>(base + lay.ring);
    x.full = reinterpret_cast<uint64_t*>(base + lay.bars);
    x.wbf = p.wbf;
    x.sched = p.sched;
    x.nsched = p.nsched;
    x.qkv_rows = lay.qkv_rows;
    x.heads = lay.heads;
    x.cq_tile = lay.cq_tile;
    x.match_bf = p.match_bf;
    x.label_bf = p.label_bf;
    x.slab = 0;
    if (lay.masks_smem) vm = reinterpret_cast<float*>(base + lay.masks);
    if (threadIdx.x == 0) {  // the ring's barriers and first slabs
      for (int i = 0; i < kRing; ++i) mbar_init(x.full + i, 1);
      fence_mbar_init();
      for (int s = 0; s < kRing && s < x.nsched; ++s)
        bulk_copy(x.ring + s * kSlotValues,
                  reinterpret_cast<const char*>(x.wbf) + x.sched[2 * s],
                  x.sched[2 * s + 1], x.full + s);
    }
  } else {
    const SmemLayout lay(T, W, D, p.H);
    x.stage = smem;
    x.stage_floats = lay.a_floats + lay.b_floats;
    x.a_floats = lay.a_floats;
    x.lds = lay.score_ld;
    x.heads = lay.heads;
    x.attn = lay.attn;
    // the scores: after the region (resident), inside it (grouped), or in
    // the CQ attention's matrices (streamed)
    x.S = lay.attn == kStreamed ? buf(x, kBuffers) : smem + lay.region;
    if (lay.masks_smem)
      vm = smem + lay.region + (lay.attn == kResident ? lay.heads * lay.head_floats : 0);
  }
  float* qm = vm + T;                  // (W) query mask
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    vm[t] = static_cast<float>(p.v_mask[static_cast<long>(b) * T + t]);
  for (int t = threadIdx.x; t < W; t += blockDim.x)
    qm[t] = static_cast<float>(p.q_mask[static_cast<long>(b) * W + t]);

  Scratch s;
  for (int i = 0; i < 9; ++i) s.buf[i] = buf(x, 4 + i);
  Cursor c{p.weights};
  const int cur = encode<kBf16, kGen>(x, c, p.vf + static_cast<long>(b) * T * D,
                         p.qf + static_cast<long>(b) * W * D, vm, qm, p.P,
                         p.attn_layer, scale, s);
  fuse<kBf16, kGen>(x, c, vm, qm, cur, s,
              p.match_scores + static_cast<long>(b) * T * kLabels, p.use_gumbel,
              p.tau);
  predict<kBf16, kGen>(x, c, vm, cur, p.P, scale, s,
                 p.start_logits + static_cast<long>(b) * T,
                 p.end_logits + static_cast<long>(b) * T);
}

// Opts the kernel's instantiation in to `smem` bytes of dynamic shared
// memory and launches it; returns the first CUDA error.
template <bool kBf16, bool kGen>
int launch(const Params& p, int B, int smem, cudaStream_t stream) {
  const cudaError_t rc = cudaFuncSetAttribute(
      fused_forward_kernel<kBf16, kGen>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_forward_kernel<kBf16, kGen><<<B, kThreads, smem, stream>>>(p);
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
  (void)H;
  const long long lm = T > W ? T : W;
  const long long n = kBuffers * lm * D + 4 * lm * lm + (3 + kLabels) * lm + D +
                      (T + W) + lm * (lm > D ? lm : D);
  return (n + 31) / 32 * 32;  // 128-byte aligned samples
}

extern "C" long long fused_forward_smem_bytes(int T, int W, int D, int H) {
  return SmemLayout(T, W, D, H).floats() * static_cast<long long>(sizeof(float));
}

extern "C" long long fused_forward_bf16_smem_bytes(int T, int W, int D, int H) {
  return Bf16Layout(T, W, D, H).bytes;
}

extern "C" int fused_forward_bf16_ring() { return kRing; }

extern "C" int fused_forward_bf16_slab_k() { return kKSlab; }

// The routes of a launch at this shape (the layouts above), out[0..5]: the
// f64 path's attention route (0 resident, 1 grouped, 2 streamed), its heads
// a group, its masks in shared memory (1) or the workspace (0); the bf16
// path's heads a group (0: every attention streams), its CQ tile (0:
// resident), its masks in shared memory.
extern "C" void fused_forward_routes(int T, int W, int D, int H, int* out) {
  const SmemLayout f(T, W, D, H);
  const Bf16Layout b(T, W, D, H);
  out[0] = f.attn;
  out[1] = f.heads;
  out[2] = f.masks_smem;
  out[3] = b.heads;
  out[4] = b.cq_tile;
  out[5] = b.masks_smem;
}

extern "C" int fused_forward_threads() { return kThreads; }

namespace {

// Whether the resident kernel takes this shape: every stage on its
// resident route (D <= 128 and a multiple of 4, at most kKeyChunk keys, q,
// k and v of every head and the CQ products' images in shared memory, the
// masks there too).  Every other shape runs the general kernel.
bool resident_takes(int T, int W, int D, int H, bool bf16) {
  if (D > kRingRows || D % 4 != 0 || (T > W ? T : W) > kKeyChunk) return false;
  if (bf16) {
    const Bf16Layout b(T, W, D, H);
    return b.heads == H && b.cq_tile == 0 && b.masks_smem;
  }
  const SmemLayout f(T, W, D, H);
  return f.attn == kResident && f.masks_smem;
}

}  // namespace

// 1 if this library's kernel takes the shape on the path (the general
// build takes every shape the entry points take).
extern "C" int fused_forward_takes(int T, int W, int D, int H, int bf16) {
  if (T < 1 || W < 1 || H < 1 || D % H != 0) return 0;
  return K2_GENERAL || resident_takes(T, W, D, H, bf16 != 0);
}

namespace {

// The launch of either path: returns the first CUDA error.
int run(Params& p, const void* weights, const void* vf, const void* qf,
        const void* v_mask, const void* q_mask, void* start_logits,
        void* end_logits, void* match_scores, void* workspace, int B, int T,
        int W, int D, int H, int attn_layer, int P, float tau, int use_gumbel,
        bool bf16, void* stream) {
  if (B <= 0) return 0;
  if (!fused_forward_takes(T, W, D, H, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, K2_GENERAL>(p, B, static_cast<int>(fused_forward_bf16_smem_bytes(T, W, D, H)),
                        s);
  return launch<false, K2_GENERAL>(p, B, static_cast<int>(fused_forward_smem_bytes(T, W, D, H)), s);
}

}  // namespace

// The default path: f32 operands, f64 sums.
extern "C" int fused_forward_f32(const void* weights, const void* vf,
                                 const void* qf, const void* v_mask,
                                 const void* q_mask, void* start_logits,
                                 void* end_logits, void* match_scores,
                                 void* workspace, int B, int T, int W, int D,
                                 int H, int attn_layer, int P, float tau,
                                 int use_gumbel, void* stream) {
  Params p = {};
  return run(p, weights, vf, qf, v_mask, q_mask, start_logits, end_logits,
             match_scores, workspace, B, T, W, D, H, attn_layer, P, tau,
             use_gumbel, false, stream);
}

// The bf16 path: `wbf16` the bf16 companion of the packed weights (16-byte
// aligned), `schedule` (device, int32) its ring slabs in the order of the
// products, (byte offset, bytes) each; match_bf and label_bf the values'
// offsets of the matching head's kernel and label_emb in the companion.
extern "C" int fused_forward_bf16(const void* weights, const void* wbf16,
                                  const void* schedule, int nsched, int match_bf,
                                  int label_bf, const void* vf, const void* qf,
                                  const void* v_mask, const void* q_mask,
                                  void* start_logits, void* end_logits,
                                  void* match_scores, void* workspace, int B,
                                  int T, int W, int D, int H, int attn_layer,
                                  int P, float tau, int use_gumbel, void* stream) {
  if (wbf16 == nullptr || schedule == nullptr || nsched < 1 ||
      (reinterpret_cast<uintptr_t>(wbf16) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.wbf = static_cast<const uint16_t*>(wbf16);
  p.sched = static_cast<const int*>(schedule);
  p.nsched = nsched;
  p.match_bf = match_bf;
  p.label_bf = label_bf;
  return run(p, weights, vf, qf, v_mask, q_mask, start_logits, end_logits,
             match_scores, workspace, B, T, W, D, H, attn_layer, P, tau,
             use_gumbel, true, stream);
}
