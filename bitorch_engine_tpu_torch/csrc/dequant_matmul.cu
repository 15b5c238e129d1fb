// MPQ weight-only linear kernels for Hopper (sm_90a), gptq row order.
//
// Packed codes: int32 (K / ppw, N), ppw = 32 / w_bit; value j of word r is
// logical row r * ppw + j, LSB first.  Group metadata: scales / zeros
// (K / group_size, N), float32 or bfloat16; kernels 1 and 7 take the
// symmetric form w = q * s - z (asymmetric tensors are rewritten to it
// beforehand), kernel 2 also an asym tensor's packed integer zeros.
//
// bte_mpq_matmul -- replaces bitorch_engine_tpu/ops/pallas/dequant_matmul.py
//   :_mpq_kernel (A16 branches of _accumulate_k_step), the fused
//   dequant-matmul y = x @ (q * s[g] - z[g]) for m <= 512 rows.
//   Bound on the H100: at the decode batch (m = 8) it must read the packed
//   words and the metadata once (4.25 bits per weight with bf16 metadata at
//   g128) and does 2 * m operations per weight, far below the 295 operations
//   per byte where compute would take over: memory bound at 3.35 TB/s.
//   Design: each block owns 32 output columns and 8 activation rows; its 256
//   threads split into 8 column quads (one coalesced 16-byte load of packed
//   words per packed row) x 32 K-slices, each slice a whole quant group (or
//   an equal part of one, when there are fewer than 32 groups).  Codes are
//   unpacked in registers and dotted with the activations in f32; the group
//   metadata is applied once per group in the factored form
//   acc += s[g] * dot_g(x, q) - z[g] * sum_g(x), and the slices are summed
//   in shared memory.  No weight is ever written out.  CUDA-core FMAs, no
//   tensor cores, no cp.async / TMA: the simple form first.
//
// bte_mbwq_matmul -- replaces bitorch_engine_tpu/ops/pallas/mbwq_matmul.py
//   :_mbwq_kernel (_mbwq_matmul_call, entry mbwq_matmul_pallas), the fused
//   mixed-bit matmul: x (already channel-scaled and gathered into segment
//   order) @ the 1-8 uniform segments stacked along K, in ONE launch with
//   one f32 accumulator per output and a single cast.  Bound: the same as
//   kernel 1's (bytes: every segment's packed words and metadata once).
//   Design: kernel 1's block and its per-width unpack and FMA slice
//   (accumulate_slice); the block's 32 K-slices walk the groups of all
//   segments in turn, each slice switching on its segment's width, so one
//   output write replaces a launch and an output per segment plus the
//   adds.  The segment table is a kernel parameter.
//
// bte_dequant -- replaces dequant_matmul.py:_dequant_kernel (kernel 2), the
//   streaming reconstruct of the logical (K, N) weight in f32 or bf16 for
//   every m > 64 forward, every backward and DiodeMix's update.  Beside the
//   TPU kernel's arithmetic it does the two passes that used to surround
//   it: an act-order tensor's row map (stored row r is written to row
//   row_map[r], JAX's .at[q_perm].set(w)) and an asym tensor's zeros, read
//   from their packed words (ZeroForm: the kernel form q * s - bf(s * z),
//   or DiodeMix's exact s * (q - z)).
//   Bound: bytes.  It must read the packed words, the metadata, the zero
//   words and the row map once and write K * N outputs once, at 3.35 TB/s;
//   at w4 with bf16 output 80% of those bytes are stores.
//   Design: one block of 256 threads a tile of 4 packed rows x 256
//   columns, one tile a block (the grid is computed in bte_dequant); a
//   thread owns one packed row x 4 columns: one 16-byte load of code
//   words, one of scales (and of sym zeros, or one zero word), then one
//   8-byte (bf16) or 16-byte (f32) store per logical row.  Neighbouring
//   threads write neighbouring bytes of one output row whatever the row
//   map, so the scatter costs no extra pass and no uncoalesced write: no
//   shared-memory staging, no barrier, no cluster.  On the H100 the -D
//   variants below lost on the whole (chip_smoke.py --kernel2-ab, PERF.md
//   §6 row 2): TMA bulk stores from a shared-memory tile were slower on
//   every path, most on the 370M's short launches; 2 packed rows and/or 8
//   columns a thread came within about 1% either way on the 8B, Mixtral and
//   act-order paths and were slower on the 370M step, 8 columns far
//   slower in f32.  N not a multiple of 4 (or a pointer not 16-byte
//   aligned) takes the same walk one column at a time.  Bit-exact with the plain version (and with the JAX
//   package's jitted dequantize in the symmetric and exact forms): each
//   weight is rounded once, as one fused multiply-add (__fmaf_rn, XLA's
//   contraction of q * s - z) or one product (s * (q - z), q - z exact in
//   f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Four consecutive values (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float o[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  o[0] = fa.x; o[1] = fa.y; o[2] = fb.x; o[3] = fb.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// C consecutive activations (C in {4, 8}) as f32.
template <int C> __device__ __forceinline__ void load_x(const float* p, float o[C]) {
#pragma unroll
  for (int i = 0; i < C; i += 4) load4(p + i, o + i);
}
template <int C> __device__ __forceinline__ void load_x(const bf16* p, float o[C]) {
#pragma unroll
  for (int i = 0; i < C; i += 4) load4(p + i, o + i);
}

constexpr int MM_TX = 8;              // column quads per block
constexpr int MM_TY = 32;             // K-slices per block
constexpr int MM_BN = MM_TX * 4;      // output columns per block
constexpr int MM_BM = 8;              // activation rows per block
constexpr int MM_THREADS = MM_TX * MM_TY;
static_assert(MM_BM * MM_BN == MM_THREADS, "one output per thread in the epilogue");

// One K-slice of one quant group g: packed rows [r0, r0 + rows) of the
// tensor whose K-row 0 is column 0 of x (row stride ldx), its 4 columns
// n0.. and 8 activation rows m0.., accumulated into acc in the factored
// form acc += s[g] * dot_g(x, q) - z[g] * sum_g(x).  Kernels 1 and 7.
template <int W, typename XT, typename MT>
__device__ __forceinline__ void accumulate_slice(
    const XT* __restrict__ x, int ldx, const int32_t* __restrict__ packed,
    const MT* __restrict__ scales, const MT* __restrict__ zeros, int M, int N, int m0,
    int n0, int g, int r0, int rows, float acc[MM_BM][4]) {
  constexpr int PPW = 32 / W;
  constexpr int JC = PPW < 8 ? PPW : 8;  // codes decoded per inner step
  constexpr uint32_t MASK = (1u << W) - 1u;
  float dot[MM_BM][4];
  float xs[MM_BM];
#pragma unroll
  for (int i = 0; i < MM_BM; ++i) {
    xs[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[i][c] = 0.f;
  }
  for (int r = r0; r < r0 + rows; ++r) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(packed + (size_t)r * N + n0));
    const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
#pragma unroll
    for (int jc = 0; jc < PPW; jc += JC) {
      float q[JC][4];
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          q[j][c] = (float)((w[c] >> ((jc + j) * W)) & MASK);
#pragma unroll
      for (int i = 0; i < MM_BM; ++i) {
        // rows past M recompute row M-1 and are never stored
        const int m = min(m0 + i, M - 1);
        float xv[JC];
        load_x<JC>(x + (size_t)m * ldx + (size_t)r * PPW + jc, xv);
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          xs[i] += xv[j];
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[i][c] = fmaf(xv[j], q[j][c], dot[i][c]);
        }
      }
    }
  }
  float s[4], z[4];
  load4(scales + (size_t)g * N + n0, s);
  load4(zeros + (size_t)g * N + n0, z);
#pragma unroll
  for (int i = 0; i < MM_BM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] += dot[i][c] * s[c] - xs[i] * z[c];
}

// The 32 K-slices' partial sums of the block's 8 x 32 outputs meet in
// shared memory; each thread sums one output and stores it.
template <typename OT>
__device__ __forceinline__ void reduce_store(float acc[MM_BM][4], float (*red)[MM_BM][MM_BN],
                                             OT* __restrict__ out, int M, int N, int m0) {
  const int tx = threadIdx.x % MM_TX;
  const int ty = threadIdx.x / MM_TX;
#pragma unroll
  for (int i = 0; i < MM_BM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][i][tx * 4 + c] = acc[i][c];
  __syncthreads();
  const int i = threadIdx.x / MM_BN;
  const int col = threadIdx.x % MM_BN;
  float sum = 0.f;
#pragma unroll 8
  for (int t = 0; t < MM_TY; ++t) sum += red[t][i][col];
  const int m = m0 + i;
  const int n = blockIdx.x * MM_BN + col;
  if (m < M && n < N) out[(size_t)m * N + n] = from_f32<OT>(sum);
}

template <int W, typename XT, typename MT, typename OT>
__global__ void __launch_bounds__(MM_THREADS)
mpq_matmul_kernel(const XT* __restrict__ x, const int32_t* __restrict__ packed,
                  const MT* __restrict__ scales, const MT* __restrict__ zeros,
                  OT* __restrict__ out, int M, int K, int N, int group_size,
                  int n_split) {
  constexpr int PPW = 32 / W;
  __shared__ float red[MM_TY][MM_BM][MM_BN];

  const int tx = threadIdx.x % MM_TX;
  const int ty = threadIdx.x / MM_TX;
  const int n0 = blockIdx.x * MM_BN + tx * 4;
  const int m0 = blockIdx.y * MM_BM;
  const int bkp = group_size / PPW;         // packed rows per group
  const int rows = bkp / n_split;           // packed rows per K-slice
  const int items = (K / group_size) * n_split;

  float acc[MM_BM][4];
#pragma unroll
  for (int i = 0; i < MM_BM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  if (n0 < N) {
    for (int it = ty; it < items; it += MM_TY) {
      const int g = it / n_split;
      accumulate_slice<W, XT, MT>(x, K, packed, scales, zeros, M, N, m0, n0, g,
                                  g * bkp + (it % n_split) * rows, rows, acc);
    }
  }
  reduce_store<OT>(acc, red, out, M, N, m0);
}

// Kernel 7's segment table: at most 8 segments (one per quantization
// width), passed by value as a kernel parameter.
constexpr int MBWQ_MAX_SEGS = 8;

struct MbwqSeg {
  const int32_t* packed;
  const void* scales;
  const void* zeros;
  int k_off;   // first column of x that the segment's rows read
  int w_bit;
  int bkp;     // packed rows per group
  int item0;   // first work item (group slice) of the segment
};

struct MbwqArgs {
  MbwqSeg seg[MBWQ_MAX_SEGS];
  int n_seg;
  int items;
  int n_split;
};

// Kernel 7: the K-slices of one launch walk the quant groups of every
// segment in turn (segment after segment), each with its own width, group
// size and metadata, into one accumulator per output.
template <typename XT, typename MT, typename OT>
__global__ void __launch_bounds__(MM_THREADS)
mbwq_matmul_kernel(const XT* __restrict__ x, OT* __restrict__ out, int M, int K, int N,
                   const MbwqArgs args) {
  __shared__ float red[MM_TY][MM_BM][MM_BN];

  const int tx = threadIdx.x % MM_TX;
  const int ty = threadIdx.x / MM_TX;
  const int n0 = blockIdx.x * MM_BN + tx * 4;
  const int m0 = blockIdx.y * MM_BM;

  float acc[MM_BM][4];
#pragma unroll
  for (int i = 0; i < MM_BM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  if (n0 < N) {
    int si = 0;
    for (int it = ty; it < args.items; it += MM_TY) {
      while (si + 1 < args.n_seg && it >= args.seg[si + 1].item0) ++si;
      const MbwqSeg sg = args.seg[si];
      const int local = it - sg.item0;
      const int g = local / args.n_split;
      const int rows = sg.bkp / args.n_split;
      const int r0 = g * sg.bkp + (local % args.n_split) * rows;
      const XT* xs = x + sg.k_off;
      const MT* s = static_cast<const MT*>(sg.scales);
      const MT* z = static_cast<const MT*>(sg.zeros);
      switch (sg.w_bit) {
        case 1: accumulate_slice<1, XT, MT>(xs, K, sg.packed, s, z, M, N, m0, n0, g, r0, rows, acc); break;
        case 2: accumulate_slice<2, XT, MT>(xs, K, sg.packed, s, z, M, N, m0, n0, g, r0, rows, acc); break;
        case 4: accumulate_slice<4, XT, MT>(xs, K, sg.packed, s, z, M, N, m0, n0, g, r0, rows, acc); break;
        default: accumulate_slice<8, XT, MT>(xs, K, sg.packed, s, z, M, N, m0, n0, g, r0, rows, acc); break;
      }
    }
  }
  reduce_store<OT>(acc, red, out, M, N, m0);
}

// Kernel 2's zero forms, chosen by the wrapper (ops/cuda/dequant_matmul.py
// ZERO_FORMS): kSym the stored float zeros, w = fma(q, s, -z); kAsymKernel
// the packed integer zeros of an asym tensor in the kernel form,
// z' = (s · z) rounded to the scales' dtype, w = fma(q, s, -z');
// kAsymExact the same zeros as s · (q - z), one f32 rounding.
enum ZeroForm { kSym = 0, kAsymKernel = 1, kAsymExact = 2 };

// Kernel 2's thread shape.  The port's build defines none of these; a
// measurement builds variants of this source with -D (chip_smoke.py
// --kernel2-ab, PERF.md §6 row 2): DQ_RPT packed rows and DQ_CPT columns
// (4 or 8) a thread, and DQ_TMA_STORE=1 the block's tile staged in shared
// memory and written by TMA bulk stores, one a logical row.
#ifndef DQ_RPT
#define DQ_RPT 1
#endif
#ifndef DQ_CPT
#define DQ_CPT 4
#endif
#ifndef DQ_TMA_STORE
#define DQ_TMA_STORE 0
#endif
static_assert(DQ_CPT == 4 || DQ_CPT == 8, "4 or 8 columns a thread");

constexpr int DQ_TC = 64;                                  // threads side by side in a tile row
constexpr int DQ_THREADS = 256;
constexpr int DQ_TILE_COLS = DQ_TC * DQ_CPT;               // a tile: 256 columns
constexpr int DQ_TILE_ROWS = DQ_THREADS / DQ_TC * DQ_RPT;  // x 4 packed rows
constexpr int DQ_MIN_BLOCKS = DQ_RPT * DQ_CPT > 4 ? 3 : 6; // at most 40 registers a thread (80)

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// DQ_CPT consecutive outputs: 8-byte (bf16) or 16-byte (f32) stores of 4,
// or one 16-byte store of 8 bf16.
__device__ __forceinline__ void store_cpt(float* p, const float v[DQ_CPT]) {
#pragma unroll
  for (int c = 0; c < DQ_CPT; c += 4) store4(p + c, v + c);
}
__device__ __forceinline__ void store_cpt(bf16* p, const float v[DQ_CPT]) {
  if (DQ_CPT == 8) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    store4(p, v);
  }
}

// What a column's weights subtract, from its scale s and its zero (the
// stored float zero, or the integer zero as f32): the kernel form rounds
// s · z to the scales' dtype first, as prepare_for_kernel stores it.
template <int ZF, typename MT>
__device__ __forceinline__ float zero_of(float s, float zero) {
  return ZF == kAsymKernel ? round_to<MT>(__fmul_rn(s, zero)) : zero;
}

// One weight: q · s - z rounded once (XLA's fused multiply-add), or
// s · (q - z) with q - z exact in f32 (codes and zeros are below 2^9).
template <int ZF>
__device__ __forceinline__ float dq(float q, float s, float z) {
  return ZF == kAsymExact ? __fmul_rn(s, q - z) : __fmaf_rn(q, s, -z);
}

// Group g's scales and subtrahends at columns n0.. (the first ``cols``);
// asym zeros are packed along N (PPW a word, the stored value one below
// the zero), and n0 is a multiple of DQ_CPT, so a thread's zeros lie in
// one word (PPW >= DQ_CPT) or in whole words.
template <int W, typename MT, int ZF, bool VEC>
__device__ __forceinline__ void load_meta(const MT* __restrict__ scales, const void* __restrict__ zeros,
                                          int N, int g, int n0, int cols, float s[DQ_CPT],
                                          float z[DQ_CPT]) {
  constexpr int PPW = 32 / W;
  const MT* srow = scales + (size_t)g * N + n0;
  const MT* zrow = static_cast<const MT*>(zeros) + (size_t)g * N + n0;
  if (VEC) {
#pragma unroll
    for (int c = 0; c < DQ_CPT; c += 4) {
      load4(srow + c, s + c);
      if (ZF == kSym) load4(zrow + c, z + c);
    }
  } else {
#pragma unroll
    for (int c = 0; c < DQ_CPT; ++c) {
      s[c] = c < cols ? load1(srow + c) : 0.f;
      z[c] = ZF == kSym && c < cols ? load1(zrow + c) : 0.f;
    }
  }
  if (ZF != kSym) {
    const uint32_t* words = static_cast<const uint32_t*>(zeros) + (size_t)g * (N / PPW);
#pragma unroll
    for (int c = 0; c < DQ_CPT; ++c) {
      if (!VEC && c >= cols) continue;
      const uint32_t zw = __ldg(words + n0 / PPW + c / PPW);
      const uint32_t zq = (zw >> (((n0 + c) % PPW) * W)) & ((1u << W) - 1u);
      z[c] = zero_of<ZF, MT>(s[c], (float)(zq + 1u));
    }
  }
}

// One thread's share of kernel 2: packed rows r0.. (DQ_RPT of them, those
// below K / PPW) at columns n0.. (n0 < N).  On the vector path (VEC: N a
// multiple of DQ_CPT, every pointer 16-byte aligned) its code words come
// in DQ_RPT * DQ_CPT / 4 16-byte loads, all issued before the first
// unpack; without VEC a column at a time.  Each logical (stored) row it
// reconstructs goes to put(row, values).
template <int W, typename MT, int ZF, bool VEC, typename Put>
__device__ __forceinline__ void dequant_thread(const int32_t* __restrict__ packed,
                                               const MT* __restrict__ scales,
                                               const void* __restrict__ zeros, int K, int N,
                                               int group_size, int r0, int n0, Put put) {
  constexpr int PPW = 32 / W;
  constexpr uint32_t MASK = (1u << W) - 1u;
  const int rows = min(DQ_RPT, K / PPW - r0);
  const int cols = VEC ? DQ_CPT : min(DQ_CPT, N - n0);
  uint32_t w[DQ_RPT][DQ_CPT];
#pragma unroll
  for (int i = 0; i < DQ_RPT; ++i) {
    if (i >= rows) break;
    const int32_t* p = packed + (size_t)(r0 + i) * N + n0;
#pragma unroll
    for (int c = 0; c < DQ_CPT; c += 4) {
      if (VEC) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p + c));
        w[i][c] = v.x; w[i][c + 1] = v.y; w[i][c + 2] = v.z; w[i][c + 3] = v.w;
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) w[i][c + d] = c + d < cols ? (uint32_t)__ldg(p + c + d) : 0u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DQ_RPT; ++i) {
    if (i >= rows) break;
    const int r = r0 + i;
    float s[DQ_CPT], z[DQ_CPT];
    // group_size % PPW == 0: one group a word
    load_meta<W, MT, ZF, VEC>(scales, zeros, N, r * PPW / group_size, n0, cols, s, z);
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      float o[DQ_CPT];
#pragma unroll
      for (int c = 0; c < DQ_CPT; ++c) o[c] = dq<ZF>((float)((w[i][c] >> (j * W)) & MASK), s[c], z[c]);
      put(r * PPW + j, o);
    }
  }
}

// The output row of stored row ``row``: row_map[row], or ``row`` without a
// map.  A map is checked to be a permutation of [0, K) where it enters the
// program (utils/convert.py); one out of range here stops the launch with
// an error instead of writing outside the weight.
__device__ __forceinline__ int out_row(const int32_t* __restrict__ row_map, int row, int K) {
  const int dst = row_map != nullptr ? __ldg(row_map + row) : row;
  if ((unsigned)dst >= (unsigned)K) __trap();
  return dst;
}

#if DQ_TMA_STORE
// The TMA variant's block: its tile's logical rows reconstructed into
// shared memory (DQ_TILE_ROWS * PPW rows x DQ_TILE_COLS, the launch's
// dynamic shared memory), one barrier, then one 1-D bulk copy
// (cp.async.bulk.global.shared::cta) a row to out + row_map[row] * N.
// Needs every row segment a multiple of 16 bytes: N * sizeof(OT) % 16 == 0.
template <int W, typename MT, typename OT, int ZF>
__device__ __forceinline__ void dequant_tile_tma(const int32_t* __restrict__ packed,
                                                 const MT* __restrict__ scales,
                                                 const void* __restrict__ zeros,
                                                 const int32_t* __restrict__ row_map,
                                                 OT* __restrict__ out, int K, int N,
                                                 int group_size, int r0, int n0) {
  constexpr int PPW = 32 / W;
  extern __shared__ __align__(128) unsigned char dq_smem[];
  OT* stage = reinterpret_cast<OT*>(dq_smem);
  const int row0 = blockIdx.y * DQ_TILE_ROWS * PPW;
  const int c0 = threadIdx.x % DQ_TC * DQ_CPT;
  if (n0 < N)
    dequant_thread<W, MT, ZF, true>(packed, scales, zeros, K, N, group_size, r0, n0,
                                    [&](int row, const float* o) {
                                      store_cpt(stage + (size_t)(row - row0) * DQ_TILE_COLS + c0, o);
                                    });
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int nb = blockIdx.x * DQ_TILE_COLS;
  const int bytes = min(DQ_TILE_COLS, N - nb) * (int)sizeof(OT);
  const int rows = min(DQ_TILE_ROWS * PPW, K - row0);
  for (int t = threadIdx.x; t < rows; t += DQ_THREADS) {
    OT* dst = out + (size_t)out_row(row_map, row0 + t, K) * N + nb;
    const uint32_t src = (uint32_t)__cvta_generic_to_shared(stage + (size_t)t * DQ_TILE_COLS);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
#endif

// Kernel 2: block (bx, by) takes the tile of column band bx (DQ_TILE_COLS
// columns) and packed rows by * DQ_TILE_ROWS..; thread (ty, tx) =
// divmod(threadIdx.x, DQ_TC) owns packed rows ty * DQ_RPT.. of the tile
// and its columns tx * DQ_CPT.., and stores each logical row's DQ_CPT
// outputs straight to row row_map[row].  No shared memory, no barrier.
template <int W, typename MT, typename OT, int ZF, bool VEC>
__global__ void __launch_bounds__(DQ_THREADS, DQ_MIN_BLOCKS)
dequant_kernel(const int32_t* __restrict__ packed, const MT* __restrict__ scales,
               const void* __restrict__ zeros, const int32_t* __restrict__ row_map,
               OT* __restrict__ out, int K, int N, int group_size) {
  const int n0 = (blockIdx.x * DQ_TC + threadIdx.x % DQ_TC) * DQ_CPT;
  const int r0 = blockIdx.y * DQ_TILE_ROWS + threadIdx.x / DQ_TC * DQ_RPT;
#if DQ_TMA_STORE
  if (VEC && N * sizeof(OT) % 16 == 0) {
    dequant_tile_tma<W, MT, OT, ZF>(packed, scales, zeros, row_map, out, K, N, group_size, r0, n0);
    return;
  }
#endif
  if (n0 >= N || r0 >= K / (32 / W)) return;
  dequant_thread<W, MT, ZF, VEC>(packed, scales, zeros, K, N, group_size, r0, n0,
                                 [&](int row, const float* o) {
                                   OT* dp = out + (size_t)out_row(row_map, row, K) * N + n0;
                                   if (VEC) {
                                     store_cpt(dp, o);
                                   } else {
#pragma unroll
                                     for (int c = 0; c < DQ_CPT; ++c)
                                       if (n0 + c < N) dp[c] = from_f32<OT>(o[c]);
                                   }
                                 });
}

template <int W, typename XT, typename MT, typename OT>
cudaError_t launch_mpq(const void* x, const void* packed, const void* scales,
                       const void* zeros, void* out, int M, int K, int N,
                       int group_size, cudaStream_t stream) {
  constexpr int PPW = 32 / W;
  const int groups = K / group_size;
  const int bkp = group_size / PPW;
  // split a group across slices when there are fewer groups than slices
  int n_split = 1;
  while (groups * n_split < MM_TY && bkp % (n_split * 2) == 0) n_split *= 2;
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  mpq_matmul_kernel<W, XT, MT, OT><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int32_t*>(packed),
      static_cast<const MT*>(scales), static_cast<const MT*>(zeros),
      static_cast<OT*>(out), M, K, N, group_size, n_split);
  return cudaGetLastError();
}

template <int W, typename XT, typename MT>
cudaError_t mpq_by_out(int out_dtype, const void* x, const void* p, const void* s,
                       const void* z, void* o, int M, int K, int N, int gs,
                       cudaStream_t st) {
  if (out_dtype == kF32) return launch_mpq<W, XT, MT, float>(x, p, s, z, o, M, K, N, gs, st);
  return launch_mpq<W, XT, MT, bf16>(x, p, s, z, o, M, K, N, gs, st);
}

template <int W, typename XT>
cudaError_t mpq_by_meta(int meta_dtype, int out_dtype, const void* x, const void* p,
                        const void* s, const void* z, void* o, int M, int K, int N,
                        int gs, cudaStream_t st) {
  if (meta_dtype == kF32) return mpq_by_out<W, XT, float>(out_dtype, x, p, s, z, o, M, K, N, gs, st);
  return mpq_by_out<W, XT, bf16>(out_dtype, x, p, s, z, o, M, K, N, gs, st);
}

template <int W>
cudaError_t mpq_by_x(int x_dtype, int meta_dtype, int out_dtype, const void* x,
                     const void* p, const void* s, const void* z, void* o, int M,
                     int K, int N, int gs, cudaStream_t st) {
  if (x_dtype == kF32) return mpq_by_meta<W, float>(meta_dtype, out_dtype, x, p, s, z, o, M, K, N, gs, st);
  return mpq_by_meta<W, bf16>(meta_dtype, out_dtype, x, p, s, z, o, M, K, N, gs, st);
}

template <int W, typename MT, typename OT, int ZF>
const void* dequant_by_vec(int vec) {
  return vec ? reinterpret_cast<const void*>(&dequant_kernel<W, MT, OT, ZF, true>)
             : reinterpret_cast<const void*>(&dequant_kernel<W, MT, OT, ZF, false>);
}

template <int W, typename MT, typename OT>
const void* dequant_by_form(int form, int vec) {
  switch (form) {
    case kSym: return dequant_by_vec<W, MT, OT, kSym>(vec);
    case kAsymKernel: return dequant_by_vec<W, MT, OT, kAsymKernel>(vec);
    case kAsymExact: return dequant_by_vec<W, MT, OT, kAsymExact>(vec);
    default: return nullptr;
  }
}

template <int W>
const void* dequant_by_dtype(int meta_dtype, int out_dtype, int form, int vec) {
  if (meta_dtype == kF32) {
    if (out_dtype == kF32) return dequant_by_form<W, float, float>(form, vec);
    return dequant_by_form<W, float, bf16>(form, vec);
  }
  if (out_dtype == kF32) return dequant_by_form<W, bf16, float>(form, vec);
  return dequant_by_form<W, bf16, bf16>(form, vec);
}

// Kernel 2's instantiation for a width, the two dtypes, a zero form and
// the vector path or not.
const void* dequant_fn(int w_bit, int meta_dtype, int out_dtype, int form, int vec) {
  switch (w_bit) {
    case 1: return dequant_by_dtype<1>(meta_dtype, out_dtype, form, vec);
    case 2: return dequant_by_dtype<2>(meta_dtype, out_dtype, form, vec);
    case 4: return dequant_by_dtype<4>(meta_dtype, out_dtype, form, vec);
    case 8: return dequant_by_dtype<8>(meta_dtype, out_dtype, form, vec);
    default: return nullptr;
  }
}

template <typename XT, typename MT, typename OT>
cudaError_t launch_mbwq(const void* x, void* out, int M, int K, int N, const MbwqArgs& args,
                        cudaStream_t stream) {
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  mbwq_matmul_kernel<XT, MT, OT><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<OT*>(out), M, K, N, args);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t mbwq_by_meta(int meta_dtype, int out_dtype, const void* x, void* o, int M, int K,
                         int N, const MbwqArgs& a, cudaStream_t st) {
  if (meta_dtype == kF32) {
    if (out_dtype == kF32) return launch_mbwq<XT, float, float>(x, o, M, K, N, a, st);
    return launch_mbwq<XT, float, bf16>(x, o, M, K, N, a, st);
  }
  if (out_dtype == kF32) return launch_mbwq<XT, bf16, float>(x, o, M, K, N, a, st);
  return launch_mbwq<XT, bf16, bf16>(x, o, M, K, N, a, st);
}

}  // namespace

// Shapes, dtypes, alignment and contiguity are checked by the Python
// wrapper (ops/cuda/dequant_matmul.py).  Each entry point returns the
// launch's cudaGetLastError().
extern "C" int bte_mpq_matmul(const void* x, const void* packed, const void* scales,
                              const void* zeros, void* out, int M, int K, int N,
                              int w_bit, int group_size, int x_dtype, int meta_dtype,
                              int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_bit) {
    case 1: return mpq_by_x<1>(x_dtype, meta_dtype, out_dtype, x, packed, scales, zeros, out, M, K, N, group_size, st);
    case 2: return mpq_by_x<2>(x_dtype, meta_dtype, out_dtype, x, packed, scales, zeros, out, M, K, N, group_size, st);
    case 4: return mpq_by_x<4>(x_dtype, meta_dtype, out_dtype, x, packed, scales, zeros, out, M, K, N, group_size, st);
    case 8: return mpq_by_x<8>(x_dtype, meta_dtype, out_dtype, x, packed, scales, zeros, out, M, K, N, group_size, st);
    default: return cudaErrorInvalidValue;
  }
}

// Kernel 2: one block a tile of DQ_TILE_ROWS packed rows x DQ_TILE_COLS
// columns; ``row_map`` (int32, K) or null; ``aligned``: every pointer
// 16-byte aligned, which with N a multiple of DQ_CPT takes the vector path.
extern "C" int bte_dequant(const void* packed, const void* scales, const void* zeros,
                           const void* row_map, void* out, int K, int N, int w_bit,
                           int group_size, int meta_dtype, int out_dtype, int form, int aligned,
                           void* stream) {
  const void* fn = dequant_fn(w_bit, meta_dtype, out_dtype, form, aligned && N % DQ_CPT == 0);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((N + DQ_TILE_COLS - 1) / DQ_TILE_COLS,
                  (K / (32 / w_bit) + DQ_TILE_ROWS - 1) / DQ_TILE_ROWS);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  size_t smem = 0;
#if DQ_TMA_STORE
  smem = (size_t)DQ_TILE_ROWS * (32 / w_bit) * DQ_TILE_COLS * (out_dtype == kF32 ? 4 : 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
#endif
  void* args[] = {&packed, &scales, &zeros, &row_map, &out, &K, &N, &group_size};
  const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(DQ_THREADS), args, smem,
                                           static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Kernel 7 over n_seg segments (host arrays of per-segment pointers, widths,
// group sizes and row counts, in the order of x's columns).
extern "C" int bte_mbwq_matmul(const void* x, int n_seg, const void* const* packed,
                               const void* const* scales, const void* const* zeros,
                               const int* w_bits, const int* group_sizes, const int* k_segs,
                               void* out, int M, int K, int N, int x_dtype, int meta_dtype,
                               int out_dtype, void* stream) {
  if (n_seg < 1 || n_seg > MBWQ_MAX_SEGS) return cudaErrorInvalidValue;
  MbwqArgs a = {};
  int groups = 0, k_off = 0;
  for (int i = 0; i < n_seg; ++i) {
    const int w = w_bits[i];
    if (w != 1 && w != 2 && w != 4 && w != 8) return cudaErrorInvalidValue;
    a.seg[i].packed = static_cast<const int32_t*>(packed[i]);
    a.seg[i].scales = scales[i];
    a.seg[i].zeros = zeros[i];
    a.seg[i].k_off = k_off;
    a.seg[i].w_bit = w;
    a.seg[i].bkp = group_sizes[i] / (32 / w);
    groups += k_segs[i] / group_sizes[i];
    k_off += k_segs[i];
  }
  if (k_off != K) return cudaErrorInvalidValue;
  // split groups across slices when there are fewer groups than slices
  int n_split = 1;
  for (;;) {
    bool even = groups * n_split < MM_TY;
    for (int i = 0; i < n_seg && even; ++i) even = a.seg[i].bkp % (n_split * 2) == 0;
    if (!even) break;
    n_split *= 2;
  }
  int item = 0;
  for (int i = 0; i < n_seg; ++i) {
    a.seg[i].item0 = item;
    item += k_segs[i] / group_sizes[i] * n_split;
  }
  a.n_seg = n_seg;
  a.items = item;
  a.n_split = n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return mbwq_by_meta<float>(meta_dtype, out_dtype, x, out, M, K, N, a, st);
  return mbwq_by_meta<bf16>(meta_dtype, out_dtype, x, out, M, K, N, a, st);
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
