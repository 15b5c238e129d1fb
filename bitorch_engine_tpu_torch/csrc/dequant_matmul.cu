// MPQ weight-only linear kernels for Hopper (sm_90a), gptq row order.
//
// Packed codes: int32 (K / ppw, N), ppw = 32 / w_bit; value j of word r is
// logical row r * ppw + j, LSB first.  Group metadata: scales / zeros
// (K / group_size, N), float32 or bfloat16; the weight is w = q * s - z
// (the symmetric form; asymmetric tensors are rewritten to it beforehand).
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
// bte_dequant -- replaces dequant_matmul.py:_dequant_kernel, the streaming
//   reconstruct of the (K, N) weight for the m > 512 regime.
//   Bound: bytes (read the packed words and metadata once, write K * N
//   outputs once); one thread per packed word quad, coalesced 16-byte reads
//   and 8-byte writes.  Bit-exact with the plain version and with the JAX
//   package's jitted dequantize: w = q * s - z is rounded once, as one
//   fused multiply-add (__fmaf_rn), which is what XLA's contraction of
//   that expression computes.

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

constexpr int DQ_TX = 64;  // column quads per block
constexpr int DQ_TY = 4;   // packed rows per block

template <int W, typename MT, typename OT>
__global__ void __launch_bounds__(DQ_TX * DQ_TY)
dequant_kernel(const int32_t* __restrict__ packed, const MT* __restrict__ scales,
               const MT* __restrict__ zeros, OT* __restrict__ out, int K, int N,
               int group_size) {
  constexpr int PPW = 32 / W;
  constexpr uint32_t MASK = (1u << W) - 1u;
  const int n0 = (blockIdx.x * DQ_TX + threadIdx.x % DQ_TX) * 4;
  const int r = blockIdx.y * DQ_TY + threadIdx.x / DQ_TX;
  if (n0 >= N || r >= K / PPW) return;
  const int4 wv = __ldg(reinterpret_cast<const int4*>(packed + (size_t)r * N + n0));
  const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
  const int g = r * PPW / group_size;  // group_size % PPW == 0: one group per word
  float s[4], z[4];
  load4(scales + (size_t)g * N + n0, s);
  load4(zeros + (size_t)g * N + n0, z);
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float q = (float)((w[c] >> (j * W)) & MASK);
      o[c] = __fmaf_rn(q, s[c], -z[c]);
    }
    store4(out + ((size_t)r * PPW + j) * N + n0, o);
  }
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

template <int W, typename MT, typename OT>
cudaError_t launch_dequant(const void* packed, const void* scales, const void* zeros,
                           void* out, int K, int N, int group_size, cudaStream_t stream) {
  constexpr int PPW = 32 / W;
  dim3 grid((N / 4 + DQ_TX - 1) / DQ_TX, (K / PPW + DQ_TY - 1) / DQ_TY);
  dequant_kernel<W, MT, OT><<<grid, DQ_TX * DQ_TY, 0, stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const MT*>(scales),
      static_cast<const MT*>(zeros), static_cast<OT*>(out), K, N, group_size);
  return cudaGetLastError();
}

template <int W>
cudaError_t dequant_by_dtype(int meta_dtype, int out_dtype, const void* p, const void* s,
                             const void* z, void* o, int K, int N, int gs, cudaStream_t st) {
  if (meta_dtype == kF32) {
    if (out_dtype == kF32) return launch_dequant<W, float, float>(p, s, z, o, K, N, gs, st);
    return launch_dequant<W, float, bf16>(p, s, z, o, K, N, gs, st);
  }
  if (out_dtype == kF32) return launch_dequant<W, bf16, float>(p, s, z, o, K, N, gs, st);
  return launch_dequant<W, bf16, bf16>(p, s, z, o, K, N, gs, st);
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

extern "C" int bte_dequant(const void* packed, const void* scales, const void* zeros,
                           void* out, int K, int N, int w_bit, int group_size,
                           int meta_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_bit) {
    case 1: return dequant_by_dtype<1>(meta_dtype, out_dtype, packed, scales, zeros, out, K, N, group_size, st);
    case 2: return dequant_by_dtype<2>(meta_dtype, out_dtype, packed, scales, zeros, out, K, N, group_size, st);
    case 4: return dequant_by_dtype<4>(meta_dtype, out_dtype, packed, scales, zeros, out, K, N, group_size, st);
    case 8: return dequant_by_dtype<8>(meta_dtype, out_dtype, packed, scales, zeros, out, K, N, group_size, st);
    default: return cudaErrorInvalidValue;
  }
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
