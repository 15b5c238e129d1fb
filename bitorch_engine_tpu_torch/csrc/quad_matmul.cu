// The A8 weight-only linear kernel for Hopper (sm_90a): per-token int8
// activations against 1/2/4-bit codes, exact integer dots.
//
// bte_quad_matmul -- replaces bitorch_engine_tpu/ops/pallas/dequant_matmul.py
//   :_mpq_kernel, its tpu_quad branch (_accumulate_k_step :292-320,
//   _unpack_kstep_quad_tiles :193, _quad_group :226; entry
//   mpq_matmul_pallas :738-764).  Two launches on one stream:
//
//   1. quantize_rows_kernel: per row m, sx = max(max|x| * f32(1/127), 1e-12)
//      (the multiply by the rounded reciprocal into which XLA folds the JAX
//      package's jitted max|x| / 127.0), qx = round_half_even(x / sx), a
//      true division, as int8; the JAX package computes the same in XLA
//      outside its kernel.  The codes are written in the kernel's dot order
//      (below).  A row holding a NaN gets sx = NaN, so a poisoned
//      activation stays poisoned.
//   2. quad_matmul_kernel: for each quant group g of each output column n,
//      the exact int32 dot d = sum_k qx[m,k] q[k,n] and xs = sum_k qx[m,k];
//      then acc += d * s[g,n] - xs * z[g,n] in f32, or, for tensors whose
//      zeros are exactly mid * scales (zeros_mid), acc += (d - mid * xs) *
//      s[g,n] (the subtraction in int32, exact, before the scale; the zeros
//      are never read).  The output is acc * sx[m] cast to the output type,
//      or, when sx is not given, the f32 accumulator itself.
//
// Packed codes: int32 (K / ppw, N) in the checkpoint ("gptq") order, ppw =
// 32 / w_bit; value j of word r is row r * ppw + j at bits j * w_bit.  With
// S = 8 / w_bit, (word >> t * w_bit) & (mask * 0x01010101) leaves in byte b
// the code of row r * ppw + b * S + t (b = 0..3): four codes S rows apart,
// not four consecutive rows.  So quantize_rows_kernel stores qx[m, r * ppw
// + b * S + t] at byte r * ppw + 4 * t + b: the four bytes of activation
// word t then line up with the four bytes of the shifted code word, and one
// dp4a.s32.u32 (signed activations, unsigned codes) adds their products.
//
// Bound on the H100: at the decode batch (m = 8) the kernel must read the
// packed words and the metadata once (2.25 bits per weight with bf16
// metadata at w2 g128) and does 2 * m integer operations per weight, far
// below the int8 tensor cores' 1979 TOP/s over 3.35 TB/s: memory bound.
//
// Two bodies for step 2, the route picked by the wrapper from the shape
// (ops/cuda/quad_matmul.py quad_route): quad_mma_kernel where the group's
// packed rows tile into chunks (chunk_words: every group size from 32 codes
// up), else quad_matmul_kernel.
//
// quad_matmul_kernel (the first body): kernel 1's first block structure.
// Each block owns 32 output columns and 8 activation rows; its 256 threads
// are 8 column quads (one coalesced 16-byte load of packed words per packed
// row) x 32 K-slices, each slice a whole quant group (or an equal part of
// one when there are fewer than 32 groups); per packed row a thread reads
// the row's S activation words of each of its 8 rows with one load and
// issues 4 * S dp4a for the dots and S for the sums.  The slices' f32 sums
// meet in shared memory.  CUDA-core dp4a: 160 dp4a a thread per 16 bytes of
// w2 codes at m 8, and few bytes in flight (3.7 ms per A8 step of
// Llama-2-7B MBWQ-2.5 on the H100 against a 0.42 ms bound).
//
// quad_mma_kernel: the products on the int8 tensor cores,
// mma.sync.m16n8k32.row.col.s32.u8.s8.s32 with the weight as A (16 output
// columns x 32 k of u8 codes) and the activations as B (32 k x 8 rows of
// s8), int32 accumulators: exact, and |d| <= 127 * 15 * 128 per group piece
// never overflows.  Sum(x) per row is one more MMA per slab with an all-ones
// A.  The launch structure is kernel 7's (csrc/mbwq_matmul.cu): a block
// owns 32 columns and 8 rows (16 to m 16, else 32) with 8 warps; the K
// chunks are cut into 8 equal runs, one per warp, each streamed through the
// warp's own 3-stage cp.async ring; at the chunk that ends a group piece
// the lane applies the present kernel's terms, acc += d * s - xs * z (or
// (d - mid * xs) * s) in f32, and the warps' f32 partials meet in shared
// memory, summed in warp order (no atomics: reruns bit-equal).  A group
// split between two warps is applied as two pieces; with bf16 metadata
// every term is exact in f32.  On the H100 a launch is mostly fixed cost
// (a 2048 x 512 call takes ~10 us, the 3.5 MB o projection ~12), so the
// matmul grid is the quantization grid's programmatic dependent: its first
// chunks' words are copied while the codes are made.  What the card
// measured against: 64 or 128 columns a block (fewer re-reads of the
// activations, but too few blocks at N = 4096), 16 warps a block, and
// quantizing in every block (one launch, but the division of each
// activation repeated N / 32 times) were slower; prefetching the rest of
// each run's words to L2 before the wait bought nothing.
//
// The k order inside an MMA.  mma.m16n8k32 (8-bit) gives lane (g = lane /
// 4, t = lane % 4) the A bytes of rows g (registers a0, a2) and g + 8 (a1,
// a3) at k = 4t .. 4t + 3 (a0, a1) and 16 + 4t .. 16 + 4t + 3 (a2, a3), and
// B register b0 (b1) the bytes of column g at the same k as a0 (a2); D gives
// it rows g, g + 8 at columns 2t, 2t + 1.  The sum runs over k, so any
// permutation of k applied to A and B alike gives the same integers.  Here
// each 4-byte k group is one (packed row, shift) pair: (word >> u * W) &
// (mask * 0x01010101) holds the codes the activation word at byte
// r * PPW + 4u of qx (the dot order above) pairs with.  A chunk is C packed
// rows of every column (C in 1, 2, 4, C >= W), C * S shift groups, NS = C *
// S / 8 slabs; lane t takes packed row widx = t / (4 / C) and, in slab j,
// shift u0 = sb + 2j for its low k group and u0 + 1 for its high one, sb =
// (t % (4 / C)) * 2 * NS.  So its A registers are shifted, masked words (no
// conversion) and b0 / b1 are the 8 activation bytes at r * PPW + 4 u0 of
// its row: a lane reads 8 * NS contiguous bytes a chunk and n8 tile.
//   w2, C = 4 (S 4, NS 2): lane t owns packed row t of the chunk, its 16
//     codes; slab 0 takes shifts 0 (low) and 1 (high), slab 1 shifts 2, 3;
//     its activation bytes are qx[r * 16 .. r * 16 + 15] of row g.
//   w2, C = 2 (groups of 32 codes): lanes 2i and 2i + 1 share packed row i,
//     lane 2i takes shifts 0, 1 and lane 2i + 1 shifts 2, 3 (one slab).
//   w4, C = 4 (S 2, NS 1): lane t, packed row t, shifts 0 and 1.
//   w1, C = 4 (S 8, NS 4): lane t, packed row t, slab j shifts 2j, 2j + 1.
// Columns: lane g loads the words of columns 4g .. 4g + 3 (16 bytes); A
// rows g / g + 8 of n16 tile h are columns 4g + 2h / 4g + 2h + 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Four consecutive metadata values (16-byte aligned for f32, 8-byte for bf16).
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

// sum over the four byte lanes of (signed a) * (unsigned b), plus c
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The S activation words of one packed row (4 * S bytes, aligned to them).
template <int S> __device__ __forceinline__ void load_act(const int8_t* p, uint32_t a[S]);
template <> __device__ __forceinline__ void load_act<2>(const int8_t* p, uint32_t a[2]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  a[0] = v.x; a[1] = v.y;
}
template <> __device__ __forceinline__ void load_act<4>(const int8_t* p, uint32_t a[4]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
template <> __device__ __forceinline__ void load_act<8>(const int8_t* p, uint32_t a[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  a[4] = u.x; a[5] = u.y; a[6] = u.z; a[7] = u.w;
}

// Programmatic dependent launch: the matmul grid may start while the
// quantization grid runs (launch_dependents, early in the quantization);
// griddep_wait() returns once that grid has finished and its writes are
// visible (at once for a grid launched without the attribute).
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

constexpr int QA_THREADS = 256;

// The N values at p (N * sizeof(T) bytes, a multiple of 16 and aligned to
// 16) as f32, with 16-byte loads.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float v[N]) {
  constexpr int VEC = 16 / (int)sizeof(T);  // values a 16-byte load
#pragma unroll
  for (int i = 0; i < N / VEC; ++i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if constexpr (sizeof(T) == 4) v[i * VEC + e] = __uint_as_float(w[e]);
      else v[i * VEC + e] = __uint_as_float(e % 2 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16);
    }
  }
}

// One block per row.  Each thread step takes one packed row's PPW values
// (16-byte loads): pass 1 their max |x| (and NaN), pass 2 their codes, put in
// the dot order in registers and stored as PPW bytes at once.
template <int W, typename XT>
__global__ void __launch_bounds__(QA_THREADS)
quantize_rows_kernel(const XT* __restrict__ x, int8_t* __restrict__ qx,
                     float* __restrict__ sx, int K) {
  constexpr int PPW = 32 / W;
  constexpr int S = 8 / W;
  __shared__ float red[QA_THREADS / 32];
  __shared__ int has_nan;
  griddep_launch_dependents();  // the matmul grid may start its weight loads now
  const XT* xr = x + (size_t)blockIdx.x * K;
  const int rows = K / PPW;
  if (threadIdx.x == 0) has_nan = 0;
  __syncthreads();
  float amax = 0.f;
  bool nan = false;
  for (int r = threadIdx.x; r < rows; r += QA_THREADS) {
    float v[PPW];
    load_vals<XT, PPW>(xr + (size_t)r * PPW, v);
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      nan |= (v[j] != v[j]);
      amax = fmaxf(amax, fabsf(v[j]));
    }
  }
  if (nan) has_nan = 1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < QA_THREADS / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) {
      const float s = fmaxf(v * (1.0f / 127.0f), 1e-12f);
      red[0] = has_nan ? __int_as_float(0x7fc00000) : s;
    }
  }
  __syncthreads();
  const float s = red[0];
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* qr = qx + (size_t)blockIdx.x * K;
  for (int r = threadIdx.x; r < rows; r += QA_THREADS) {
    float v[PPW];
    load_vals<XT, PPW>(xr + (size_t)r * PPW, v);
    uint32_t out[PPW / 4];
#pragma unroll
    for (int i = 0; i < PPW / 4; ++i) out[i] = 0;
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      const float q = rintf(v[j] / s);  // a true division, as the reference's
      const uint32_t c = (q == q) ? (uint32_t)(uint8_t)(int8_t)(int)q : 0u;
      const int at = 4 * (j % S) + j / S;  // code j of the packed row, in the dot order
      out[at / 4] |= c << (8 * (at % 4));
    }
    if constexpr (PPW == 8) {
      *reinterpret_cast<uint2*>(qr + (size_t)r * PPW) = make_uint2(out[0], out[1]);
    } else {
#pragma unroll
      for (int i = 0; i < PPW / 16; ++i)
        *reinterpret_cast<uint4*>(qr + (size_t)r * PPW + 16 * i) =
            make_uint4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
    }
  }
}

template <int W>
cudaError_t quantize_rows(int x_dtype, const void* x, int8_t* qx, float* sx, int M, int K,
                          cudaStream_t st) {
  if (x_dtype == kF32)
    quantize_rows_kernel<W, float><<<M, QA_THREADS, 0, st>>>(static_cast<const float*>(x), qx, sx, K);
  else
    quantize_rows_kernel<W, bf16><<<M, QA_THREADS, 0, st>>>(static_cast<const bf16*>(x), qx, sx, K);
  return cudaGetLastError();
}

constexpr int MM_TX = 8;              // column quads per block
constexpr int MM_TY = 32;             // K-slices per block
constexpr int MM_BN = MM_TX * 4;      // output columns per block
constexpr int MM_BM = 8;              // activation rows per block
constexpr int MM_THREADS = MM_TX * MM_TY;
static_assert(MM_BM * MM_BN == MM_THREADS, "one output per thread in the epilogue");

template <int W, typename MT, typename OT, bool MID>
__global__ void __launch_bounds__(MM_THREADS)
quad_matmul_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                   const int32_t* __restrict__ packed, const MT* __restrict__ scales,
                   const MT* __restrict__ zeros, OT* __restrict__ out, int M, int K,
                   int N, int group_size, int n_split, int mid) {
  constexpr int PPW = 32 / W;
  constexpr int S = 8 / W;
  constexpr uint32_t MASK = ((1u << W) - 1u) * 0x01010101u;
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
      const int r0 = g * bkp + (it % n_split) * rows;
      int dot[MM_BM][4];
      int xs[MM_BM];
#pragma unroll
      for (int i = 0; i < MM_BM; ++i) {
        xs[i] = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[i][c] = 0;
      }
      for (int r = r0; r < r0 + rows; ++r) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(packed + (size_t)r * N + n0));
        const uint32_t w[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z, (uint32_t)wv.w};
#pragma unroll
        for (int i = 0; i < MM_BM; ++i) {
          // rows past M recompute row M-1 and are never stored
          const int m = min(m0 + i, M - 1);
          uint32_t a[S];
          load_act<S>(qx + (size_t)m * K + (size_t)r * PPW, a);
#pragma unroll
          for (int t = 0; t < S; ++t) {
            xs[i] = dp4a_su(a[t], 0x01010101u, xs[i]);
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[i][c] = dp4a_su(a[t], (w[c] >> (t * W)) & MASK, dot[i][c]);
          }
        }
      }
      float s[4], z[4];
      load4(scales + (size_t)g * N + n0, s);
      if (!MID) load4(zeros + (size_t)g * N + n0, z);
#pragma unroll
      for (int i = 0; i < MM_BM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (MID) acc[i][c] += (float)(dot[i][c] - mid * xs[i]) * s[c];
          else acc[i][c] += (float)dot[i][c] * s[c] - (float)xs[i] * z[c];
        }
    }
  }

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
  if (m < M && n < N) {
    if (sx != nullptr) sum *= sx[m];
    out[(size_t)m * N + n] = from_f32<OT>(sum);
  }
}

// ---------------------------------------------------------------------------
// quad_mma_kernel: the same function on the int8 tensor cores.

constexpr int QM_DEPTH = 3;  // ring stages a warp: two chunks in flight beside the one in use

// The f32 value of 4 consecutive metadata values at unit u (f32 or bf16).
__device__ __forceinline__ void read_meta(uint4* stage, int u, int lane, bool f32, float o[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(unit_ptr(stage, u, lane));
  if (f32) {
    o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
  } else {
    o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xFFFF0000u);
    o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
}

constexpr int QM_BN = 32;  // output columns a block

constexpr int QM_WARPS = 8;  // warps a block, one K run each

// 16-byte units of one lane's ring stage: its words, its activation codes
// of MT n8 tiles (8 * NS = C * S bytes each), its scales and zeros.
template <int W, int C, int MT>
__host__ __device__ constexpr int stage_units() {
  return 1 + MT * ((C * (8 / W) + 15) / 16) + 2;
}

// A block owns 32 output columns and MT * 8 rows; warp w of its 8 warps
// takes the w-th of 8 equal runs of the K chunks (C packed rows of every
// column, CK = C * PPW codes), streamed through its own ring of QM_DEPTH
// stages by cp.async, two chunks ahead of the products.  Per chunk and lane
// (g, t): the 16-byte words of columns 4g .. 4g + 3 at packed row widx, and
// of each n8 tile of rows its row g's activations that pair with them; at
// the chunk that ends a group piece, the group's 4 scales and zeros.  The
// grid is launched as the quantization grid's programmatic dependent: the
// first chunks' words and metadata are issued before the wait for its
// codes (quantizing in every block instead repeats the division of each
// activation N / 32 times, and measured slower than even the first body on
// the H100).
template <int W, int C, int MT>
__global__ void __launch_bounds__(QM_WARPS * 32)
quad_mma_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                const int32_t* __restrict__ packed, const void* __restrict__ scales,
                const void* __restrict__ zeros, void* __restrict__ out, int scale_out,
                int out_f32, int meta_f32, int mid, int M, int K, int N, int group_size) {
  constexpr int NW = QM_WARPS;
  constexpr int PPW = 32 / W;            // codes a word
  constexpr int S = 8 / W;               // shifts a word: groups of 4 codes
  constexpr int CK = C * PPW;            // codes (k) a chunk
  constexpr int NS = C * S / 8;          // k32 slabs a chunk
  constexpr int TPW = 4 / C;             // lanes of a quad sharing a word
  constexpr int XB = 8 * NS;             // activation bytes a lane and n8 tile
  constexpr int XU = (XB + 15) / 16;     // 16-byte units of them
  constexpr int UNITS = stage_units<W, C, MT>();
  constexpr int MU = 1 + MT * XU;        // the scales' unit; the zeros' is MU + 1
  constexpr int D = QM_DEPTH;
  constexpr int BM = MT * 8;
  constexpr uint32_t MASK = ((1u << W) - 1u) * 0x01010101u;
  static_assert(NS >= 1 && C * S % 8 == 0, "a chunk holds whole k32 slabs");
  extern __shared__ uint4 smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int widx = t / TPW;              // the lane's packed row of a chunk
  const int sb = (t % TPW) * 2 * NS;     // its first shift
  const int n0 = blockIdx.x * QM_BN, m0 = blockIdx.y * BM;
  const int col = n0 + 4 * g;
  const bool col_ok = col < N;           // N % 4 == 0: a lane's 4 columns are all in or all out
  const int n_chunks = K / CK, cpg = group_size / CK;
  const int c_lo = warp * n_chunks / NW, c_hi = (warp + 1) * n_chunks / NW;
  const int mb = meta_f32 ? 16 : 8;      // bytes of 4 metadata values
  uint4* ring = smem + warp * (D * UNITS * 32);

  // the issuing side, D - 1 chunks ahead: the words and metadata of a chunk
  // (its own pointers and group counter, no division), then its
  // activations; each chunk into the next ring stage
  const int32_t* wp = packed + ((size_t)c_lo * C + widx) * N + col;
  size_t mo = (size_t)(c_lo / cpg) * N + col;
  int iw = c_lo, is_left = cpg - c_lo % cpg, iw_st = 0;
  auto issue_w = [&]() {
    if (iw < c_hi) {
      uint4* st = ring + iw_st * UNITS * 32;
      if (col_ok) {  // columns past N: their outputs are never stored
        cp_async<16>(unit_ptr(st, 0, lane), wp);
        if (is_left == 1 || iw + 1 == c_hi) {  // the chunk ends its group piece
          const char* sp = static_cast<const char*>(scales) + mo * (mb / 4);
          const char* zp = static_cast<const char*>(zeros) + mo * (mb / 4);
          if (meta_f32) {
            cp_async<16>(unit_ptr(st, MU, lane), sp);
            if (!mid) cp_async<16>(unit_ptr(st, MU + 1, lane), zp);
          } else {
            cp_async<8>(unit_ptr(st, MU, lane), sp);
            if (!mid) cp_async<8>(unit_ptr(st, MU + 1, lane), zp);
          }
        }
      }
      wp += (size_t)C * N;
      if (--is_left == 0) {
        is_left = cpg;
        mo += N;
      }
      if (++iw_st == D) iw_st = 0;
      ++iw;
    }
  };
  // rows past M are not copied: their codes in the ring are stale, and
  // only their own outputs, which are never stored, depend on them
  const int8_t* xp[MT];
  bool row_ok[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    row_ok[mt] = m0 + mt * 8 + g < M;
    xp[mt] = qx + (size_t)(row_ok[mt] ? m0 + mt * 8 + g : 0) * K + (size_t)c_lo * CK + widx * PPW +
             4 * sb;
  }
  int ix = c_lo, ix_st = 0;
  auto issue_x = [&]() {
    if (ix < c_hi) {
      uint4* st = ring + ix_st * UNITS * 32;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (row_ok[mt]) {
#pragma unroll
          for (int u = 0; u < XU; ++u)
            cp_async<(XB < 16 ? XB : 16)>(unit_ptr(st, 1 + mt * XU + u, lane), xp[mt] + 16 * u);
        }
        xp[mt] += CK;
      }
      if (++ix_st == D) ix_st = 0;
      ++ix;
    }
    cp_async_commit();  // one group per chunk slot, empty past the run
  };

  float acc[2][MT][4];
  int dot[2][MT][4], xs[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      xs[mt][r] = 0;
      acc[0][mt][r] = acc[1][mt][r] = 0.f;
      dot[0][mt][r] = dot[1][mt][r] = 0;
    }
  const uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};

  // the first chunks' words ride in group 0 with chunk 0's activations
#pragma unroll
  for (int p = 0; p < D - 1; ++p) issue_w();
  griddep_wait();  // the codes are written
#pragma unroll
  for (int p = 0; p < D - 1; ++p) issue_x();
  int left = cpg - c_lo % cpg, stage = 0;  // the products' group counter and ring slot
  for (int i = c_lo; i < c_hi; ++i) {
    issue_w();
    issue_x();
    cp_async_wait<D - 1>();  // chunk i has landed (this lane's copies: it reads only those)
    uint4* st = ring + stage * UNITS * 32;
    const uint4 wv = *reinterpret_cast<const uint4*>(unit_ptr(st, 0, lane));
    const uint32_t w4[4] = {wv.x, wv.y, wv.z, wv.w};
    uint32_t xv[MT][2 * NS];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (NS == 1) {
        const uint2 v = *reinterpret_cast<const uint2*>(unit_ptr(st, 1 + mt * XU, lane));
        xv[mt][0] = v.x; xv[mt][1] = v.y;
      } else {
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          const uint4 v = *reinterpret_cast<const uint4*>(unit_ptr(st, 1 + mt * XU + u, lane));
          xv[mt][4 * u] = v.x; xv[mt][4 * u + 1] = v.y; xv[mt][4 * u + 2] = v.z; xv[mt][4 * u + 3] = v.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int sh_lo = (sb + 2 * j) * W, sh_hi = sh_lo + W;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_u8s8(xs[mt], ones, xv[mt][2 * j], xv[mt][2 * j + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {(w4[2 * h] >> sh_lo) & MASK, (w4[2 * h + 1] >> sh_lo) & MASK,
                               (w4[2 * h] >> sh_hi) & MASK, (w4[2 * h + 1] >> sh_hi) & MASK};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_u8s8(dot[h][mt], a, xv[mt][2 * j], xv[mt][2 * j + 1]);
      }
    }
    if (left == 1 || i + 1 == c_hi) {
      // the group piece ends: the present kernel's terms, then restart
      float sc[4], zc[4] = {0.f, 0.f, 0.f, 0.f};
      read_meta(st, MU, lane, meta_f32, sc);
      if (!mid) read_meta(st, MU + 1, lane, meta_f32, zc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = 2 * h + (r >> 1);
            const int d = dot[h][mt][r], x = xs[mt][r & 1];
            if (mid) acc[h][mt][r] += (float)(d - mid * x) * sc[c];
            else acc[h][mt][r] += (float)d * sc[c] - (float)x * zc[c];
            dot[h][mt][r] = 0;
          }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) xs[mt][r] = 0;
    }
    if (--left == 0) left = cpg;
    if (++stage == D) stage = 0;
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained before the partials reuse it

  // the warps' partials meet in shared memory, summed in warp order
  float (*red)[BM][QM_BN] = reinterpret_cast<float (*)[BM][QM_BN]>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[warp][mt * 8 + 2 * t + (r & 1)][4 * g + 2 * h + (r >> 1)] = acc[h][mt][r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * QM_BN; idx += NW * 32) {
    const int i = idx / QM_BN, c = idx % QM_BN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += red[w][i][c];
    const int m = m0 + i, n = n0 + c;
    if (m < M && n < N) {
      if (scale_out) sum *= sx[m];
      if (out_f32) static_cast<float*>(out)[(size_t)m * N + n] = sum;
      else static_cast<bf16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(sum);
    }
  }
}

template <int W, int C, int MT>
cudaError_t launch_mma_tile(const int8_t* qx, const float* sx, const void* packed,
                            const void* scales, const void* zeros, void* out, int scale_out,
                            int out_f32, int meta_f32, int mid, int M, int K, int N, int gs,
                            cudaStream_t st) {
  constexpr int RING = QM_WARPS * QM_DEPTH * stage_units<W, C, MT>() * 16 * 32;
  constexpr int RED = QM_WARPS * MT * 8 * QM_BN * 4;  // the warps' partials
  constexpr int SMEM = RING > RED ? RING : RED;
  auto kern = quad_mma_kernel<W, C, MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + QM_BN - 1) / QM_BN, (M + MT * 8 - 1) / (MT * 8));
  cfg.blockDim = dim3(QM_WARPS * 32);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, qx, sx, static_cast<const int32_t*>(packed), scales, zeros,
                           out, scale_out, out_f32, meta_f32, mid, M, K, N, gs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The quantization's launch, then 8 (to m 8), 16 (to m 16) or 32 rows a
// block on its codes.
template <int W, int C>
cudaError_t launch_mma(int x_dtype, const void* x, int8_t* qx, float* sx, const void* p,
                       const void* s, const void* z, void* o, int scale_out, int out_f32,
                       int meta_f32, int mid, int M, int K, int N, int gs, cudaStream_t st) {
  cudaError_t err = quantize_rows<W>(x_dtype, x, qx, sx, M, K, st);
  if (err != cudaSuccess) return err;
#define QM_TILE(MT) \
  launch_mma_tile<W, C, MT>(qx, sx, p, s, z, o, scale_out, out_f32, meta_f32, mid, M, K, N, gs, st)
  if (M <= 8) return QM_TILE(1);
  if (M <= 16) return QM_TILE(2);
  return QM_TILE(4);
#undef QM_TILE
}

template <int W, typename MT, typename OT>
cudaError_t launch_quad(const int8_t* qx, const float* sx, const void* packed,
                        const void* scales, const void* zeros, void* out, int M, int K,
                        int N, int group_size, int mid, cudaStream_t stream) {
  constexpr int PPW = 32 / W;
  const int groups = K / group_size;
  const int bkp = group_size / PPW;
  // split a group across slices when there are fewer groups than slices
  int n_split = 1;
  while (groups * n_split < MM_TY && bkp % (n_split * 2) == 0) n_split *= 2;
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  const int32_t* p = static_cast<const int32_t*>(packed);
  const MT* s = static_cast<const MT*>(scales);
  const MT* z = static_cast<const MT*>(zeros);
  OT* o = static_cast<OT*>(out);
  if (mid > 0)
    quad_matmul_kernel<W, MT, OT, true><<<grid, MM_THREADS, 0, stream>>>(
        qx, sx, p, s, z, o, M, K, N, group_size, n_split, mid);
  else
    quad_matmul_kernel<W, MT, OT, false><<<grid, MM_THREADS, 0, stream>>>(
        qx, sx, p, s, z, o, M, K, N, group_size, n_split, mid);
  return cudaGetLastError();
}

template <int W, typename MT>
cudaError_t quad_by_out(int out_dtype, const int8_t* qx, const float* sx, const void* p,
                        const void* s, const void* z, void* o, int M, int K, int N,
                        int gs, int mid, cudaStream_t st) {
  if (out_dtype == kF32) return launch_quad<W, MT, float>(qx, sx, p, s, z, o, M, K, N, gs, mid, st);
  return launch_quad<W, MT, bf16>(qx, sx, p, s, z, o, M, K, N, gs, mid, st);
}

template <int W>
cudaError_t quad_by_meta(int meta_dtype, int out_dtype, const int8_t* qx, const float* sx,
                         const void* p, const void* s, const void* z, void* o, int M, int K,
                         int N, int gs, int mid, cudaStream_t st) {
  if (meta_dtype == kF32) return quad_by_out<W, float>(out_dtype, qx, sx, p, s, z, o, M, K, N, gs, mid, st);
  return quad_by_out<W, bf16>(out_dtype, qx, sx, p, s, z, o, M, K, N, gs, mid, st);
}


template <int W>
cudaError_t quad_all(int x_dtype, int meta_dtype, int out_dtype, const void* x, int8_t* qx,
                     float* sx, int scale_out, const void* p, const void* s, const void* z,
                     void* o, int M, int K, int N, int gs, int mid, cudaStream_t st) {
  cudaError_t err = quantize_rows<W>(x_dtype, x, qx, sx, M, K, st);
  if (err != cudaSuccess) return err;
  return quad_by_meta<W>(meta_dtype, out_dtype, qx, scale_out ? sx : nullptr, p, s, z, o, M,
                         K, N, gs, mid, st);
}

}  // namespace

// Shapes, dtypes, alignment and contiguity are checked by the Python
// wrapper (ops/cuda/quad_matmul.py).  Each entry point returns the last
// launch's cudaGetLastError().
//
// bte_quad_quantize: the per-token quantization alone (qx in the kernel's
// dot order, sx), for the checks against the plain version.
extern "C" int bte_quad_quantize(const void* x, void* qx, void* sx, int M, int K, int w_bit,
                                 int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  float* s = static_cast<float*>(sx);
  switch (w_bit) {
    case 1: return quantize_rows<1>(x_dtype, x, q, s, M, K, st);
    case 2: return quantize_rows<2>(x_dtype, x, q, s, M, K, st);
    case 4: return quantize_rows<4>(x_dtype, x, q, s, M, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// bte_quad_matmul: quantize x (M, K) into the scratch qx (M, K) int8 and sx
// (M,) f32, then the matmul; scale_out = 0 writes the f32 accumulator
// before sx (out must then be f32).  mid > 0 selects the zeros_mid form.
extern "C" int bte_quad_matmul(const void* x, void* qx, void* sx, const void* packed,
                               const void* scales, const void* zeros, void* out, int M, int K,
                               int N, int w_bit, int group_size, int mid, int scale_out,
                               int x_dtype, int meta_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  float* s = static_cast<float*>(sx);
  switch (w_bit) {
    case 1: return quad_all<1>(x_dtype, meta_dtype, out_dtype, x, q, s, scale_out, packed, scales, zeros, out, M, K, N, group_size, mid, st);
    case 2: return quad_all<2>(x_dtype, meta_dtype, out_dtype, x, q, s, scale_out, packed, scales, zeros, out, M, K, N, group_size, mid, st);
    case 4: return quad_all<4>(x_dtype, meta_dtype, out_dtype, x, q, s, scale_out, packed, scales, zeros, out, M, K, N, group_size, mid, st);
    default: return cudaErrorInvalidValue;
  }
}

// bte_quad_mma: the same as bte_quad_matmul on quad_mma_kernel, chunks of
// chunk_words packed rows (1, 2 or 4, at least w_bit, dividing the group's
// rows; ops/cuda/quad_matmul.py chunk_words picks it).
extern "C" int bte_quad_mma(const void* x, void* qx, void* sx, const void* packed,
                            const void* scales, const void* zeros, void* out, int M, int K, int N,
                            int w_bit, int group_size, int chunk_words, int mid, int scale_out,
                            int x_dtype, int meta_dtype, int out_dtype, void* stream) {
  const int c = chunk_words;
  if ((c != 1 && c != 2 && c != 4) || c < w_bit || N % 4 || group_size % (c * (32 / w_bit)) ||
      K % group_size)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  float* s = static_cast<float*>(sx);
  const int of = out_dtype == kF32, mf = meta_dtype == kF32;
#define QM_ARGS x_dtype, x, q, s, packed, scales, zeros, out, scale_out, of, mf, mid, M, K, N, \
                group_size, st
  switch (w_bit * 8 + c) {
    case 1 * 8 + 1: return launch_mma<1, 1>(QM_ARGS);
    case 1 * 8 + 2: return launch_mma<1, 2>(QM_ARGS);
    case 1 * 8 + 4: return launch_mma<1, 4>(QM_ARGS);
    case 2 * 8 + 2: return launch_mma<2, 2>(QM_ARGS);
    case 2 * 8 + 4: return launch_mma<2, 4>(QM_ARGS);
    case 4 * 8 + 4: return launch_mma<4, 4>(QM_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef QM_ARGS
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
