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
// Design: kernel 1's block structure (csrc/dequant_matmul.cu).  Each block
// owns 32 output columns and 8 activation rows; its 256 threads are 8
// column quads (one coalesced 16-byte load of packed words per packed row)
// x 32 K-slices, each slice a whole quant group (or an equal part of one
// when there are fewer than 32 groups); per packed row a thread reads the
// row's S activation words of each of its 8 rows with one load and issues
// 4 * S dp4a for the dots and S for the sums.  The slices' f32 sums meet in
// shared memory.  CUDA-core dp4a, no tensor cores, no cp.async / TMA: the
// simple form first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

constexpr int QA_THREADS = 256;

template <int W, typename XT>
__global__ void __launch_bounds__(QA_THREADS)
quantize_rows_kernel(const XT* __restrict__ x, int8_t* __restrict__ qx,
                     float* __restrict__ sx, int K) {
  constexpr int PPW = 32 / W;
  constexpr int S = 8 / W;
  __shared__ float red[QA_THREADS / 32];
  __shared__ int has_nan;
  const XT* xr = x + (size_t)blockIdx.x * K;
  if (threadIdx.x == 0) has_nan = 0;
  __syncthreads();
  float amax = 0.f;
  bool nan = false;
  for (int k = threadIdx.x; k < K; k += QA_THREADS) {
    const float v = to_f32(xr[k]);
    nan |= (v != v);
    amax = fmaxf(amax, fabsf(v));
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
  for (int k = threadIdx.x; k < K; k += QA_THREADS) {
    const int r = k / PPW, j = k % PPW;
    const float q = rintf(to_f32(xr[k]) / s);
    qr[r * PPW + 4 * (j % S) + j / S] = (q == q) ? (int8_t)(int)q : (int8_t)0;
  }
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
cudaError_t quantize_rows(int x_dtype, const void* x, int8_t* qx, float* sx, int M, int K,
                          cudaStream_t st) {
  if (x_dtype == kF32)
    quantize_rows_kernel<W, float><<<M, QA_THREADS, 0, st>>>(static_cast<const float*>(x), qx, sx, K);
  else
    quantize_rows_kernel<W, bf16><<<M, QA_THREADS, 0, st>>>(static_cast<const bf16*>(x), qx, sx, K);
  return cudaGetLastError();
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

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
