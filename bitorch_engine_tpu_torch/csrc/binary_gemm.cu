// The XNOR-popcount GEMM of the packed 1-bit linear for Hopper (sm_90a).
//
// bte_xnor_gemm -- replaces bitorch_engine_tpu/ops/pallas/binary_gemm.py
//   :_kernel (entry xnor_gemm_pallas :44, pallas_call :70).  Both operands
//   are sign words (bit j of word c is element 32 c + j, set iff it is
//   >= 0; pad bits are 0 in both), x (M, Kw) and w (N, Kw) int32, and
//
//     out[m, n] = k_logical - 2 * sum_c popc(x[m, c] ^ w[n, c])   (f32)
//
//   which is the JAX kernel's kw * 32 - 2 * popc followed by its wrapper's
//   subtraction of the pad bits (:83-85): equal pad bits never differ, so
//   the pad adds kw * 32 - k_logical to the ±1 dot and nothing to popc.
//   The sum is an exact int32; its f32 value is exact below 2^24.
//
// Bound on the H100: one 32-bit popc per (m, n, word), 16 per clock per SM
// for compute capability 9.0 (the CUDA C++ Programming Guide's throughput
// table), against reading the weight words once (N * Kw * 4 bytes) at
// 3.35 TB/s.  At N = K = 4096 the popc time passes the byte time near
// m = 5, so the packed GEMV of the decode batch (m <= 16) is popc bound
// once m passes a few rows and byte bound below.
//
// Design (simple first): a block owns MB rows of x (MB in 1, 2, 4, 8, 16:
// the smallest that holds min(M, 16) rows; more rows take more blocks along
// grid.y) and 8 output columns, one per warp.  The block stages its x rows
// in shared memory (MB * Kw words, dynamic, above 48 KiB after
// cudaFuncSetAttribute); each warp's lanes stride its weight row with
// 16-byte loads (4-byte loads when Kw is not a multiple of 4), xor each
// word with the same word of every staged row, and keep one popc count per
// row in a register; a __shfl_xor_sync tree sums the counts across the
// warp and lane r writes row r.  No tensor cores (the 1-bit mma.b1 path is
// later work), no cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output columns per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxShared = 227 * 1024;

template <int MB, bool VEC>
__global__ void __launch_bounds__(kThreads)
xnor_gemm_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                 float* __restrict__ out, int M, int N, int Kw, int k_logical) {
  extern __shared__ __align__(16) uint32_t xs[];  // MB * Kw words
  const int row0 = blockIdx.y * MB;
  for (int i = threadIdx.x; i < MB * Kw; i += kThreads) {
    const int r = i / Kw;
    xs[i] = (row0 + r < M) ? x[(size_t)row0 * Kw + i] : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;  // the whole warp leaves together
  const uint32_t* wr = w + (size_t)n * Kw;

  int cnt[MB];
#pragma unroll
  for (int r = 0; r < MB; ++r) cnt[r] = 0;
  if (VEC) {
    const int kv = Kw >> 2;
    const uint4* wv = reinterpret_cast<const uint4*>(wr);
    for (int v = lane; v < kv; v += 32) {
      const uint4 b = __ldg(wv + v);
#pragma unroll
      for (int r = 0; r < MB; ++r) {
        const uint4 a = reinterpret_cast<const uint4*>(xs + r * Kw)[v];
        cnt[r] += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) + __popc(a.w ^ b.w);
      }
    }
  } else {
    for (int c = lane; c < Kw; c += 32) {
      const uint32_t b = __ldg(wr + c);
#pragma unroll
      for (int r = 0; r < MB; ++r) cnt[r] += __popc(xs[r * Kw + c] ^ b);
    }
  }
#pragma unroll
  for (int r = 0; r < MB; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt[r] += __shfl_xor_sync(0xffffffffu, cnt[r], off);
  }
#pragma unroll
  for (int r = 0; r < MB; ++r) {
    if (lane == r && row0 + r < M) out[(size_t)(row0 + r) * N + n] = (float)(k_logical - 2 * cnt[r]);
  }
}

template <int MB, bool VEC>
cudaError_t launch(const uint32_t* x, const uint32_t* w, float* out, int M, int N, int Kw,
                   int k_logical, cudaStream_t stream) {
  const size_t smem = (size_t)MB * Kw * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xnor_gemm_kernel<MB, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kWarps - 1) / kWarps, (M + MB - 1) / MB);
  xnor_gemm_kernel<MB, VEC><<<grid, kThreads, smem, stream>>>(x, w, out, M, N, Kw, k_logical);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(int mb, const uint32_t* x, const uint32_t* w, float* out, int M, int N,
                     int Kw, int k_logical, cudaStream_t stream) {
  switch (mb) {
    case 1: return launch<1, VEC>(x, w, out, M, N, Kw, k_logical, stream);
    case 2: return launch<2, VEC>(x, w, out, M, N, Kw, k_logical, stream);
    case 4: return launch<4, VEC>(x, w, out, M, N, Kw, k_logical, stream);
    case 8: return launch<8, VEC>(x, w, out, M, N, Kw, k_logical, stream);
    default: return launch<16, VEC>(x, w, out, M, N, Kw, k_logical, stream);
  }
}

}  // namespace

// Rows per block for (M, Kw): the smallest of 1, 2, 4, 8, 16 holding
// min(M, 16) rows whose words fit the shared memory, halved until they do;
// 0 when even one row does not fit.
extern "C" int bte_xnor_gemm_rows_per_block(int M, int Kw) {
  int mb = 1;
  while (mb < 16 && mb < M) mb *= 2;
  while (mb > 0 && (size_t)mb * Kw * sizeof(uint32_t) > (size_t)kMaxShared) mb /= 2;
  return mb;
}

// x (M, Kw), w (N, Kw) int32 sign words; out (M, N) f32.  vec: every row
// is 16-byte aligned (Kw % 4 == 0 and aligned bases).
extern "C" int bte_xnor_gemm(const void* x, const void* w, void* out, int M, int N, int Kw,
                             int k_logical, int vec, void* stream) {
  const int mb = bte_xnor_gemm_rows_per_block(M, Kw);
  if (mb == 0) return (int)cudaErrorInvalidValue;
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? dispatch<true>(mb, xp, wp, op, M, N, Kw, k_logical, s)
                   : dispatch<false>(mb, xp, wp, op, M, N, Kw, k_logical, s));
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
