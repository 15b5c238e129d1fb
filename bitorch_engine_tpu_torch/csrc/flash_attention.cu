// Flash attention forward for Hopper (sm_90a), causal, GQA-native.
//
// Replaces bitorch_engine_tpu/ops/pallas/flash_attention.py:_fwd_kernel:
// softmax(q k^T * sm_scale [+ causal mask]) v with a running max m, running
// sum l and an f32 accumulator per query row; writes out (bf16) and the
// logsumexp rows lse = m + log(l) (f32, one per query row).
//
// Layout: q (b * nh, s, d), k / v (b * nkv, s, d), bf16, contiguous; query
// head i reads KV head i / rep (rep = nh / nkv, batch folded), so the
// repeated-KV tensor never exists.  s % 64 == 0, d in {64, 128}.
//
// Bound on the H100: operations.  A causal prefill does ~2 * s^2 * d
// multiply-adds per head against ~4 * s * d bytes moved, hundreds of
// operations per byte, so the tensor cores (989 TFLOP/s bf16) set the
// floor.  This first kernel does not reach them: each block owns 64 query
// rows of one head and walks the 64-row K/V tiles up to the diagonal
// (strictly-upper tiles are skipped), with Q, K, V and the probability
// tile in shared memory (row strides padded against bank conflicts) and
// the score and PV products as f32 CUDA-core FMAs, 4 x 4 scores and
// 4 x d/16 outputs per thread.  wgmma / mma.sync, TMA and a pipelined
// K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int FA_BQ = 64;       // query rows per block
constexpr int FA_BK = 64;       // keys per tile
constexpr int FA_THREADS = 256; // 16 x 16 threads
constexpr int FA_LDP = FA_BK + 1;

template <int D> __host__ __device__ constexpr int ld_of() { return D + 2; }  // odd word stride per row

template <int D>
constexpr size_t smem_bytes() {
  return 3 * (size_t)FA_BQ * ld_of<D>() * sizeof(bf16) + (size_t)FA_BQ * FA_LDP * sizeof(float);
}

// Copy a (64, D) bf16 tile from global (row stride D) into shared memory
// (row stride D + 2): 16-byte global reads, 4-byte shared writes.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src) {
  constexpr int LD = ld_of<D>();
  constexpr int CHUNKS = FA_BQ * D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < CHUNKS; c += FA_THREADS) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)row * D + col));
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + row * LD + col);
    d32[0] = v.x; d32[1] = v.y; d32[2] = v.z; d32[3] = v.w;
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int S, int rep, float sm_scale, int causal) {
  constexpr int LD = ld_of<D>();
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float4 smem_f4[];
  bf16* sq = reinterpret_cast<bf16*>(smem_f4);
  bf16* sk = sq + FA_BQ * LD;
  bf16* sv = sk + FA_BK * LD;
  float* sp = reinterpret_cast<float*>(sv + FA_BK * LD);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FA_BQ;
  const bf16* kb = k + (size_t)(bh / rep) * S * D;
  const bf16* vb = v + (size_t)(bh / rep) * S * D;

  load_tile<D>(sq, q + ((size_t)bh * S + q0) * D);

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? blockIdx.x + 1 : S / FA_BK;  // FA_BQ == FA_BK
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sk, kb + (size_t)kt * FA_BK * D);
    load_tile<D>(sv, vb + (size_t)kt * FA_BK * D);
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sq + (ty + 16 * i) * LD + dd));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sk + (tx + 16 * j) * LD + dd));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = fmaf(qv[i].y, kv[j].y, fmaf(qv[i].x, kv[j].x, sc[i][j]));
    }

    // online softmax; a row's 16 owners are the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * FA_BK + tx + 16 * j;
        float s = sc[i][j] * sm_scale;
        if (causal && col > row) s = -INFINITY;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every visited tile holds at least one visible key per row, so m_new is finite
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sp[(ty + 16 * i) * FA_LDP + tx + 16 * j] = p;
        ls += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l_i[i] = l_i[i] * alpha + ls;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // probability tile complete

    // acc[rows ty + 16 i][cols tx + 16 c] += P @ V
#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = __bfloat162float(sv[kk * LD + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty + 16 * i) * FA_LDP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)bh * S + q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[row * D + tx + 16 * c] = __float2bfloat16_rn(acc[i][c] / l_i[i]);
    if (tx == 0) lse[row] = m_i[i] + logf(l_i[i]);
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int S, int rep, float sm_scale, int causal,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / FA_BQ, BH);
  flash_fwd_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, rep, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Shapes, dtypes and contiguity are checked by the Python wrapper
// (ops/cuda/flash_attention.py).  Returns the launch's cudaGetLastError().
extern "C" int bte_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int BH, int S, int D, int rep, float sm_scale,
                             int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_flash<64>(q, k, v, out, lse, BH, S, rep, sm_scale, causal, st);
  if (D == 128) return launch_flash<128>(q, k, v, out, lse, BH, S, rep, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
