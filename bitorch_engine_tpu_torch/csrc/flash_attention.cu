// Flash attention for Hopper (sm_90a), causal or not, GQA-native: the
// forward and the two backward kernels.
//
// flash_fwd_kernel replaces bitorch_engine_tpu/ops/pallas/flash_attention.py
// :_fwd_kernel: softmax(q k^T * sm_scale [+ causal mask]) v with a running
// max m, running sum l and an f32 accumulator per query row; writes out
// (bf16) and the logsumexp rows lse = m + log(l) (f32, one per query row).
//
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel replace :_dq_kernel and
// :_dkv_kernel.  Both rebuild each probability tile from the saved lse,
// p = exp(q k^T * sm_scale - lse), and take delta = sum_d do * out (one
// f32 per query row, computed by the wrapper).  dq: one block per (b * nh,
// 64 query rows) walks the visible K tiles and accumulates
// dq += ds @ k with ds = p * (do v^T - delta) * sm_scale.  dkv: one block
// per (b * nkv, 64 keys) walks every (query head of its group, query tile)
// pair, so dk / dv sum the rep query heads with no atomics and no
// repeated-KV tensor, and accumulates dv += p^T @ do and dk += ds^T @ q.
// As in the reference, p rounds to bf16 before the dv product and ds
// before the dq / dk products; every accumulator is f32.
//
// Layout: q, do (b * nh, s, d), k / v (b * nkv, s, d), bf16, contiguous;
// query head i reads KV head i / rep (rep = nh / nkv, batch folded), so the
// repeated-KV tensor never exists.  s % 64 == 0, d in {64, 128}.
//
// Bound on the H100: operations.  A causal pass does ~2 (forward) and ~7
// (backward: q k^T and do v^T in both kernels, and the three gradient
// products) * s^2 * d / 2 multiply-adds per head against ~4-9 * s * d
// bytes moved, hundreds of operations per byte, so the tensor cores (989
// TFLOP/s bf16) set the floor.  These first kernels do not reach them: a
// block owns 64 rows and walks 64-row tiles (strictly-upper tiles are
// skipped), with its operand tiles and the probability / ds tiles in
// shared memory (row strides padded against bank conflicts) and every
// product as f32 CUDA-core FMAs, 4 x 4 scores and 4 x d/16 outputs per
// thread.  wgmma / mma.sync, TMA and a pipelined K/V ring are later work.

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


template <int D>
constexpr size_t dq_smem_bytes() {
  return 4 * (size_t)FA_BQ * ld_of<D>() * sizeof(bf16) + (size_t)FA_BQ * FA_LDP * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 4 * (size_t)FA_BQ * ld_of<D>() * sizeof(bf16) + 2 * (size_t)FA_BQ * FA_LDP * sizeof(float)
         + 2 * (size_t)FA_BQ * sizeof(float);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int rep, float sm_scale, int causal) {
  constexpr int LD = ld_of<D>();
  constexpr int DC = D / 16;
  extern __shared__ float4 smem_f4[];
  bf16* sq = reinterpret_cast<bf16*>(smem_f4);
  bf16* sdo = sq + FA_BQ * LD;
  bf16* sk = sdo + FA_BQ * LD;
  bf16* sv = sk + FA_BK * LD;
  float* sds = reinterpret_cast<float*>(sv + FA_BK * LD);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FA_BQ;
  const bf16* kb = k + (size_t)(bh / rep) * S * D;
  const bf16* vb = v + (size_t)(bh / rep) * S * D;

  load_tile<D>(sq, q + ((size_t)bh * S + q0) * D);
  load_tile<D>(sdo, dout + ((size_t)bh * S + q0) * D);
  float lse_i[4], dl_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)bh * S + q0 + ty + 16 * i;
    lse_i[i] = lse[row];
    dl_i[i] = delta[row];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? blockIdx.x + 1 : S / FA_BK;  // FA_BQ == FA_BK
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sk, kb + (size_t)kt * FA_BK * D);
    load_tile<D>(sv, vb + (size_t)kt * FA_BK * D);
    __syncthreads();

    // s = q k^T and dp = do v^T for rows ty + 16 i, keys tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 2) {
      float2 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sq + (ty + 16 * i) * LD + dd));
        ov[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sdo + (ty + 16 * i) * LD + dd));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sk + (tx + 16 * j) * LD + dd));
        vv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sv + (tx + 16 * j) * LD + dd));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].y, kv[j].y, fmaf(qv[i].x, kv[j].x, sc[i][j]));
          dp[i][j] = fmaf(ov[i].y, vv[j].y, fmaf(ov[i].x, vv[j].x, dp[i][j]));
        }
    }

    // ds = p * (dp - delta) * sm_scale, rounded to bf16 (k's type)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * FA_BK + tx + 16 * j;
        const float p = (causal && col > row) ? 0.f : expf(sc[i][j] * sm_scale - lse_i[i]);
        sds[(ty + 16 * i) * FA_LDP + tx + 16 * j] = round_bf16(p * (dp[i][j] - dl_i[i]) * sm_scale);
      }
    }
    __syncthreads();  // ds tile complete

    // acc[rows ty + 16 i][cols tx + 16 c] += ds @ k
#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float kr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kr[c] = __bfloat162float(sk[kk * LD + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = sds[(ty + 16 * i) * FA_LDP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(d, kr[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)bh * S + q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[row * D + tx + 16 * c] = __float2bfloat16_rn(acc[i][c]);
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int S, int rep, float sm_scale, int causal) {
  constexpr int LD = ld_of<D>();
  constexpr int DC = D / 16;
  extern __shared__ float4 smem_f4[];
  bf16* sk = reinterpret_cast<bf16*>(smem_f4);
  bf16* sv = sk + FA_BK * LD;
  bf16* sq = sv + FA_BK * LD;
  bf16* sdo = sq + FA_BQ * LD;
  float* sp = reinterpret_cast<float*>(sdo + FA_BQ * LD);
  float* sds = sp + FA_BK * FA_LDP;
  float* slse = sds + FA_BK * FA_LDP;
  float* sdl = slse + FA_BQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bkv = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * FA_BK;
  const int nq = S / FA_BQ;

  load_tile<D>(sk, k + ((size_t)bkv * S + k0) * D);
  load_tile<D>(sv, v + ((size_t)bkv * S + k0) * D);
  // accumulators for keys ty + 16 i, columns tx + 16 c
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int h = 0; h < rep; ++h) {
    const size_t bh = (size_t)bkv * rep + h;
    for (int jq = causal ? kt : 0; jq < nq; ++jq) {  // FA_BQ == FA_BK
      const size_t r0 = bh * S + (size_t)jq * FA_BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(sq, q + r0 * D);
      load_tile<D>(sdo, dout + r0 * D);
      if (threadIdx.x < FA_BQ) {
        slse[threadIdx.x] = lse[r0 + threadIdx.x];
        sdl[threadIdx.x] = delta[r0 + threadIdx.x];
      }
      __syncthreads();

      // transposed tiles: s = q k^T and dp = do v^T at keys ty + 16 i,
      // query rows tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int dd = 0; dd < D; dd += 2) {
        float2 kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sk + (ty + 16 * i) * LD + dd));
          vv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sv + (ty + 16 * i) * LD + dd));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sq + (tx + 16 * j) * LD + dd));
          ov[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sdo + (tx + 16 * j) * LD + dd));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qv[j].y, kv[i].y, fmaf(qv[j].x, kv[i].x, sc[i][j]));
            dp[i][j] = fmaf(ov[j].y, vv[i].y, fmaf(ov[j].x, vv[i].x, dp[i][j]));
          }
      }

      // p (rounded to bf16, do's type) and ds (rounded to bf16, q's type)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool masked = causal && key > jq * FA_BQ + qr;
          const float p = masked ? 0.f : expf(sc[i][j] * sm_scale - slse[qr]);
          sp[(ty + 16 * i) * FA_LDP + qr] = round_bf16(p);
          sds[(ty + 16 * i) * FA_LDP + qr] = round_bf16(p * (dp[i][j] - sdl[qr]) * sm_scale);
        }
      }
      __syncthreads();  // p and ds tiles complete

      // dv += p^T @ do and dk += ds^T @ q over this tile's query rows
#pragma unroll 4
      for (int qq = 0; qq < FA_BQ; ++qq) {
        float orow[DC], qrow[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          orow[c] = __bfloat162float(sdo[qq * LD + tx + 16 * c]);
          qrow[c] = __bfloat162float(sq[qq * LD + tx + 16 * c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sp[(ty + 16 * i) * FA_LDP + qq];
          const float d = sds[(ty + 16 * i) * FA_LDP + qq];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[i][c] = fmaf(p, orow[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(d, qrow[c], dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)bkv * S + k0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[row * D + tx + 16 * c] = __float2bfloat16_rn(dk_acc[i][c]);
      dv[row * D + tx + 16 * c] = __float2bfloat16_rn(dv_acc[i][c]);
    }
  }
}

template <int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int BH, int S, int rep,
                          float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / FA_BQ, BH);
  flash_bwd_dq_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, rep, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int BKV,
                           int S, int rep, float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / FA_BK, BKV);
  flash_bwd_dkv_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, rep, sm_scale, causal);
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

// The two backward launches.  delta is sum_d do * out per query row (f32,
// (b * nh, s)); dq is (b * nh, s, d), dk / dv (b * nkv, s, d), bf16.
extern "C" int bte_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int BH, int S,
                                int D, int rep, float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_bwd_dq<64>(q, k, v, dout, lse, delta, dq, BH, S, rep, sm_scale, causal, st);
  if (D == 128) return launch_bwd_dq<128>(q, k, v, dout, lse, delta, dq, BH, S, rep, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" int bte_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BKV,
                                 int S, int D, int rep, float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BKV, S, rep, sm_scale, causal, st);
  if (D == 128)
    return launch_bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BKV, S, rep, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
