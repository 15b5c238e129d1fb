// Flash attention for Hopper (sm_90a), causal or not, GQA-native: the
// forward and the two backward kernels, every product on the tensor cores.
//
// Layout: q, do (b * nh, s, d), k / v (b * nkv, s, d), bf16, contiguous;
// query head i reads KV head i / rep (rep = nh / nkv, batch folded), so the
// repeated-KV tensor never exists.  s % 64 == 0, d in {64, 128}.
//
// Common design.  A block is 4 warps; a warp owns 16 rows of the block's
// 64-row tile.  Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate);
// operands come from shared memory by ldmatrix (.trans where the product
// contracts over the tile's rows), and a product whose A operand is a score
// tile takes it straight from the previous product's accumulator registers:
// packing the f32 fragment to bf16 pairs is where the reference's
// `.astype(bf16)` of p or ds happens, so those rounding points are kept
// exactly.  Tiles stream global -> shared by cp.async through a 2-stage
// ring: the next tile's copy is in flight while the current one is
// multiplied.  Rows are padded by 16 bytes (stride d + 8) so the 8 row
// addresses of an ldmatrix fall on 8 different bank groups.  Causal grids
// are launched heaviest tile first.
//
// flash_fwd_kernel replaces bitorch_engine_tpu/ops/pallas/flash_attention.py
// :_fwd_kernel.  softmax(q k^T * sm_scale [+ causal mask]) v with the
// reference's arithmetic: per reference key tile (block_k keys, the JAX
// wrapper's _pick_block(s)) m_new = max(m, rowmax(s)), p = exp(s - m_new)
// in f32, l = l * alpha + sum(p) on the unrounded p, acc = acc * alpha +
// bf16(p) @ v in f32; out = acc / l (bf16), lse = m + log(l) (f32).  p must
// round against the max of the whole reference tile (512 keys at s 2048),
// whose 16 x 512 f32 score rows do not fit a warp's registers, so each
// reference tile is swept twice in 64-key sub-tiles: q k^T for the row max,
// then q k^T again for p and the PV product.  exp(x) is taken as
// exp2(x * log2 e) (one multiply and the MUFU ex2, where expf adds a range
// reduction), which moves p by a few f32 ulps; on the H100 this forward
// measured faster with it than with expf.
// Bound: operations (2 products per visible pair, ~100-300 FLOP per byte
// moved); this design computes 3, so it can reach at most 2/3 of the bound.
//
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel replace :_dq_kernel and
// :_dkv_kernel.  Both rebuild each probability tile from the saved lse,
// p = exp(q k^T * sm_scale - lse), and take delta = sum_d do * out (one f32
// per query row, computed by the wrapper).  dq: a block owns 64 query rows
// and walks the visible K/V tiles, dq += bf16(ds) @ k with ds = p * (do v^T
// - delta) * sm_scale.  dkv: a block owns 64 keys of one KV head and walks
// every (query head of its group, query tile) pair, so dk / dv sum the rep
// query heads with no atomics, and computes the transposed tiles k q^T and
// v do^T: dv += bf16(p)^T @ do, dk += bf16(ds)^T @ q.  p is expf (exp2
// measured no faster here and moved more elements across a bf16 rounding
// boundary).  At d 128 the dkv kernel holds 128 f32 accumulators per thread
// and spills 24 bytes; halving its score chunk to 16 queries removes the
// spill but measured slower.  Bound: operations
// (5 products per visible pair); the two kernels each recompute q k^T and
// do v^T, 7 products, so they can reach at most 5/7 of it, and in exchange
// are deterministic (no f32 atomics on dq, no f32 dq buffer, no cast pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int FA_TILE = 64;     // rows per block, keys (or queries) per streamed tile
constexpr int FA_THREADS = 128; // 4 warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int ld_of() { return D + 8; }  // padded row
template <int D> __host__ __device__ constexpr int tile_elems() { return FA_TILE * ld_of<D>(); }

// Start copying a (64, D) bf16 tile (global row stride D) into shared
// memory (row stride D + 8), 16 bytes per cp.async.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < FA_TILE * CPR; c += FA_THREADS) {
    const int row = c / CPR;
    const int col = (c % CPR) * 8;
    cp_async<16>(dst + row * ld_of<D>() + col, src + (size_t)row * D + col);
  }
}

// acc (16 x 8*NT) = A (16 x D, the warp's rows of `a`, row-major) times
// the rows n0 .. n0 + 8*NT of `b` transposed ([n][k] storage), both tiles
// in shared memory with stride LD.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float acc[][4], const bf16* a, int r0, const bf16* b, int n0,
                                        int lane) {
  constexpr int LD = ld_of<D>();
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, a_addr<LD>(a, r0, ks * 16, lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, bn_addr<LD>(b, n0 + np * 16, ks * 16, lane));
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += P (16 x 16*KC, bf16 fragments) times rows k0 .. k0 +
// 16*KC of `b` ([k][n] storage, D columns, stride LD).
template <int D, int KC>
__device__ __forceinline__ void mma_pb(float acc[][4], const uint32_t pa[][4], const bf16* b, int k0,
                                       int lane) {
  constexpr int LD = ld_of<D>();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, bt_addr<LD>(b, k0 + kc * 16, np * 16, lane));
      mma16816(acc[2 * np], pa[kc], bf[0], bf[1]);
      mma16816(acc[2 * np + 1], pa[kc], bf[2], bf[3]);
    }
  }
}

// The A fragments (16 x 16 per chunk, bf16) of a 16 x 16*KC f32
// accumulator: the rounding to bf16 happens here.
template <int KC>
__device__ __forceinline__ void to_a_frags(uint32_t pa[][4], const float c[][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    pa[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    pa[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    pa[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    pa[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// Store a warp's 16 x D f32 accumulator, divided by l0 (rows g) and l1
// (rows g + 8), as bf16 rows of `dst` (row stride D); (g, t) = (lane / 4,
// lane % 4).
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float acc[][4], float l0,
                                           float l1, int g, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)g * D + col) =
        __floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(g + 8) * D + col) =
        __floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1);
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 5 * (size_t)tile_elems<D>() * sizeof(bf16);  // q, 2 x k, 2 x v
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int S, int rep, int block_k, float sm_scale, int causal) {
  constexpr int LD = ld_of<D>();
  constexpr int TE = tile_elems<D>();
  extern __shared__ float4 smem_f4[];
  bf16* sq = reinterpret_cast<bf16*>(smem_f4);
  bf16* sk = sq + TE;      // 2 stages
  bf16* sv = sk + 2 * TE;  // 2 stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_TILE;  // heaviest causal rows first
  const bf16* kb = k + (size_t)(bh / rep) * S * D;
  const bf16* vb = v + (size_t)(bh / rep) * S * D;

  // Steps: for each visible reference tile, a max sweep then a p sweep over
  // its visible 64-key sub-tiles (a causal block's rows all lie in one
  // reference query tile, so they see the same reference tiles).
  const int nsub = block_k / FA_TILE;
  const int n_ref = causal ? q0 / block_k + 1 : S / block_k;
  const int nvis_last = causal ? (q0 - (n_ref - 1) * block_k) / FA_TILE + 1 : nsub;
  const int total = 2 * ((n_ref - 1) * nsub + nvis_last);
  auto decode = [&](int i, int& key0, int& pass, int& sub) {
    const int kk = i / (2 * nsub);
    const int r = i - kk * 2 * nsub;
    const int nv = kk == n_ref - 1 ? nvis_last : nsub;
    pass = r / nv;
    sub = r - pass * nv;
    key0 = kk * block_k + sub * FA_TILE;
  };
  auto load_step = [&](int i) {
    int key0, pass, sub;
    decode(i, key0, pass, sub);
    load_tile_async<D>(sk + (i & 1) * TE, kb + (size_t)key0 * D);
    if (pass) load_tile_async<D>(sv + (i & 1) * TE, vb + (size_t)key0 * D);
  };

  load_tile_async<D>(sq, q + ((size_t)bh * S + q0) * D);
  cp_async_commit();
  load_step(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // the warp's 16 query rows stay in registers as A fragments
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(qf[ks], a_addr<LD>(sq, warp * 16, ks * 16, lane));

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_prev[2] = {-INFINITY, -INFINITY}, m_cur[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    int key0, pass, sub;
    decode(i, key0, pass, sub);
    const bf16* kt = sk + (i & 1) * TE;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, bn_addr<LD>(kt, np * 16, ks * 16, lane));
        mma16816(s[2 * np], qf[ks], bf[0], bf[1]);
        mma16816(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }
    }
    const bool diag = causal && key0 == q0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sm_scale;
        if (diag && key0 + j * 8 + 2 * t + (e & 1) > row0 + (e >> 1) * 8) x = -INFINITY;
        s[j][e] = x;
      }

    if (pass == 0) {
      // the reference tile's row max
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_cur[r] = fmaxf(m_cur[r], mx);
      }
    } else {
      if (sub == 0) {
        // every visited reference tile holds a visible key per row: m_cur is finite
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float alpha = exp2f((m_prev[r] - m_cur[r]) * LOG2E);
          l[r] *= alpha;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            o[n][2 * r] *= alpha;
            o[n][2 * r + 1] *= alpha;
          }
          m_prev[r] = m_cur[r];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((s[j][e] - m_cur[e >> 1]) * LOG2E);
          l[e >> 1] += p;  // l sums the unrounded p
          s[j][e] = p;
        }
      uint32_t pa[4][4];
      to_a_frags<4>(pa, s);  // p rounded to bf16 (v's type) for the PV product
      mma_pb<D, 4>(o, pa, sv + (i & 1) * TE, 0, lane);
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t rowbase = (size_t)bh * S + q0 + warp * 16;
  store_rows<D>(out + rowbase * D, o, l[0], l[1], g, t);
  if (t == 0) {
    lse[rowbase + g] = m_cur[0] + logf(l[0]);
    lse[rowbase + g + 8] = m_cur[1] + logf(l[1]);
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int S, int rep, int block_k, float sm_scale, int causal,
                         cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, S / FA_TILE);
  flash_fwd_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, rep, block_k, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 6 * (size_t)tile_elems<D>() * sizeof(bf16);  // q, do, 2 x k, 2 x v
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, 2 x q, 2 x do, 2 x (lse, delta) rows
  return 6 * (size_t)tile_elems<D>() * sizeof(bf16) + 4 * FA_TILE * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int rep, float sm_scale, int causal) {
  constexpr int TE = tile_elems<D>();
  extern __shared__ float4 smem_f4[];
  bf16* sq = reinterpret_cast<bf16*>(smem_f4);
  bf16* sdo = sq + TE;
  bf16* sk = sdo + TE;     // 2 stages
  bf16* sv = sk + 2 * TE;  // 2 stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_TILE;  // heaviest causal rows first
  const bf16* kb = k + (size_t)(bh / rep) * S * D;
  const bf16* vb = v + (size_t)(bh / rep) * S * D;
  const int n_tiles = causal ? q0 / FA_TILE + 1 : S / FA_TILE;
  auto load_step = [&](int kt) {
    load_tile_async<D>(sk + (kt & 1) * TE, kb + (size_t)kt * FA_TILE * D);
    load_tile_async<D>(sv + (kt & 1) * TE, vb + (size_t)kt * FA_TILE * D);
  };

  load_tile_async<D>(sq, q + ((size_t)bh * S + q0) * D);
  load_tile_async<D>(sdo, dout + ((size_t)bh * S + q0) * D);
  load_step(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  const float lse_r[2] = {lse[(size_t)bh * S + row0], lse[(size_t)bh * S + row0 + 8]};
  const float dl_r[2] = {delta[(size_t)bh * S + row0], delta[(size_t)bh * S + row0 + 8]};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) load_step(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ktile = sk + (kt & 1) * TE;
    float s[8][4], dp[8][4];
    mma_abt<D, 8>(s, sq, warp * 16, ktile, 0, lane);                  // q k^T
    mma_abt<D, 8>(dp, sdo, warp * 16, sv + (kt & 1) * TE, 0, lane);   // do v^T
    const bool diag = causal && kt * FA_TILE == q0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked = diag && kt * FA_TILE + j * 8 + 2 * t + (e & 1) > row0 + r * 8;
        const float p = masked ? 0.f : expf(s[j][e] * sm_scale - lse_r[r]);
        s[j][e] = p * (dp[j][e] - dl_r[r]) * sm_scale;  // ds
      }
    uint32_t da[4][4];
    to_a_frags<4>(da, s);  // ds rounded to bf16 (k's type)
    mma_pb<D, 4>(acc, da, ktile, 0, lane);  // dq += ds @ k
    __syncthreads();
  }
  store_rows<D>(dq + ((size_t)bh * S + q0 + warp * 16) * D, acc, 1.f, 1.f, g, t);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int S, int rep, float sm_scale, int causal) {
  constexpr int TE = tile_elems<D>();
  // query columns per inner chunk: at d 128 the two f32 gradient
  // accumulators take 128 registers, so the score chunks are halved
  constexpr int NC = D == 128 ? 32 : 64;
  extern __shared__ float4 smem_f4[];
  bf16* sk = reinterpret_cast<bf16*>(smem_f4);
  bf16* sv = sk + TE;
  bf16* sq = sv + TE;       // 2 stages
  bf16* sdo = sq + 2 * TE;  // 2 stages
  float* sstat = reinterpret_cast<float*>(sdo + 2 * TE);  // 2 stages of (lse, delta) x 64

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x;
  const int kt = blockIdx.y;  // causal: the lowest key tiles walk the most query tiles, first
  const int k0 = kt * FA_TILE;
  const int nq = S / FA_TILE;
  const int jq0 = causal ? kt : 0;
  const int per_head = nq - jq0;
  const int total = rep * per_head;
  auto load_step = [&](int i) {
    const size_t r0 = ((size_t)bkv * rep + i / per_head) * S + (size_t)(jq0 + i % per_head) * FA_TILE;
    const int st = i & 1;
    load_tile_async<D>(sq + st * TE, q + r0 * D);
    load_tile_async<D>(sdo + st * TE, dout + r0 * D);
    float* stat = sstat + st * 2 * FA_TILE;
    if (threadIdx.x < 16) cp_async<16>(stat + 4 * threadIdx.x, lse + r0 + 4 * threadIdx.x);
    else if (threadIdx.x < 32) cp_async<16>(stat + FA_TILE + 4 * (threadIdx.x - 16), delta + r0 + 4 * (threadIdx.x - 16));
  };

  load_tile_async<D>(sk, k + ((size_t)bkv * S + k0) * D);
  load_tile_async<D>(sv, v + ((size_t)bkv * S + k0) * D);
  load_step(0);
  cp_async_commit();

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;

  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int jq = jq0 + i % per_head;
    const bf16* qt = sq + (i & 1) * TE;
    const bf16* dot = sdo + (i & 1) * TE;
    const float* slse = sstat + (i & 1) * 2 * FA_TILE;
    const float* sdl = slse + FA_TILE;
    const bool diag = causal && jq == kt;
#pragma unroll
    for (int c0 = 0; c0 < FA_TILE; c0 += NC) {
      float s[NC / 8][4], dp[NC / 8][4];
      mma_abt<D, NC / 8>(s, sk, warp * 16, qt, c0, lane);    // (q k^T)^T
      mma_abt<D, NC / 8>(dp, sv, warp * 16, dot, c0, lane);  // (do v^T)^T
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + j * 8 + 2 * t + (e & 1);  // query row within the tile
          const bool masked = diag && key0 + (e >> 1) * 8 > jq * FA_TILE + qc;
          const float p = masked ? 0.f : expf(s[j][e] * sm_scale - slse[qc]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sdl[qc]) * sm_scale;  // ds
        }
      uint32_t pa[NC / 16][4], da[NC / 16][4];
      to_a_frags<NC / 16>(pa, s);   // p rounded to bf16 (do's type)
      to_a_frags<NC / 16>(da, dp);  // ds rounded to bf16 (q's type)
      mma_pb<D, NC / 16>(dva, pa, dot, c0, lane);  // dv += p^T @ do
      mma_pb<D, NC / 16>(dka, da, qt, c0, lane);   // dk += ds^T @ q
    }
    __syncthreads();
  }
  const size_t rowbase = (size_t)bkv * S + k0 + warp * 16;
  store_rows<D>(dk + rowbase * D, dka, 1.f, 1.f, g, t);
  store_rows<D>(dv + rowbase * D, dva, 1.f, 1.f, g, t);
}

template <int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int BH, int S, int rep,
                          float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, S / FA_TILE);
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
  dim3 grid(BKV, S / FA_TILE);
  flash_bwd_dkv_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, rep, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Shapes, dtypes and contiguity are checked by the Python wrapper
// (ops/cuda/flash_attention.py).  block_k is the reference's key tile (a
// multiple of 64 dividing S).  Returns the launch's cudaGetLastError().
extern "C" int bte_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int BH, int S, int D, int rep, int block_k,
                             float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 64 || block_k <= 0 || block_k % 64 || S % block_k) return cudaErrorInvalidValue;
  if (D == 64) return launch_flash<64>(q, k, v, out, lse, BH, S, rep, block_k, sm_scale, causal, st);
  if (D == 128) return launch_flash<128>(q, k, v, out, lse, BH, S, rep, block_k, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

// The two backward launches.  delta is sum_d do * out per query row (f32,
// (b * nh, s)); dq is (b * nh, s, d), dk / dv (b * nkv, s, d), bf16.
extern "C" int bte_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int BH, int S,
                                int D, int rep, float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 64) return cudaErrorInvalidValue;
  if (D == 64) return launch_bwd_dq<64>(q, k, v, dout, lse, delta, dq, BH, S, rep, sm_scale, causal, st);
  if (D == 128) return launch_bwd_dq<128>(q, k, v, dout, lse, delta, dq, BH, S, rep, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" int bte_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BKV,
                                 int S, int D, int rep, float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 64) return cudaErrorInvalidValue;
  if (D == 64)
    return launch_bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BKV, S, rep, sm_scale, causal, st);
  if (D == 128)
    return launch_bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BKV, S, rep, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
