// The XNOR-popcount GEMM of the packed 1-bit linear for Hopper (sm_90a), on
// the tensor cores' 1-bit products, with the packed linear's sign and scales
// fused.
//
// Kernel 8 -- replaces bitorch_engine_tpu/ops/pallas/binary_gemm.py:_kernel
//   (entry xnor_gemm_pallas :44, pallas_call :70).  The weight is sign
//   words w (N, Kw) int32: bit j of word c is element 32 c + j, set iff it
//   is >= 0, the pad bits past k_logical 0.  Two entries, one body:
//
//   bte_xnor_gemm (the TPU kernel's own function): x sign words (M, Kw),
//     out[m, n] = k_logical - 2 * sum_c popc(x[m, c] ^ w[n, c])  (f32),
//     the JAX kernel's 32 Kw - 2 popc less its wrapper's pad count (:83-85).
//   bte_binary_packed_linear (the packed layer, ops/binary_linear.py
//     _forward): x (M, K) f32, bf16 or f16 and bias_a (K,); the sign of
//     f32(x) + f32(bias_a) >= 0 (sign(0) = +1, -0.0 >= 0, NaN -1) is the x
//     word's bit; out = ((f32) dot * scale_a) * scale_w, two rounded
//     products, cast to x's dtype.  f32 addition rounds a nonzero sum to a
//     nonzero value of its sign, so this is the sign of PyTorch's x +
//     bias_a in any promotion of the two dtypes.
//
// The product.  mma.sync.m16n8k256.b1.b1.s32.and.popc adds popc(a & b)
// over 256 bits a product, exact in int32, with the weight as A (16 output
// columns) and the activations as B (8 rows of x): the serving batch (m 8)
// fills one product, larger m loops over 8-row tiles.  A slab is 8 words;
// lane t (= lane % 4) feeds words 8 s + t (a0, a1, b0) and 8 s + 4 + t (a2,
// a3, b1) of slab s as they are: A and B pair the same words, so the order
// of the bits inside a word does not matter, and there is no conversion at
// all.  popc(x ^ w) = popc(x) + popc(w) - 2 popc(x & w), so a K run of
// words gives the +-1 dot 32 words - 2 popc(x) - 2 popc(w) + 4 popc(x & w):
// popc(x) of a row and popc(w) of a column are summed from the registers
// the products read (__popc, then a quad's shuffles).  The pad bits are 0
// in both operands, so each adds +1 to the dot, and the epilogue subtracts
// 32 Kw - k_logical: the JAX wrapper's own correction, which keeps the
// words entry bit-equal to the plain version for any pad bits.  Words past
// Kw (to a whole slab) are zero in both operands and not counted.  On the
// H100 the 1-bit product issues at the int8 product's instruction rate
// (m16n8k256 against m16n8k32: 8x the k a product), and an int8 form of
// this kernel (+-1 bytes built in registers, three instructions a
// register) measured slower at every shape chip_smoke.py phase 14 times;
// the .xor.popc form builds but runs several times slower than .and.popc.
//
// Bound on the H100: 2 m N K 1-bit operations at the 1-bit product's rate
// (no rate is published; bte_mma_rate_probe below measures its issue rate
// against the int8 product's, and chip_smoke.py phase 14 holds it at 8x
// the published 1979 TOP/s int8 rate, or more where the probe reads
// faster) against reading the weight words (N Kw 4 bytes), x and the
// output once at 3.35 TB/s.  Bytes bound every shape of phase 14: below
// K = 9450 the f32 output alone (4 m N bytes) takes longer than the
// operations, so a large m is a write of the output, and the serving
// forward (1024^2, m 8) is a 128 KB read, where a launch's fixed cost and
// one trip to memory set the time and the fusion removes the dozen small
// launches of the plain packing and epilogue around it.
//
// Design.  A block of 8 warps owns MT * 8 rows of x (MT = 1, 2, 4 or 8)
// and 8 / wk warp column tiles of NT * 16 columns (NT = 1 to MT 2, else
// 2); its warps split K into wk equal runs of slabs (wk = 1, 2, 4, 8,
// picked by the wrapper so that the grid covers the card) and, when tpb >
// 1, the block walks tpb column tiles with its x rows kept.
//   1. Each warp's first weight slabs are put in flight, then the block's
//      rows of x become sign words in shared memory, once: copied by
//      cp.async (words entry), or built from x and bias_a by quads of lanes
//      (fused entry; 16-byte loads, 4 steps' loads issued before their
//      compares), in a cluster of up to 8 blocks along the columns whose
//      ranks each build a share of every row's words and store it in every
//      rank's shared memory (each block would otherwise read all of x).
//      Rows past M are zero.  Rows are padded to an odd multiple of 4
//      words, so the 8 rows a product reads sit in 8 different bank quads.
//   2. Each warp streams its columns' weight words through its own ring of
//      kDepth stages by cp.async (a stage is one slab of its 16 NT
//      columns, 16-byte copies laid out [half slab][column][4 words], so a
//      product's 32 lanes read 32 different banks), kDepth - 1 slabs ahead.
//   3. Per slab: NT column tiles' A words, MT row tiles' B words, their
//      popcounts, and MT * NT products into int32 accumulators.
//   4. The wk runs' int32 dots meet in shared memory (exact in any order);
//      the epilogue subtracts the pad, converts to f32 (exact below 2^24),
//      applies the scales (fused entry) and stores, masking ragged M and N.
// The first design was SIMT popcount, one warp an output column and a
// shuffle tree a row; it is gone.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDepth = 4;  // ring stages a warp
constexpr int kMaxShared = 227 * 1024;

struct Args {
  const void* x;        // words entry: (M, Kw) int32 sign words; fused: (M, K) activations
  const void* bias;     // fused: (K,) bias_a
  const void* scale_a;  // fused: one value
  const void* scale_w;  // fused: one value
  const uint32_t* w;    // (N, Kw) sign words
  void* out;            // (M, N): f32 (words entry) or x's dtype (fused)
  int M, N, K, Kw;      // K = k_logical
  int fused;
  int x_dt, b_dt, sa_dt, sw_dt;
  int vec_x;            // fused: K % 8 == 0 and x, bias 16-byte aligned; words entry:
                       // Kw % 4 == 0 and x 16-byte aligned
  int wk;               // warps along K; 8 / wk along N
  int tpb;              // column tiles a block
  int cluster;          // blocks of a cluster along the columns (1, 2, 4, 8)
  int kwp;              // words a staged row of x
};

// A 16-bit value (bf16 or f16, as dt says) as f32, exactly.
__device__ __forceinline__ float half_f32(uint32_t h, int dt) {
  return dt == kBF16 ? __uint_as_float(h << 16) : __half2float(__ushort_as_half((unsigned short)h));
}

__device__ __forceinline__ float ld_f32(const void* p, size_t i, int dt) {
  if (dt == kF32) return __ldg(static_cast<const float*>(p) + i);
  return half_f32(__ldg(static_cast<const unsigned short*>(p) + i), dt);
}

// 8 consecutive values at element e (e % 8 == 0, 16-byte aligned) as f32.
__device__ __forceinline__ void ld8(const void* p, size_t e, int dt, float v[8]) {
  if (dt == kF32) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + e);
    const float4 a = __ldg(q), b = __ldg(q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(static_cast<const unsigned short*>(p) + e));
  const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = half_f32(h[i] & 0xFFFFu, dt);
    v[2 * i + 1] = half_f32(h[i] >> 16, dt);
  }
}

__device__ __forceinline__ void store_out(const Args& a, size_t i, float v) {
  if (!a.fused || a.x_dt == kF32) static_cast<float*>(a.out)[i] = v;
  else if (a.x_dt == kBF16) static_cast<bf16*>(a.out)[i] = __float2bfloat16_rn(v);
  else static_cast<__half*>(a.out)[i] = __float2half_rn(v);
}

template <int MT, int NT>
__host__ __device__ constexpr int red_words() {  // the 8 warps' int32 partials
  return kWarps * MT * NT * 4 * 32;
}

template <int MT, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads)
xnor_mma_kernel(const Args a) {
  constexpr int BM = MT * 8;
  constexpr int CW = 16 * NT;         // columns a warp tile
  constexpr int UNITS = 2 * CW;       // 16-byte units a stage: 8 words of each column
  constexpr int R = MT * NT * 4;
  extern __shared__ uint4 smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);  // BM x kwp words
  uint4* rings = smem + BM * a.kwp / 4;              // kWarps x kDepth x UNITS; then the partials
  int* red = reinterpret_cast<int*>(rings);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp / a.wk, wki = warp % a.wk;
  const int m0 = blockIdx.y * BM;
  const int Kw = a.Kw;
  const int n_slabs = (Kw + 7) / 8;
  const int s_lo = wki * n_slabs / a.wk, s_hi = (wki + 1) * n_slabs / a.wk;
  const int run_words = min(8 * s_hi, Kw) - min(8 * s_lo, Kw);
  uint4* ring = rings + warp * kDepth * UNITS;
  const int bn = (kWarps / a.wk) * CW;  // columns a block tile

  int tile = 0, n0 = 0, iss = s_lo, iss_st = 0;
  const uint32_t* wsrc[NT];
  bool col_ok[NT];
  auto start_tile = [&]() {  // this lane's copies: unit lane + 32 j, a column and a half slab
    n0 = (blockIdx.x * a.tpb + tile) * bn + wn * CW;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int u = lane + 32 * j, col = n0 + u % CW;
      col_ok[j] = col < a.N;  // columns past N: never copied, never stored
      wsrc[j] = a.w + (size_t)(col_ok[j] ? col : 0) * Kw + 4 * (u / CW);
    }
    iss = s_lo;
    iss_st = 0;
  };
  auto issue = [&]() {
    if (iss < s_hi) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int u = lane + 32 * j;
        const int c = 8 * iss + 4 * (u / CW);  // the unit's first word
        uint4* dst = ring + iss_st * UNITS + u;
        if (col_ok[j]) {
          if (VEC) {
            if (c < Kw) cp_async<16>(dst, wsrc[j] + 8 * iss);
            else *dst = make_uint4(0u, 0u, 0u, 0u);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              uint32_t* d = reinterpret_cast<uint32_t*>(dst) + e;
              if (c + e < Kw) cp_async<4>(d, wsrc[j] + 8 * iss + e);
              else *d = 0u;  // words past Kw: no bits
            }
          }
        }
      }
      if (++iss_st == kDepth) iss_st = 0;
      ++iss;
    }
    cp_async_commit();  // one group a slab slot, empty past the run
  };

  const int C = a.cluster;
  if (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");  // started
  // the first tile's weight words are in flight while x is staged
  start_tile();
  if ((blockIdx.x * a.tpb) * bn < a.N) {
#pragma unroll
    for (int p = 0; p < kDepth - 1; ++p) issue();
  }

  // 1. the block's rows of x as sign words; words past Kw (to a whole slab)
  //    and rows past M are zero.  A cluster of C blocks along the columns
  //    shares the work: rank r builds words [r Kw / C, (r + 1) Kw / C) of
  //    every row and stores them in every rank's shared memory.
  {
    int w_lo = 0, w_hi = Kw;
    cg::cluster_group cluster = cg::this_cluster();
    if (C > 1) {
      const int rank = (int)cluster.block_rank();
      w_lo = rank * Kw / C;
      w_hi = (rank + 1) * Kw / C;
      // every rank has started: its shared memory may be written
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
    const int nw = w_hi - w_lo, total = BM * nw;
    auto put = [&](int r, int c, uint32_t word) {
      if (C > 1) {
        for (int d = 0; d < C; ++d) cluster.map_shared_rank(xs, d)[r * a.kwp + c] = word;
      } else {
        xs[r * a.kwp + c] = word;
      }
    };
    if (!a.fused) {  // copies, all in flight at once
      const uint32_t* xw = static_cast<const uint32_t*>(a.x);
      if (a.vec_x) {
        for (int i = threadIdx.x; i < BM * (Kw / 4); i += kThreads) {
          const int r = i / (Kw / 4), c = 4 * (i - r * (Kw / 4));
          uint4* dst = reinterpret_cast<uint4*>(xs + r * a.kwp + c);
          if (m0 + r < a.M) cp_async<16>(dst, xw + (size_t)(m0 + r) * Kw + c);
          else *dst = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        for (int i = threadIdx.x; i < total; i += kThreads) {
          const int r = i / Kw, c = i - r * Kw;
          if (m0 + r < a.M) cp_async<4>(xs + r * a.kwp + c, xw + (size_t)(m0 + r) * Kw + c);
          else xs[r * a.kwp + c] = 0u;
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      // a quad of lanes builds a word (lane q: bits 8 q .. 8 q + 7), a warp
      // 8 words a step; U steps' loads are issued before their compares
      constexpr int U = 4;
      const int q = lane & 3;
      for (int w0 = warp * 8; w0 < total; w0 += kWarps * 8 * U) {
        float xv[U][8], bv[U][8];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = w0 + u * kWarps * 8 + (lane >> 2);
          const int r = i / nw, c = w_lo + i - r * nw;
          const int k0 = 32 * c + 8 * q;
          const bool in = i < total && m0 + r < a.M;
          const size_t row = (size_t)(m0 + r) * a.K;
          if (in && a.vec_x && 32 * c + 32 <= a.K) {
            ld8(a.x, row + k0, a.x_dt, xv[u]);
            ld8(a.bias, k0, a.b_dt, bv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const bool ok = in && k0 + j < a.K;  // past K or M: bit 0
              xv[u][j] = ok ? ld_f32(a.x, row + k0 + j, a.x_dt) : -1.f;
              bv[u][j] = ok ? ld_f32(a.bias, k0 + j, a.b_dt) : 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          uint32_t part = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) part |= (uint32_t)(xv[u][j] + bv[u][j] >= 0.f) << j;
          part <<= 8 * q;
          part |= __shfl_xor_sync(0xffffffffu, part, 1);
          part |= __shfl_xor_sync(0xffffffffu, part, 2);
          const int i = w0 + u * kWarps * 8 + (lane >> 2);
          if (q == 0 && i < total) {
            const int r = i / nw;
            put(r, w_lo + i - r * nw, part);
          }
        }
      }
    }
    for (int i = threadIdx.x; i < BM * (8 * n_slabs - Kw); i += kThreads) {
      const int r = i / (8 * n_slabs - Kw);
      xs[r * a.kwp + Kw + (i - r * (8 * n_slabs - Kw))] = 0u;
    }
    if (C > 1) cluster.sync();  // every rank's words are in every rank's shared memory
    else __syncthreads();
  }

  float sa = 1.f, sw = 1.f;
  if (a.fused) {
    sa = ld_f32(a.scale_a, 0, a.sa_dt);
    sw = ld_f32(a.scale_w, 0, a.sw_dt);
  }
  const uint32_t* xrow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) xrow[mt] = xs + (mt * 8 + g) * a.kwp + t;

  for (;;) {
    if ((blockIdx.x * a.tpb + tile) * bn >= a.N) break;  // uniform across the block
    int acc[MT][NT][4], px[MT], pw[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      px[mt] = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) pw[nt][0] = pw[nt][1] = 0;

    int st = 0;
    for (int i = s_lo; i < s_hi; ++i) {
      cp_async_wait<kDepth - 2>();  // slab i has landed (this lane's copies)
      __syncwarp();                 // ... and every lane's
      const uint32_t* stage = reinterpret_cast<const uint32_t*>(ring + st * UNITS);
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        b[mt][0] = xrow[mt][8 * i];
        b[mt][1] = xrow[mt][8 * i + 4];
        px[mt] += __popc(b[mt][0]) + __popc(b[mt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t af[4] = {stage[(16 * nt + g) * 4 + t], stage[(16 * nt + 8 + g) * 4 + t],
                                stage[(CW + 16 * nt + g) * 4 + t], stage[(CW + 16 * nt + 8 + g) * 4 + t]};
        pw[nt][0] += __popc(af[0]) + __popc(af[2]);
        pw[nt][1] += __popc(af[1]) + __popc(af[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_b1_and(acc[mt][nt], af, b[mt][0], b[mt][1]);
      }
      __syncwarp();  // every lane has read the stage before it is refilled
      issue();
      if (++st == kDepth) st = 0;
    }
    cp_async_wait<0>();

    // this run's +-1 dots: 32 words - 2 popc(x) - 2 popc(w) + 4 popc(x & w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      px[mt] += __shfl_xor_sync(0xffffffffu, px[mt], 1);
      px[mt] += __shfl_xor_sync(0xffffffffu, px[mt], 2);  // row mt * 8 + g, in its quad
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pw[nt][h] += __shfl_xor_sync(0xffffffffu, pw[nt][h], 1);
        pw[nt][h] += __shfl_xor_sync(0xffffffffu, pw[nt][h], 2);  // column nt * 16 + g + 8 h
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int p0 = __shfl_sync(0xffffffffu, px[mt], 8 * t);      // row mt * 8 + 2 t
      const int p1 = __shfl_sync(0xffffffffu, px[mt], 8 * t + 4);  // row mt * 8 + 2 t + 1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[mt][nt][j] = 32 * run_words - 2 * ((j & 1) ? p1 : p0) - 2 * pw[nt][j >> 1] +
                           4 * acc[mt][nt][j];
    }

    if (a.wk > 1) {  // the K runs' partials meet in shared memory
      __syncthreads();  // every ring is drained: the partials reuse them
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) red[(warp * R + (mt * NT + nt) * 4 + j) * 32 + lane] = acc[mt][nt][j];
      __syncthreads();
      if (wki == 0) {
        for (int w2 = 1; w2 < a.wk; ++w2)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[mt][nt][j] += red[((warp + w2) * R + (mt * NT + nt) * 4 + j) * 32 + lane];
      }
      __syncthreads();  // read before the next tile's ring or partials
    }
    if (wki == 0) {
      const int pad = 32 * Kw - a.K;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = m0 + mt * 8 + 2 * t + (j & 1);
            const int n = n0 + nt * 16 + g + 8 * (j >> 1);
            if (m < a.M && n < a.N) {
              float v = (float)(acc[mt][nt][j] - pad);
              if (a.fused) v = __fmul_rn(__fmul_rn(v, sa), sw);
              store_out(a, (size_t)m * a.N + n, v);
            }
          }
    }
    if (++tile == a.tpb) break;
    start_tile();
    if ((blockIdx.x * a.tpb + tile) * bn < a.N) {
#pragma unroll
      for (int p = 0; p < kDepth - 1; ++p) issue();
    }
  }
}

template <int MT, int NT>
size_t smem_bytes(int kwp) {
  const size_t ring = (size_t)kWarps * kDepth * 32 * NT * 16;
  const size_t red = (size_t)red_words<MT, NT>() * 4;
  return (size_t)MT * 8 * kwp * 4 + (ring > red ? ring : red);
}

template <int MT, int NT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<MT, NT>(a.kwp);
  if (smem > (size_t)kMaxShared) return cudaErrorInvalidValue;
  auto kern = xnor_mma_kernel<MT, NT, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int bn = (kWarps / a.wk) * 16 * NT * a.tpb;
  const int gx = (a.N + bn - 1) / bn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((gx + a.cluster - 1) / a.cluster * a.cluster, (a.M + MT * 8 - 1) / (MT * 8));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(int mt, const Args& a, cudaStream_t s) {
  switch (mt) {
    case 1: return launch<1, 1, VEC>(a, s);
    case 2: return launch<2, 1, VEC>(a, s);
    case 4: return launch<4, 2, VEC>(a, s);
    case 8: return launch<8, 2, VEC>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int mt, int vec_w, Args& a, void* stream) {
  if (a.wk != 1 && a.wk != 2 && a.wk != 4 && a.wk != 8) return cudaErrorInvalidValue;
  if (a.tpb < 1 || (a.cluster != 1 && a.cluster != 2 && a.cluster != 4 && a.cluster != 8))
    return cudaErrorInvalidValue;
  a.kwp = (a.Kw + 7) / 8 * 8 + 4;  // an odd multiple of 4
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec_w ? dispatch<true>(mt, a, s) : dispatch<false>(mt, a, s);
}

}  // namespace

// x (M, Kw), w (N, Kw) int32 sign words; out (M, N) f32.  mt: rows of a row
// tile / 8 (its column tile is 16 columns to mt 2, else 32); wk, tpb: the
// plan (ops/cuda/binary_gemm.py xnor_plan; no cluster: copying the words
// is cheap); vec_x, vec_w: Kw % 4 == 0 and x, w 16-byte aligned.
extern "C" int bte_xnor_gemm(const void* x, const void* w, void* out, int M, int N, int Kw,
                             int k_logical, int mt, int wk, int tpb, int vec_x, int vec_w,
                             void* stream) {
  Args a = {};
  a.x = x;
  a.w = static_cast<const uint32_t*>(w);
  a.out = out;
  a.M = M; a.N = N; a.K = k_logical; a.Kw = Kw;
  a.fused = 0;
  a.vec_x = vec_x;
  a.wk = wk; a.tpb = tpb; a.cluster = 1;
  return (int)run(mt, vec_w, a, stream);
}

// The packed binary linear: x (M, K) of x_dt, bias (K,) of b_dt, scale_a
// and scale_w one value each (their dtypes), w (N, Kw) sign words; out (M,
// N) of x_dt.  vec_x: K % 8 == 0 and x, bias 16-byte aligned.
extern "C" int bte_binary_packed_linear(const void* x, int x_dt, const void* bias, int b_dt,
                                        const void* scale_a, int sa_dt, const void* scale_w,
                                        int sw_dt, const void* w, void* out, int M, int N, int K,
                                        int Kw, int mt, int wk, int tpb, int cluster, int vec_x,
                                        int vec_w, void* stream) {
  Args a = {};
  a.x = x; a.bias = bias; a.scale_a = scale_a; a.scale_w = scale_w;
  a.w = static_cast<const uint32_t*>(w);
  a.out = out;
  a.M = M; a.N = N; a.K = K; a.Kw = Kw;
  a.fused = 1;
  a.x_dt = x_dt; a.b_dt = b_dt; a.sa_dt = sa_dt; a.sw_dt = sw_dt;
  a.vec_x = vec_x;
  a.wk = wk; a.tpb = tpb; a.cluster = cluster;
  return (int)run(mt, vec_w, a, stream);
}

// The issue rate of the 1-bit product against the int8 one, for kernel 8's
// operation bound: each warp runs `iters` rounds of 8 independent products
// of one kind (b1: mma_b1_and, else mma_u8s8) on register operands, and
// writes its lanes' sums so that none is dropped.
template <bool B1>
__global__ void __launch_bounds__(kThreads) mma_rate_probe_kernel(int iters, int* out) {
  const uint32_t s = threadIdx.x * 2654435761u + blockIdx.x;
  const uint32_t a[4] = {s, s ^ 0x9e3779b9u, s * 3u, ~s};
  int c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (B1) mma_b1_and(c[j], a, a[j & 3], a[(j + 1) & 3]);
      else mma_u8s8(c[j], a, a[j & 3], a[(j + 1) & 3]);
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

// blocks x 8 warps x iters x 8 products of the 1-bit (b1 != 0) or int8
// kind; out holds blocks x 256 int32.
extern "C" int bte_mma_rate_probe(int b1, int blocks, int iters, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (b1) mma_rate_probe_kernel<true><<<blocks, kThreads, 0, s>>>(iters, o);
  else mma_rate_probe_kernel<false><<<blocks, kThreads, 0, s>>>(iters, o);
  return (int)cudaGetLastError();
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
