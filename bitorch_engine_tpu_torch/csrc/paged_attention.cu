// Paged prefix attention for Hopper (sm_90a), with an optional in-place
// write of the step's new token.
//
// Replaces bitorch_engine_tpu/ops/pallas/paged_attention.py:_paged_kernel
// (both of its wrappers: paged_prefix_attention and
// paged_prefix_attention_update).  For every slot t, KV head g and query
// row r of q (b, nkv, rs, hd) it returns the unnormalised streaming-softmax
// state over the slot's cached prefix, read from the pages that the page
// table names:
//   s[j] = (q_r . k_j) * sm_scale [* k_scale[t, j, g]]  for j < cache_len[t]
//   m    = max_j s[j]                  (-1e30 when no position is valid)
//   p[j] = exp(s[j] - m),  l = sum_j p[j]
//   acc  = sum_j bf16(p[j] [* v_scale[t, j, g]]) * v_j          (f32)
// Positions j >= cache_len[t] are masked: the reference gives them p = 0
// exactly, so the kernel does not read them at all.  The int8 codes enter
// the dot as their exact f32 value (what the reference's cast to the bf16
// working dtype gives), and the per-position scales factor out of both
// contractions as in the reference.
//
// Layouts (models/paged_kv.py): pools (num_pages, ps, nkv * hd), int8 or
// bf16, hd = 128 (every Llama configuration of the repo), token-major, so head g of position j is hd contiguous elements of
// page table[t, j / ps], row j % ps; scales (b, scale_len, nkv) f32 dense
// per slot (the window is their prefix); table (b, >= P) int32 with row
// stride table_stride; cache_len (b,) int32.
//
// Three kernels, the route picked by the wrapper from the call's form
// (ops/cuda/paged_attention.py kernel_route): paged_chunk_kernel for every
// read-only call (the chunked prefill's prefix); paged_decode_kernel for the
// write-back form with at most 8 query rows (every decode step of the
// repo's Llama configurations) where a cluster of at most 4 blocks fits its
// share of the window in shared memory; else paged_attention_kernel (the
// write-back form past about 16K positions at 8 rows, 29K at 4).
//
// paged_attention_kernel.  One block per (tile of R query rows, KV head,
// slot); 256 threads.  The reference forms p against the row max of the WHOLE window
// and rounds p to bf16 before the PV product, so a one-pass online softmax
// (rounding p against a running max) would drift from it.  The block keeps
// its R x W f32 scores in shared memory and makes two passes: pass 1 walks
// the K pages (one key per thread, R dot products from the q tile in shared
// memory), the row pass takes m and l per row (one warp per row) and
// overwrites the scores with the rounded p; pass 2 walks the V pages (a
// warp reads a head row, each lane 4 columns) and
// accumulates acc with several V rows in flight; the 8 warps split the
// keys (all of them at decode, where R = 4) and add their parts in shared
// memory.  The window's table row is staged in shared memory first.
//
// Write-back (k_new != nullptr, one query token per slot): after its reads,
// row tile 0 of block (t, g) writes head g's hd slice of k_new[t] and
// v_new[t] into page table[t, min(cache_len / ps, P - 1)], row
// cache_len % ps.  That position is masked for every reader, slots own
// disjoint pages and heads write disjoint columns, so no block reads what
// another writes.  Inactive slots all point at the null page 0 and write
// its row 0 together: a race on inert data, as on the TPU.
//
// Bound on the H100: bytes at decode.  One launch reads the valid K and V
// rows (b8, window 512, int8, nkv * hd = 1024: ~8.4 MB), their scales and
// q, ~2.6 us at 3.35 TB/s.  This kernel uses f32 CUDA-core FMAs and no
// asynchronous copies (336 us a launch on the H100 at the chunk shape below,
// where paged_chunk_kernel now runs).
//
// paged_chunk_kernel (read-only, any rs).  At chunked prefill (b8, 8 KV
// heads, rs = 4 query heads x 256 tokens = 1024 rows, window 256) the dots
// dominate: 2 products of 4.3 GFLOP each, bound by the bf16 tensor-core
// rate.  The function is kernel 3's (csrc/flash_attention.cu) with p
// rounded against the WHOLE window's max, so this is kernel 3's body: a
// block is 4 warps over 64 query rows of one (KV head, slot) (the 4 query
// heads of a KV head are folded into rs, so K and V are read once per 64
// rows); a key tile is 64 positions (one page at ps 64; each row's page is
// looked up, so any ps works), streamed through a 2-stage cp.async ring;
// every product is mma.sync.m16n8k16 bf16 -> f32 with ldmatrix operands, q
// in registers as A fragments.  Two sweeps over the window's tiles: sweep 1
// computes q k^T for the row max, sweep 2 computes it again (bit for bit the
// same scores) and forms p = exp(s - m) (expf, as the reference's exp), l on
// the unrounded p, then p [* v_scale] rounded to bf16 as it is packed into
// the A fragments of the P V product.  No score slab, so no window limit:
// 3 products where 2 are needed, the price of rounding p as the reference
// does.  int8 pools: the block converts each raw K and V tile into a bf16
// tile once (i8x4_to_bf16x4: exact), shared by its 4 warps; bf16 pools go
// to the ring tiles directly.  Positions past the valid prefix and rows past
// rs are copied as zeros (cp.async with a source size of 0) and masked or
// never stored; a slot with cache_len 0 runs no step and stores m = -1e30,
// l = 0, acc = 0.
//
// paged_decode_kernel (write-back, rs <= 8).  The first kernel gave b * nkv
// blocks at decode (64 at b8 on 132 SMs), each walking its whole window
// with a few bytes in flight: 55 us a launch on the H100 against a ~1 us
// bound.  Here a
// cluster of S blocks (host: paged_attention.window_splits) shares each
// (KV head, slot); rank r takes the r-th contiguous share of the slot's
// valid pages.  A plain split (flash-decoding, each part rounding p against
// its own max) would drift from the reference, which rounds p against the
// WHOLE window's max, so the ranks meet twice:
//   1. each rank streams its K rows through a 32 KB ring of chunks of 64
//      positions in shared memory (cp.async, 16 bytes a thread, all but
//      one chunk ahead), scores them (16 lanes a position, 8 columns a lane,
//      q in registers, a 4-step shuffle sum) into its R x span score slab
//      and takes its rows' local max; its span's k / v scales are read
//      into shared memory up front, all at once;
//   2. cluster.sync(); every rank reads the S local maxes through
//      distributed shared memory (map_shared_rank) and forms the window's
//      m, then p = exp(s - m) [* v_scale] rounded to bf16 and its part of l,
//      exactly as the first kernel does;
//   3. it streams its V rows through the same ring (the first chunks
//      issued before the cluster wait), a warp per position, 4 columns a
//      lane, its warps' PV parts summed in warp order;
//   4. cluster.sync(); rank r adds the S partial acc of its slice of the
//      (R, hd) tile in rank order, rank 0 the l parts (the same order);
//      no atomics, reruns bit-equal;
//   5. rank 0 writes k_new / v_new (every rank's reads are over), and a last
//      cluster.sync() keeps each block's shared memory alive for its peers.
// Only the f32 order of the dots, of l and of acc changes.  What holds it
// back now: launching a cluster and its three synchronisations cost a few
// microseconds that grow with S (so S <= 4), against a ~1 us bound.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr float PA_MASK = -1e30f;  // the reference's finite mask value

// N elements at p (N * sizeof(T) bytes, aligned to that size up to 16) → f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES % 4 == 0, "whole 32-bit words");
  uint32_t w[BYTES / 4];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (sizeof(T) == 1) {
      out[k] = (float)(int8_t)((w[k / 4] >> (8 * (k % 4))) & 0xffu);
    } else {
      out[k] = __uint_as_float(((w[k / 2] >> (16 * (k % 2))) & 0xffffu) << 16);
    }
  }
}

// N elements at p in shared memory (N * sizeof(T) = 4, 8 or 16 bytes,
// aligned to that) → f32.
template <typename T, int N>
__device__ __forceinline__ void load_smem_f32(const T* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  uint32_t w[4];
  if constexpr (BYTES == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    static_assert(BYTES == 4, "4, 8 or 16 bytes");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (sizeof(T) == 1) {
      out[k] = (float)(int8_t)((w[k / 4] >> (8 * (k % 4))) & 0xffu);
    } else {
      out[k] = __uint_as_float(((w[k / 2] >> (16 * (k % 2))) & 0xffffu) << 16);
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q, T* k_pool, T* v_pool,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const int* __restrict__ table, const int* __restrict__ cache_len,
                       const T* __restrict__ k_new, const T* __restrict__ v_new,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int nkv, int rs, int ps, int P,
                       int table_stride, int scale_len, float sm_scale) {
  constexpr int CPL = HD / 32;                   // output columns per lane
  constexpr int RPW = R < PA_WARPS ? R : PA_WARPS;  // rows per warp in pass 2
  constexpr int GR = R / RPW;                    // row groups in pass 2
  constexpr int NJ = PA_WARPS / GR;              // key splits in pass 2
  constexpr int U = 4;                           // V rows in flight per warp
  // the pools are not __restrict__: the write-back stores into them (at a
  // position no block reads)

  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);  // (R, HD)
  float* red = q_s + R * HD;                        // (NJ, R, HD) parts of acc
  float* s_s = red + NJ * R * HD;                   // (R, W) scores, then p
  int* tbl_s = reinterpret_cast<int*>(s_s + R * P * ps);  // (P,) the window's pages

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * R;
  const int g = blockIdx.y;
  const int t = blockIdx.z;
  const int rows = min(R, rs - r0);
  const int W = P * ps;
  const int F = nkv * HD;  // pool row width
  const int clen = cache_len[t];
  const int nv = min(max(clen, 0), W);
  const bool quant = k_scale != nullptr;
  const size_t head_row0 = ((size_t)t * nkv + g) * rs + r0;

  for (int i = tid; i < R * HD; i += PA_THREADS) {
    const int r = i / HD;
    q_s[i] = r < rows ? __bfloat162float(q[(head_row0 + r) * HD + i % HD]) : 0.f;
  }
  for (int i = tid; i < P; i += PA_THREADS) tbl_s[i] = table[(size_t)t * table_stride + i];
  __syncthreads();

  // pass 1: scores of every valid key, one key per thread
  for (int j = tid; j < nv; j += PA_THREADS) {
    const T* krow = k_pool + ((size_t)tbl_s[j / ps] * ps + j % ps) * F + g * HD;
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < HD; c += 16) {
      float kf[16];
      load_f32<T, 16>(krow + c, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + r * HD + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 x = qv[e];
          sc[r] = fmaf(x.x, kf[4 * e], sc[r]);
          sc[r] = fmaf(x.y, kf[4 * e + 1], sc[r]);
          sc[r] = fmaf(x.z, kf[4 * e + 2], sc[r]);
          sc[r] = fmaf(x.w, kf[4 * e + 3], sc[r]);
        }
      }
    }
    const float ks = quant ? __ldg(k_scale + ((size_t)t * scale_len + j) * nkv + g) : 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s = sc[r] * sm_scale;
      s_s[r * W + j] = quant ? s * ks : s;
    }
  }
  __syncthreads();

  // row pass: m and l per row, scores replaced by bf16(p [* v_scale])
  for (int r = warp; r < rows; r += PA_WARPS) {
    float* srow = s_s + r * W;
    float mx = PA_MASK;
    for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < nv; j += 32) {
      const float p = expf(srow[j] - mx);
      sum += p;
      const float vs = quant ? __ldg(v_scale + ((size_t)t * scale_len + j) * nkv + g) : 1.f;
      srow[j] = round_bf16(quant ? p * vs : p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_out[head_row0 + r] = mx;
      l_out[head_row0 + r] = sum;
    }
  }
  __syncthreads();

  // pass 2: acc = P V; warp (rg, js) takes rows rg * RPW + i and keys
  // js + k * NJ, U of them in flight, then the NJ key splits are added
  const int rg = warp % GR, js = warp / GR;
  float acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  for (int j0 = js; j0 < nv; j0 += NJ * U) {
    float vf[U][CPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NJ;
      if (j < nv) {
        load_f32<T, CPL>(v_pool + ((size_t)tbl_s[j / ps] * ps + j % ps) * F + g * HD + lane * CPL,
                         vf[u]);
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) vf[u][c] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NJ;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float p = j < nv ? s_s[(rg * RPW + i) * W + j] : 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(p, vf[u][c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      red[((size_t)js * R + rg * RPW + i) * HD + lane * CPL + c] = acc[i][c];
  __syncthreads();
  for (int i = tid; i < rows * HD; i += PA_THREADS) {
    float s = 0.f;
    for (int k = 0; k < NJ; ++k) s += red[(size_t)k * R * HD + i];
    acc_out[head_row0 * HD + i] = s;
  }

  if (k_new != nullptr && blockIdx.x == 0) {
    const int wp = min(max(clen, 0) / ps, P - 1);
    const size_t dst = ((size_t)tbl_s[wp] * ps + max(clen, 0) % ps) * F + g * HD;
    const size_t src = (size_t)t * F + g * HD;
    for (int i = tid; i < HD; i += PA_THREADS) {
      k_pool[dst + i] = k_new[src + i];
      v_pool[dst + i] = v_new[src + i];
    }
  }
}

constexpr int DEC_CH = 64;  // positions of a ring chunk
// the ring: 32 KB, 4 chunks of int8 rows or 2 of bf16 rows (deeper or
// larger rings measured no faster on the card, PERF.md §6)
constexpr int DEC_RING_BYTES = 32 * 1024;

// Shared memory of paged_decode_kernel (floats, then the table row): the
// ring, the R x span scores, the span's k and v scales, the warps' PV
// parts, the rank's acc part and its m / l parts.
size_t dec_smem_bytes(int R, int HD, int span, int P) {
  return DEC_RING_BYTES +
         ((size_t)(R + 2) * span + (size_t)PA_WARPS * R * HD + (size_t)R * HD + 2 * R) *
             sizeof(float) +
         (size_t)P * sizeof(int);
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(PA_THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, T* k_pool, T* v_pool,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ table, const int* __restrict__ cache_len,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int nkv, int rs, int ps, int P, int table_stride,
                    int scale_len, float sm_scale, int n_split, int span_cap) {
  constexpr int UPR = HD * (int)sizeof(T) / 16;  // 16-byte units of a head row
  constexpr int ROWB = HD * (int)sizeof(T);      // bytes of a head row
  constexpr int STAGE = DEC_CH * ROWB;           // bytes of a ring chunk
  constexpr int D = DEC_RING_BYTES / STAGE;      // ring depth (chunks)
  constexpr int CPL = 4;                         // PV columns per lane
  static_assert(HD == 128 && R <= PA_WARPS, "hd 128, one warp per query row");
  static_assert(PA_THREADS == 16 * 16 && DEC_CH % 16 == 0, "16 lanes score each position");
  static_assert(D >= 2, "the ring holds at least two chunks");
  // the pools are not __restrict__: rank 0 stores the new row into them, at
  // a position no block reads

  extern __shared__ float4 smem_f4[];
  char* ring = reinterpret_cast<char*>(smem_f4);
  float* s_s = reinterpret_cast<float*>(ring + DEC_RING_BYTES);  // (R, span_cap)
  float* ks_s = s_s + R * span_cap;      // (span_cap,) k scales of the span
  float* vs_s = ks_s + span_cap;         // (span_cap,) v scales of the span
  float* red = vs_s + span_cap;          // (PA_WARPS, R, HD) the warps' PV parts
  float* part = red + PA_WARPS * R * HD; // (R, HD) this rank's acc
  float* m_loc = part + R * HD;          // (R,) this rank's row maxes
  float* l_loc = m_loc + R;              // (R,) this rank's part of l
  int* tbl_s = reinterpret_cast<int*>(l_loc + R);  // (P,) the window's pages

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = blockIdx.x;  // the cluster spans x: blockIdx.x is the rank
  const int g = blockIdx.y;
  const int t = blockIdx.z;
  const int F = nkv * HD;  // pool row width
  const int clen = max(cache_len[t], 0);
  const int nv = min(clen, P * ps);
  const bool quant = k_scale != nullptr;
  const size_t head_row0 = ((size_t)t * nkv + g) * rs;
  // this rank's share of the valid pages, as positions [lo, hi)
  const int nvp = (nv + ps - 1) / ps;
  const int lo = rank * nvp / n_split * ps;
  const int hi = min((rank + 1) * nvp / n_split * ps, nv);
  const int n_chunks = hi > lo ? (hi - lo + DEC_CH - 1) / DEC_CH : 0;

  // the lane's 8 columns of q (see pass 1) in registers, the table row and
  // the span's scales in shared memory
  const int jq = tid / 16, l16 = tid % 16;
  float qr[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rs) {
      load_f32<__nv_bfloat16, 8>(q + (head_row0 + r) * HD + l16 * 8, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.f;
    }
  }
  for (int i = tid; i < P; i += PA_THREADS) tbl_s[i] = table[(size_t)t * table_stride + i];
  if (quant) {
    for (int i = tid; i < hi - lo; i += PA_THREADS) {
      const size_t at = ((size_t)t * scale_len + lo + i) * nkv + g;
      ks_s[i] = __ldg(k_scale + at);
      vs_s[i] = __ldg(v_scale + at);
    }
  }
  __syncthreads();

  // chunk c of this rank's positions (of pool `pool`) into ring stage c % D;
  // one commit group per chunk slot, empty past the last chunk
  auto issue = [&](const T* pool, int c) {
    if (c < n_chunks) {
      char* st = ring + (c % D) * STAGE;
      const int c0 = lo + c * DEC_CH;
      for (int u = tid; u < DEC_CH * UPR; u += PA_THREADS) {
        const int jj = u / UPR, col = u % UPR, j = c0 + jj;
        if (j < hi)
          cp_async<16>(st + jj * ROWB + col * 16,
                     pool + ((size_t)tbl_s[j / ps] * ps + j % ps) * F + g * HD + col * (16 / sizeof(T)));
      }
    }
    cp_async_commit();
  };

  // 1. scores: positions jq and jq + 16 of a chunk to the 16 lanes tid / 16,
  // each lane the 8 columns l16 * 8 .. + 7
  for (int p = 0; p < D - 1; ++p) issue(k_pool, p);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<D - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();             // everyone's copies; stage (c - 1) % D is free
    issue(k_pool, c + D - 1);
#pragma unroll
    for (int h = 0; h < DEC_CH / 16; ++h) {
      const int jc = h * 16 + jq, j = lo + c * DEC_CH + jc;
      float kf[8];
      load_smem_f32<T, 8>(
          reinterpret_cast<const T*>(ring + (c % D) * STAGE + jc * ROWB) + l16 * 8, kf);
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qr[r][e], kf[e], a);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        dot[r] = a;
      }
      if (l16 == 0 && j < hi) {
        const float ks = quant ? ks_s[j - lo] : 1.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sc = dot[r] * sm_scale;
          s_s[r * span_cap + j - lo] = quant ? sc * ks : sc;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free, the scores are in
  for (int p = 0; p < D - 1; ++p) issue(v_pool, p);  // V's first chunks, ahead of the wait

  // the rank's row maxes
  const int span = hi - lo;
  if (warp < R) {
    float mx = PA_MASK;
    for (int j = lane; j < span; j += 32) mx = fmaxf(mx, s_s[warp * span_cap + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) m_loc[warp] = mx;
  }
  // 2. the window's max from every rank, then p rounded against it
  if (n_split > 1) cluster.sync();
  else __syncthreads();
  if (warp < R) {
    float mx = PA_MASK;
    for (int r = 0; r < n_split; ++r)
      mx = fmaxf(mx, n_split > 1 ? cluster.map_shared_rank(m_loc, r)[warp] : m_loc[warp]);
    float* srow = s_s + warp * span_cap;
    float sum = 0.f;
    for (int j = lane; j < span; j += 32) {
      const float p = expf(srow[j] - mx);
      sum += p;
      const float vs = quant ? vs_s[j] : 1.f;
      srow[j] = round_bf16(quant ? p * vs : p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) l_loc[warp] = sum;
  }

  // 3. PV: warp w takes positions w, w + 8, ... of each chunk, lane 4 columns
  float acc[R][CPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[r][e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<D - 2>();
    __syncthreads();  // (the first pass also sees every row's p)
    issue(v_pool, c + D - 1);
    const char* st = ring + (c % D) * STAGE;
#pragma unroll
    for (int i = 0; i < DEC_CH / PA_WARPS; ++i) {
      const int jc = warp + i * PA_WARPS, jr = c * DEC_CH + jc;  // jr: rank-relative
      if (lo + jr < hi) {
        float vf[CPL];
        load_smem_f32<T, CPL>(reinterpret_cast<const T*>(st + jc * ROWB) + lane * CPL, vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = s_s[r * span_cap + jr];
#pragma unroll
          for (int e = 0; e < CPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < CPL; ++e) red[((size_t)warp * R + r) * HD + lane * CPL + e] = acc[r][e];
  __syncthreads();
  for (int i = tid; i < R * HD; i += PA_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) sum += red[(size_t)w * R * HD + i];
    part[i] = sum;
  }

  // 4. the ranks' parts, added in rank order
  if (n_split > 1) cluster.sync();
  else __syncthreads();
  auto peer = [&](float* p_, int r) { return n_split > 1 ? cluster.map_shared_rank(p_, r) : p_; };
  const int per = (rs * HD + n_split - 1) / n_split;
  for (int i = rank * per + tid; i < min(rs * HD, (rank + 1) * per); i += PA_THREADS) {
    float sum = 0.f;
    for (int r = 0; r < n_split; ++r) sum += peer(part, r)[i];
    acc_out[head_row0 * HD + i] = sum;
  }
  if (rank == 0 && tid < rs) {
    float mx = PA_MASK, sum = 0.f;
    for (int r = 0; r < n_split; ++r) {
      mx = fmaxf(mx, peer(m_loc, r)[tid]);
      sum += peer(l_loc, r)[tid];
    }
    m_out[head_row0 + tid] = mx;
    l_out[head_row0 + tid] = sum;
  }

  // 5. the new token, once every rank's reads are over
  if (rank == 0) {
    const int wp = min(clen / ps, P - 1);
    const size_t dst = ((size_t)tbl_s[wp] * ps + clen % ps) * F + g * HD;
    const size_t src = (size_t)t * F + g * HD;
    for (int i = tid; i < HD; i += PA_THREADS) {
      k_pool[dst + i] = k_new[src + i];
      v_pool[dst + i] = v_new[src + i];
    }
  }
  if (n_split > 1) cluster.sync();  // no block leaves while a peer reads its shared memory
}

// ---------------------------------------------------------------------------
// paged_chunk_kernel: kernel 3's tensor-core body (csrc/flash_attention.cu,
// its helpers in mma_common.cuh) over a paged window.

constexpr int PC_TILE = 64;                           // query rows a block, positions a key tile
constexpr int PC_THREADS = 128;                       // 4 warps of 16 query rows
constexpr int PC_LD = 128 + 8;                        // padded bf16 row of a tile (elements)
constexpr int PC_TILE_BYTES = PC_TILE * PC_LD * 2;    // one padded bf16 tile
constexpr int PC_RAW_BYTES = PC_TILE * 128;           // one int8 tile as the pool holds it

// cp.async of 16 (or 4) bytes that writes zeros instead where !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Four signed int8 codes (one word, byte b = element b) as four bf16, exactly:
// byte x + 128 becomes the low mantissa bits of 2^23 in f32, less 2^23 + 128
// leaves x, and an integer of at most 8 significant bits keeps its low 16
// f32 bits zero, so its upper half is its bf16.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// An int8 tile (64 rows of 128 codes) into a padded bf16 tile, 8 codes a
// thread at a time (8-byte reads, 16-byte writes: no bank conflicts).
__device__ __forceinline__ void convert_tile(const char* raw, bf16* dst) {
#pragma unroll
  for (int i = 0; i < PC_TILE * 16 / PC_THREADS; ++i) {
    const int u = threadIdx.x + i * PC_THREADS, row = u / 16, c = u % 16;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + row * 128 + c * 8);
    const uint2 lo = i8x4_to_bf16x4(w.x), hi = i8x4_to_bf16x4(w.y);
    *reinterpret_cast<uint4*>(dst + row * PC_LD + c * 8) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// Shared memory of paged_chunk_kernel.  int8 pools: the converted K and V
// tiles, a 2-stage ring of raw K and V tiles and a 3-stage ring of their
// 64 k and v scales (read after the conversion's barrier, so a stage is
// refilled only two steps later).  bf16 pools: a 2-stage ring of K and V
// tiles.
template <typename T>
constexpr int chunk_smem_bytes() {
  return sizeof(T) == 1 ? 2 * PC_TILE_BYTES + 4 * PC_RAW_BYTES + 3 * 2 * PC_TILE * 4
                        : 4 * PC_TILE_BYTES;
}

template <typename T>
__global__ void __launch_bounds__(PC_THREADS, 3)  // 3 blocks an SM (measured faster than 2)
paged_chunk_kernel(const bf16* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ table,
                   const int* __restrict__ cache_len, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int nkv, int rs, int ps,
                   int P, int table_stride, int scale_len, float sm_scale) {
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int UPR = 128 * (int)sizeof(T) / 16;  // 16-byte units of a head row
  extern __shared__ float4 smem_f4[];
  char* sm = reinterpret_cast<char*>(smem_f4);
  // stage s of the ring: its K and V tiles (raw int8, or padded bf16)
  auto k_tile = [&](int s) {
    return Q8 ? sm + 2 * PC_TILE_BYTES + s * 2 * PC_RAW_BYTES : sm + s * 2 * PC_TILE_BYTES;
  };
  auto v_tile = [&](int s) { return k_tile(s) + (Q8 ? PC_RAW_BYTES : PC_TILE_BYTES); };
  float* sc_ring = reinterpret_cast<float*>(sm + 2 * PC_TILE_BYTES + 4 * PC_RAW_BYTES);
  bf16* kb = reinterpret_cast<bf16*>(sm);  // int8 pools: the converted tiles
  bf16* vb = kb + PC_TILE * PC_LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * PC_TILE;
  const int hg = blockIdx.y;
  const int t = blockIdx.z;
  const int F = nkv * 128;  // pool row width
  const int nv = min(max(cache_len[t], 0), P * ps);
  const int nt = (nv + PC_TILE - 1) / PC_TILE;
  const int total = 2 * nt;  // sweep 1 (K) then sweep 2 (K and V) over the tiles
  const size_t head_row0 = ((size_t)t * nkv + hg) * rs + r0;
  const int* trow = table + (size_t)t * table_stride;

  // step i: tile i % nt's K rows (and in sweep 2 its V rows) into stage
  // i & 1, its scales into scale stage i % 3; positions past the valid
  // prefix land as zeros
  auto issue = [&](int i) {
    const bool sweep2 = i >= nt;
    const int j0 = (sweep2 ? i - nt : i) * PC_TILE, s = i & 1;
    for (int u = tid; u < PC_TILE * UPR; u += PC_THREADS) {
      const int jj = u / UPR, col = u % UPR, j = j0 + jj;
      const bool ok = j < nv;
      const size_t src =
          (ok ? ((size_t)__ldg(trow + j / ps) * ps + j % ps) * F + hg * 128 : 0) + col * (16 / sizeof(T));
      const int dst = Q8 ? jj * 128 + col * 16 : jj * PC_LD * 2 + col * 16;
      cp_async16_zfill(k_tile(s) + dst, k_pool + src, ok);
      if (sweep2) cp_async16_zfill(v_tile(s) + dst, v_pool + src, ok);
    }
    if constexpr (Q8) {
      if (tid < PC_TILE) {
        const int j = j0 + tid;
        const bool ok = j < nv;
        const size_t at = ok ? ((size_t)t * scale_len + j) * nkv + hg : 0;
        float* st = sc_ring + i % 3 * 2 * PC_TILE;
        cp_async4_zfill(st + tid, k_scale + at, ok);
        if (sweep2) cp_async4_zfill(st + PC_TILE + tid, v_scale + at, ok);
      }
    }
  };

  // the block's 64 query rows (rows past rs as zeros) → the warps' A
  // fragments; the q tile borrows the converted K tile (int8) or stage 1's
  // K tile (bf16)
  bf16* sq = Q8 ? kb : reinterpret_cast<bf16*>(k_tile(1));
  for (int u = tid; u < PC_TILE * 16; u += PC_THREADS) {
    const int r = u / 16, col = u % 16;
    const bool ok = r0 + r < rs;
    cp_async16_zfill(sq + r * PC_LD + col * 8, q + (ok ? (head_row0 + r) * 128 : 0) + col * 8, ok);
  }
  cp_async_commit();
  if (total > 0) issue(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) ldsm_x4(qf[ks], a_addr<PC_LD>(sq, warp * 16, ks * 16, lane));
  __syncthreads();  // the q tile's space is free

  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {PA_MASK, PA_MASK}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp

  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step i's tiles have landed (every thread's copies)
    const bool sweep2 = i >= nt;
    const int j0 = (sweep2 ? i - nt : i) * PC_TILE, s = i & 1;
    const bf16* kt = reinterpret_cast<const bf16*>(k_tile(s));
    const bf16* vt = reinterpret_cast<const bf16*>(v_tile(s));
    const float* ks_s = sc_ring + i % 3 * 2 * PC_TILE;
    const float* vs_s = ks_s + PC_TILE;
    if constexpr (Q8) {
      convert_tile(k_tile(s), kb);
      if (sweep2) convert_tile(v_tile(s), vb);
      __syncthreads();
      kt = kb;
      vt = vb;
    }

    // s = q k^T for the warp's 16 rows and the tile's 64 positions
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, bn_addr<PC_LD>(kt, np * 16, ks * 16, lane));
        mma16816(sc[2 * np], qf[ks], bfr[0], bfr[1]);
        mma16816(sc[2 * np + 1], qf[ks], bfr[2], bfr[3]);
      }
    }
    // the reference's scores: (q . k) * sm_scale [* k_scale], masked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        float x = sc[j][e] * sm_scale;
        if constexpr (Q8) x *= ks_s[c];
        sc[j][e] = j0 + c < nv ? x : PA_MASK;
      }

    if (!sweep2) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) m_row[r] = fmaxf(m_row[r], fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
    } else {
      if (i == nt) {  // the window's max, from the quad's lanes
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
          m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t4 + (e & 1);
          const float p = j0 + c < nv ? expf(sc[j][e] - m_row[e >> 1]) : 0.f;
          l[e >> 1] += p;  // l sums the unrounded p
          if constexpr (Q8) sc[j][e] = p * vs_s[c];
          else sc[j][e] = p;
        }
      // P V: p rounded to bf16 as it is packed into A fragments
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                                pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                                pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                                pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, bt_addr<PC_LD>(vt, kc * 16, np * 16, lane));
          mma16816(o[2 * np], pa, bfr[0], bfr[1]);
          mma16816(o[2 * np + 1], pa, bfr[2], bfr[3]);
        }
      }
    }
    // bf16 pools: the stage is read here, and step i + 2 refills it next;
    // int8 pools: its raw tiles were read before the conversion's barrier,
    // and the next conversion waits at the next step's barrier
    if constexpr (!Q8) __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (r0 + row >= rs) continue;  // rows past rs were computed on zero q
    float* dst = acc_out + (head_row0 + row) * 128;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * t4) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
    if (t4 == 0) {
      m_out[head_row0 + row] = m_row[r];
      l_out[head_row0 + row] = l[r];
    }
  }
}

template <typename T>
cudaError_t launch_chunk(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* table,
                         int table_stride, const void* cache_len, void* acc, void* m, void* l,
                         int b, int nkv, int rs, int ps, int P, int scale_len, float sm_scale,
                         cudaStream_t stream) {
  auto kern = paged_chunk_kernel<T>;
  constexpr int smem = chunk_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rs + PC_TILE - 1) / PC_TILE, nkv, b);
  kern<<<grid, PC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(cache_len), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), nkv, rs, ps, P, table_stride, scale_len,
      sm_scale);
  return cudaGetLastError();
}

// q tile, the key splits' parts of acc (NJ * R = 8 * min(R, 8) rows), the
// scores and the window's table row
size_t smem_bytes(int R, int HD, int P, int ps) {
  const size_t rows_red = (size_t)PA_WARPS * (R < PA_WARPS ? R : PA_WARPS);
  return ((size_t)R * HD + rows_red * HD + (size_t)R * P * ps + P) * sizeof(float);
}

template <typename T, int HD, int R>
cudaError_t launch(const void* q, void* k_pool, void* v_pool, const void* k_scale,
                   const void* v_scale, const void* table, int table_stride,
                   const void* cache_len, const void* k_new, const void* v_new, void* acc,
                   void* m, void* l, int b, int nkv, int rs, int ps, int P, int scale_len,
                   float sm_scale, cudaStream_t stream) {
  auto kern = paged_attention_kernel<T, HD, R>;
  const size_t smem = smem_bytes(R, HD, P, ps);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rs + R - 1) / R, nkv, b);
  kern<<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(cache_len),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), nkv, rs, ps, P,
      table_stride, scale_len, sm_scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rows(int R, const void* q, void* k_pool, void* v_pool,
                        const void* k_scale, const void* v_scale, const void* table,
                        int table_stride, const void* cache_len, const void* k_new,
                        const void* v_new, void* acc, void* m, void* l, int b, int nkv, int rs,
                        int ps, int P, int scale_len, float sm_scale, cudaStream_t st) {
#define PA_CASE(RR)                                                                          \
  case RR:                                                                                   \
    return launch<T, HD, RR>(q, k_pool, v_pool, k_scale, v_scale, table, table_stride,       \
                             cache_len, k_new, v_new, acc, m, l, b, nkv, rs, ps, P, scale_len, \
                             sm_scale, st);
  switch (R) {
    PA_CASE(1) PA_CASE(2) PA_CASE(4) PA_CASE(8) PA_CASE(16) PA_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

template <typename T, int R>
cudaError_t launch_decode(const void* q, void* k_pool, void* v_pool, const void* k_scale,
                          const void* v_scale, const void* table, int table_stride,
                          const void* cache_len, const void* k_new, const void* v_new, void* acc,
                          void* m, void* l, int b, int nkv, int rs, int ps, int P, int scale_len,
                          float sm_scale, int n_split, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, 128, R>;
  const int span_cap = (P + n_split - 1) / n_split * ps;
  const size_t smem = dec_smem_bytes(R, 128, span_cap, P);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, nkv, b);
  cfg.blockDim = dim3(PA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q), static_cast<T*>(k_pool),
      static_cast<T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(cache_len), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), nkv, rs, ps, P, table_stride, scale_len, sm_scale, n_split,
      span_cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_rows(int R, const void* q, void* k_pool, void* v_pool,
                               const void* k_scale, const void* v_scale, const void* table,
                               int table_stride, const void* cache_len, const void* k_new,
                               const void* v_new, void* acc, void* m, void* l, int b, int nkv,
                               int rs, int ps, int P, int scale_len, float sm_scale, int n_split,
                               cudaStream_t st) {
#define PD_CASE(RR)                                                                          \
  case RR:                                                                                   \
    return launch_decode<T, RR>(q, k_pool, v_pool, k_scale, v_scale, table, table_stride,    \
                                cache_len, k_new, v_new, acc, m, l, b, nkv, rs, ps, P,       \
                                scale_len, sm_scale, n_split, st);
  switch (R) {
    PD_CASE(1) PD_CASE(2) PD_CASE(4) PD_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef PD_CASE
}

}  // namespace

// The write-back decode form on paged_decode_kernel: R is rs rounded up to
// a power of 2 (<= 8), n_split the blocks of a cluster per (KV head, slot)
// (1, 2 or 4, at most the window's pages); the wrapper checks shapes and
// dtypes and picks R and n_split so that the shared memory fits
// (ops/cuda/paged_attention.py decode_plan).  Returns the
// launch's error (a cluster the card cannot place included).
extern "C" int bte_paged_decode(const void* q, void* k_pool, void* v_pool, const void* k_scale,
                                const void* v_scale, const void* table, int table_stride,
                                const void* cache_len, const void* k_new, const void* v_new,
                                void* acc, void* m, void* l, int b, int nkv, int rs, int hd,
                                int ps, int P, int scale_len, int pool_int8, int R,
                                int n_split, float sm_scale, void* stream) {
  if (hd != 128 || k_new == nullptr || v_new == nullptr || rs > R || R > 8 ||
      (n_split != 1 && n_split != 2 && n_split != 4) || n_split > P)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_ARGS                                                                                 \
  R, q, k_pool, v_pool, k_scale, v_scale, table, table_stride, cache_len, k_new, v_new, acc, m, \
      l, b, nkv, rs, ps, P, scale_len, sm_scale, n_split, st
  return pool_int8 ? launch_decode_rows<int8_t>(PD_ARGS) : launch_decode_rows<__nv_bfloat16>(PD_ARGS);
#undef PD_ARGS
}

// The read-only form on paged_chunk_kernel, any rs and window; the wrapper
// checks shapes, dtypes, alignment and contiguity
// (ops/cuda/paged_attention.py).  Returns the launch's error.
extern "C" int bte_paged_chunk(const void* q, const void* k_pool, const void* v_pool,
                               const void* k_scale, const void* v_scale, const void* table,
                               int table_stride, const void* cache_len, void* acc, void* m,
                               void* l, int b, int nkv, int rs, int hd, int ps, int P,
                               int scale_len, int pool_int8, float sm_scale, void* stream) {
  if (hd != 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PC_ARGS                                                                                \
  q, k_pool, v_pool, k_scale, v_scale, table, table_stride, cache_len, acc, m, l, b, nkv, rs, ps, \
      P, scale_len, sm_scale, st
  return pool_int8 ? launch_chunk<int8_t>(PC_ARGS) : launch_chunk<__nv_bfloat16>(PC_ARGS);
#undef PC_ARGS
}

// Shapes, dtypes, contiguity and the row tile R (a power of 2 <= 32 whose
// shared memory fits) are checked and chosen by the Python wrapper
// (ops/cuda/paged_attention.py).  k_scale / v_scale are null for bf16
// pools; k_new / v_new are null for the read-only variant.  Returns the
// launch's cudaGetLastError().
extern "C" int bte_paged_attention(const void* q, void* k_pool, void* v_pool,
                                   const void* k_scale, const void* v_scale, const void* table,
                                   int table_stride, const void* cache_len, const void* k_new,
                                   const void* v_new, void* acc, void* m, void* l, int b,
                                   int nkv, int rs, int hd, int ps, int P, int scale_len,
                                   int pool_int8, int R, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                                                 \
  R, q, k_pool, v_pool, k_scale, v_scale, table, table_stride, cache_len, k_new, v_new, acc, m, \
      l, b, nkv, rs, ps, P, scale_len, sm_scale, st
  if (hd != 128) return cudaErrorInvalidValue;
  const cudaError_t err = pool_int8 ? launch_rows<int8_t, 128>(PA_ARGS)
                                    : launch_rows<__nv_bfloat16, 128>(PA_ARGS);
#undef PA_ARGS
  return err;
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
