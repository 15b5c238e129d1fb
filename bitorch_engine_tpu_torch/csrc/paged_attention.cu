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
// Two kernels, the route picked by the wrapper from the call's form:
// paged_decode_kernel for the write-back form with at most 8 query rows
// (every decode step of the repo's Llama configurations) where a cluster
// of at most 4 blocks fits its share of the window in shared memory, else
// paged_attention_kernel (the read-only chunk form, and windows past about
// 16K positions at 8 rows, 29K at 4).
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
// q, ~2.6 us at 3.35 TB/s.  At chunked prefill (rs = 1024 rows) the dots
// dominate and the bf16 tensor-core rate sets the floor.  This kernel uses
// f32 CUDA-core FMAs and no asynchronous copies; mma for the chunk form is
// later work.
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N committed groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
          cp_async16(st + jj * ROWB + col * 16,
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
