// Kernels 1 and 7 for bf16 activations on Hopper (sm_90a): the fused
// mixed-bit (MBWQ) matmul on the tensor cores, and the A16 dequant GEMV as
// its one-segment case.
//
// bte_mbwq_matmul_mma -- replaces bitorch_engine_tpu/ops/pallas/mbwq_matmul.py
//   :_mbwq_kernel (entry mbwq_matmul_pallas), the fused mixed-bit matmul:
//   x (m, K) bf16, already channel-scaled and gathered into segment order,
//   @ the 1-8 uniform segments stacked along K, in ONE launch, with one f32
//   accumulator per output and a single cast.  f32 activations keep
//   dequant_matmul.cu's mbwq_matmul_kernel (the MMA takes bf16 operands).
//
// Kernel 1 -- replaces bitorch_engine_tpu/ops/pallas/dequant_matmul.py
//   :_mpq_kernel, A16 (entry mpq_matmul_pallas), x (m <= 512, K) bf16 @ one
//   w1/2/4/8 MPQ tensor: the same entry point with a one-segment table
//   (ops/cuda/dequant_matmul.py mpq_matmul).  f32 activations, and groups
//   the chunks cannot tile, keep dequant_matmul.cu's mpq_matmul_kernel.
//
// Weights: each segment is gptq-order int32 words (K_s / ppw, N), ppw =
//   32 / W; value j of word r is row r * ppw + j, LSB first.  Metadata
//   scales / zeros (K_s / gs, N), f32 or bf16; w = q * s - z.
//
// Bound on the H100: the packed words and metadata are read once (about
//   2.6 bits a weight for MBWQ-2.5 with bf16 metadata) and the products are
//   2 * m operations a weight.  Up to m ~ 32 at 2-4 bits that is below the
//   card's ~295 bf16 operations per byte: bytes bound at 3.35 TB/s.  Above
//   it, operations.
//
// The three limits of the scalar body (dequant_matmul.cu) and what this
// design does about each:
//   1. CUDA-core compute set the pace (one f32 FMA per weight per row plus
//      the conversion).  Here every product is mma.sync.m16n8k16 bf16 ->
//      f32 with the roles swapped for decode: the weight tile is A (16
//      output columns x 16 k) and x is B (16 k x 8 rows), so one MMA covers
//      an m = 8 step; larger m tiles reuse each A fragment across up to 4
//      n8 tiles.  Codes become exact bf16 integers in registers, straight
//      from the packed words (code_pair below); nothing is dequantized.
//      Sum(x) per row, needed by the factored group form, is one more MMA
//      per k16 slab with an all-ones A, once per warp.
//   2. Too few bytes in flight.  Each warp streams its run through a ring
//      of D chunks (words, activations and group metadata) in its share of
//      160 KB of shared memory by cp.async, D - 1 chunks ahead of its
//      products (D = 2 at m <= 8, 16 warps; 2-8 at 8 warps), with no
//      division in the loop.  On the card the ring bought nothing over
//      register batches, nor did a deeper one: the loop's instruction issue
//      per SM, not bytes in flight, set the pace (PERF.md §6), so decode
//      takes 16 warps x 64 columns a block.
//   3. Unbalanced K slices.  The concatenated K of all segments is cut into
//      contiguous runs of equal length, one per warp, each cut on a chunk
//      boundary of the segment it falls in (host: mbwq_matmul.warp_cuts).
//      A run may cross groups and segments; at a segment boundary the warp
//      switches width, chunk shape and metadata.  The warps' partials meet in
//      shared memory and are summed in warp order: no atomics, the output is
//      bit-stable from run to run.
//   4. Too few blocks.  At m <= 8 a block owns 64 columns, so N = 4096 (the
//      o and down projections) gives 64 blocks for 132 SMs.  Where the split
//      grid still runs in one wave, kernel 7 launches a cluster of S = 2
//      blocks that share each tile along K (host: mbwq_matmul.k_splits;
//      kernel 1 measured slower split and stays at S = 1): the K runs are
//      cut for S * n_warps warps and rank r takes runs r * n_warps ..
//      (r + 1) * n_warps - 1.  Each rank sums its warps as above into its shared
//      memory; after cluster.sync() rank r adds the S partials of its slice
//      of the tile in rank order through distributed shared memory
//      (map_shared_rank) and stores it.  No atomics, no second launch.
//
// Numerics (as the scalar body and _accumulate_k_step's zeros form): per
//   group piece, acc += s[g] * dot(x, q) - z[g] * sum(x), with dot and sum
//   in f32 from exact bf16 codes and bf16 x.  A group split across warps or
//   runs applies s and z to each part (the form is linear).
//
// ---------------------------------------------------------------------------
// The k order inside an MMA.  mma.m16n8k16's A fragment gives lane
// (g = lane / 4, t = lane % 4) the A rows g and g + 8 at k = 2t, 2t + 1
// (register a0 / a1), 2t + 8, 2t + 9 (a2 / a3); B gives it column g at the
// same k.  The product sums over k, so any permutation of k applied to A and
// to B alike gives the same sum.  This kernel chooses the one that lets a
// lane fill its A registers from whole packed words:
//
//   A chunk is C words of every column (C = 4, or 2 / 1 where the group is
//   shorter than 4 words), CK = C * ppw rows of k, S = CK / 16 slabs.  Lane
//   t reads word widx = t / (4 / C) of the chunk and uses its code pairs
//   jb .. jb + 2S - 1, jb = (t % (4 / C)) * 2S.  A code pair j is codes j and
//   j + 16/W of the word: one shift and one lop3 with 0x43004300 put them in
//   the two halves of a bf16x2 as 128 + q (exact for q < 128), and one
//   __hsub2 of 128 leaves q.  In slab s the lane's k are
//     k(2t)     = widx * ppw + jb + 2s            (a0: pair jb + 2s, low)
//     k(2t + 1) = widx * ppw + jb + 2s + 16/W     (a0: pair jb + 2s, high)
//     k(2t + 8) = widx * ppw + jb + 2s + 1        (a2: pair jb + 2s + 1, low)
//     k(2t + 9) = widx * ppw + jb + 2s + 1 + 16/W (a2: pair jb + 2s + 1, high)
//   and B is x at the same k: the lane loads x[jb ..] and x[jb + 16/W ..]
//   (2S values each) once per chunk and pairs them with one prmt per register.
//
//   w4, C = 4 (CK 32, S 2, 16/W = 4): lane t owns word t, k = 8t + code.
//     slab 0: k(2t, 2t+1, 2t+8, 2t+9) = 8t + (0, 4, 1, 5)
//     slab 1:                           8t + (2, 6, 3, 7)
//   w2, C = 4 (CK 64, S 4, 16/W = 8): lane t owns word t, k = 16t + code.
//     slab s: k(2t, 2t+1, 2t+8, 2t+9) = 16t + (2s, 2s+8, 2s+1, 2s+9)
//   w2, C = 1 (a group of 16 or 32 rows: CK 16, S 1): the 4 lanes of a
//     quad share the word, jb = 2t: k = (2t, 2t+8, 2t+1, 2t+9).
//   w8 (C = 4, CK 16, S 1, 16/W = 2): k = 4t + (0, 2, 1, 3); its codes reach
//     255, past the 128 bias, so they go through an exact int -> float.
//
// Columns: a lane loads the words of 4 consecutive columns (16 bytes) of its
// row; A rows g / g + 8 of n16 tile h are the quad's columns 2h / 2h + 1.  A
// block owns 64 columns and 16 warps at m <= 8 (BM 8), else 32 columns and
// 8 warps (BM 16 or 32).
// ---------------------------------------------------------------------------
//
// -Xptxas -v on the card (CUDA 12.8): 99 registers at BM 8, 111 at BM 16,
// 184 at BM 32; no spills, no stack frame.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_NW = 16;          // warps per block (8 or 16), one K run each
constexpr int MAX_SPLIT = 2;        // blocks of a cluster along K
constexpr int MAX_SEGS = 8;
constexpr uint32_t ONES = 0x3F803F80u;  // bf16x2 (1, 1)

struct Seg {
  const int32_t* packed;
  const void* scales;
  const void* zeros;
  int k_off;  // first column of x the segment reads
  int k;      // rows of the segment
  int w_bit;
  int c;      // words per chunk
  int gs;     // group size
};

struct Args {
  Seg seg[MAX_SEGS];
  int n_seg;
  // warp w of cluster rank r runs [cut[r * n_warps + w], cut[r * n_warps + w + 1])
  // of the concatenated K
  int cut[MAX_NW * MAX_SPLIT + 1];
};

// Code pair j of word w (codes j and j + 16/W) as bf16x2, low half first.
template <int W>
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int j) {
  if constexpr (W == 8) {
    const float lo = (float)((w >> (8 * j)) & 0xFFu);
    const float hi = (float)((w >> (8 * j + 16)) & 0xFFu);
    __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);  // exact: q <= 255
    return *reinterpret_cast<uint32_t*>(&r);
  } else {
    constexpr uint32_t MASK = ((1u << W) - 1u) * 0x10001u;
    const uint32_t v = ((w >> (j * W)) & MASK) | 0x43004300u;  // 128 + q, two halves
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               __float2bfloat162_rn(128.f));
    return *reinterpret_cast<uint32_t*>(&r);
  }
}

// Copy NB bytes (a multiple of 4, at most 16 unless a multiple of 16)
// starting at byte b of the lane field at unit u0.
template <int NB>
__device__ __forceinline__ void copy_field(uint4* stage, int u0, int b, int lane, const void* src) {
  if constexpr (NB <= 16) {
    cp_async<NB>(unit_ptr(stage, u0 + b / 16, lane) + b % 16, src);
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      cp_async<16>(unit_ptr(stage, u0 + b / 16 + i, lane), static_cast<const char*>(src) + 16 * i);
  }
}

// One lane's N words of a field starting at unit u0.
template <int N>
__device__ __forceinline__ void read_words(uint4* stage, int u0, int lane, uint32_t* o) {
  if constexpr (N <= 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(unit_ptr(stage, u0, lane));
    o[0] = v.x;
    if constexpr (N == 2) o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(unit_ptr(stage, u0 + i / 4, lane));
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  }
}

// Four metadata values as f32 bits from a lane's unit (f32 or bf16 storage).
template <bool MF32>
__device__ __forceinline__ uint4 read_meta(uint4* stage, int u, int lane) {
  const uint4 v = *reinterpret_cast<const uint4*>(unit_ptr(stage, u, lane));
  if constexpr (MF32) return v;
  return make_uint4(v.x << 16, v.x & 0xFFFF0000u, v.y << 16, v.y & 0xFFFF0000u);
}

// Shared memory of a block's rings, split among its warps.
constexpr int SMEM_BYTES = 160 * 1024;

// One warp's run [lo, hi) (segment-relative, chunk-aligned) of one segment
// of width W, chunks of C words, into acc[q][h][mt][4]: tile h of column
// quad q, n8 tile mt of the block's rows.  The lane's words, activations
// and (at a group piece's end) metadata of each chunk go through a ring of
// D stages in shared memory by cp.async, D - 1 chunks ahead of the
// products; each lane reads back only what it copied.
template <int W, int C, int MT, int NQ, int NW, bool MF32>
__device__ __forceinline__ void run_segment(const bf16* __restrict__ x, int K, int M, int N,
                                            int m0, int n0, const Seg& sg, int lo, int hi,
                                            uint4* ring, float (&acc)[NQ][2][MT][4]) {
  constexpr int PPW = 32 / W;
  constexpr int CK = C * PPW;       // k rows per chunk
  constexpr int S = CK / 16;        // k16 slabs per chunk
  constexpr int HALF = 16 / W;      // a code pair's second code
  constexpr int TPW = 4 / C;        // lanes of a quad sharing a word
  constexpr int XW = 2 * S;         // x words a lane holds per chunk and n8 tile
  constexpr int XU = (XW * 4 + 15) / 16;  // 16-byte units of them
  constexpr int MB = MF32 ? 16 : 8;       // bytes of 4 metadata values
  // a stage: NQ units of words, MT * XU of x, 2 * NQ of scales and zeros
  constexpr int UNITS = NQ + MT * XU + 2 * NQ;
  constexpr int D0 = SMEM_BYTES / NW / (UNITS * 16 * 32);
  constexpr int D = D0 > 8 ? 8 : D0;
  static_assert(D >= 2, "a ring holds at least two chunks");
  static_assert(S >= 1 && C * PPW % 16 == 0, "a chunk holds whole k16 slabs");

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int widx = t / TPW;
  const int jb = (t % TPW) * XW;
  const int col = n0 + 4 * g;
  const int c_lo = lo / CK, c_hi = hi / CK;

  // the issuing side walks the chunks D - 1 ahead of the products, with
  // its own pointers and group counter (no division in the loop)
  const int cpg = sg.gs / CK;  // chunks per group
  const int32_t* wp = sg.packed + ((size_t)c_lo * C + widx) * N + col;
  const bf16* xp[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = min(m0 + mt * 8 + g, M - 1);  // rows past M are computed, never stored
    xp[mt] = x + (size_t)m * K + sg.k_off + (size_t)c_lo * CK + widx * PPW + jb;
  }
  size_t mo = (size_t)(c_lo / cpg) * N + col;  // metadata of the issued chunk's group
  int is_i = c_lo, is_left = cpg - c_lo % cpg, is_st = 0;

  auto issue = [&]() {
    if (is_i < c_hi) {
      uint4* st = ring + is_st * UNITS * 32;
#pragma unroll
      for (int q = 0; q < NQ; ++q)  // columns past N: their outputs are never stored
        if (col + 32 * q < N) cp_async<16>(unit_ptr(st, q, lane), wp + 32 * q);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int u0 = NQ + mt * XU;
        if constexpr (C == 4) {
          copy_field<XW * 4>(st, u0, 0, lane, xp[mt]);  // both code runs are adjacent
        } else {
          copy_field<S * 4>(st, u0, 0, lane, xp[mt]);
          copy_field<S * 4>(st, u0, S * 4, lane, xp[mt] + HALF);
        }
        xp[mt] += CK;
      }
      if (is_left == 1 || is_i + 1 == c_hi) {  // the chunk ends its group piece
        const int u0 = NQ + MT * XU;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (col + 32 * q < N) {
            cp_async<MB>(unit_ptr(st, u0 + 2 * q, lane),
                         static_cast<const char*>(sg.scales) + (mo + 32 * q) * (MB / 4));
            cp_async<MB>(unit_ptr(st, u0 + 2 * q + 1, lane),
                         static_cast<const char*>(sg.zeros) + (mo + 32 * q) * (MB / 4));
          }
        }
      }
      wp += (size_t)C * N;
      if (--is_left == 0) {
        is_left = cpg;
        mo += N;
      }
      if (++is_st == D) is_st = 0;
      ++is_i;
    }
    cp_async_commit();  // one group per chunk slot, empty past the run
  };

  float dot[NQ][2][MT][4];
  float xs[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) xs[mt][r] = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) dot[q][h][mt][r] = 0.f;
  }
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};

  int left = is_left, stage = 0;  // the products' group counter and ring slot
#pragma unroll
  for (int p = 0; p < D - 1; ++p) issue();
  for (int i = c_lo; i < c_hi; ++i) {
    issue();
    cp_async_wait<D - 1>();  // chunk i has landed
    uint4* st = ring + stage * UNITS * 32;
    uint4 wv[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) wv[q] = *reinterpret_cast<const uint4*>(unit_ptr(st, q, lane));
    uint32_t xv[MT][XW];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) read_words<XW>(st, NQ + mt * XU, lane, xv[mt]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        b[mt][0] = __byte_perm(xv[mt][s], xv[mt][S + s], 0x5410);  // low halves
        b[mt][1] = __byte_perm(xv[mt][s], xv[mt][S + s], 0x7632);  // high halves
        mma16816(xs[mt], ones, b[mt][0], b[mt][1]);
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const uint32_t w4[4] = {wv[q].x, wv[q].y, wv[q].z, wv[q].w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[4];
          a[0] = code_pair<W>(w4[2 * h], jb + 2 * s);
          a[1] = code_pair<W>(w4[2 * h + 1], jb + 2 * s);
          a[2] = code_pair<W>(w4[2 * h], jb + 2 * s + 1);
          a[3] = code_pair<W>(w4[2 * h + 1], jb + 2 * s + 1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(dot[q][h][mt], a, b[mt][0], b[mt][1]);
        }
      }
    }
    if (left == 1 || i + 1 == c_hi) {
      // the group piece ends: acc += s * dot - z * sum(x), then restart
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const uint4 sv = read_meta<MF32>(st, NQ + MT * XU + 2 * q, lane);
        const uint4 zv = read_meta<MF32>(st, NQ + MT * XU + 2 * q + 1, lane);
        const float sc[4] = {__uint_as_float(sv.x), __uint_as_float(sv.y),
                             __uint_as_float(sv.z), __uint_as_float(sv.w)};
        const float zc[4] = {__uint_as_float(zv.x), __uint_as_float(zv.y),
                             __uint_as_float(zv.z), __uint_as_float(zv.w)};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = 2 * h + (r >> 1);
              acc[q][h][mt][r] += dot[q][h][mt][r] * sc[c] - xs[mt][r & 1] * zc[c];
              dot[q][h][mt][r] = 0.f;
            }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) xs[mt][r] = 0.f;
    }
    if (--left == 0) left = cpg;
    if (++stage == D) stage = 0;
  }
  cp_async_wait<0>();  // nothing in flight into the ring past the piece
}

template <int MT, int NQ, int NW, bool MF32>
__device__ __forceinline__ void dispatch_segment(const bf16* __restrict__ x, int K, int M, int N,
                                                 int m0, int n0, const Seg& sg, int lo, int hi,
                                                 uint4* ring, float (&acc)[NQ][2][MT][4]) {
  switch (sg.w_bit * 8 + sg.c) {
    case 1 * 8 + 1: run_segment<1, 1, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 1 * 8 + 2: run_segment<1, 2, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 1 * 8 + 4: run_segment<1, 4, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 2 * 8 + 1: run_segment<2, 1, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 2 * 8 + 2: run_segment<2, 2, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 2 * 8 + 4: run_segment<2, 4, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 4 * 8 + 2: run_segment<4, 2, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    case 4 * 8 + 4: run_segment<4, 4, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
    default: run_segment<8, 4, MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo, hi, ring, acc); break;
  }
}

template <int MT, int NQ, int NW, bool MF32>
__global__ void __launch_bounds__(NW * 32)
mbwq_mma_kernel(const bf16* __restrict__ x, void* __restrict__ out, int out_f32, int M, int K,
                int N, int n_split, const __grid_constant__ Args args) {
  constexpr int BM = MT * 8, BN = NQ * 32;
  extern __shared__ uint4 smem[];  // the warps' rings, then the partials

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a cluster of n_split blocks along x shares one tile; its rank is the
  // block's place in it
  const int rank = blockIdx.x % n_split;
  const int n0 = blockIdx.x / n_split * BN;
  const int m0 = blockIdx.y * BM;

  float acc[NQ][2][MT][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][h][mt][r] = 0.f;

  const int k_lo = args.cut[rank * NW + warp], k_hi = args.cut[rank * NW + warp + 1];
  for (int si = 0; si < args.n_seg; ++si) {
    const Seg& sg = args.seg[si];
    const int lo = max(k_lo, sg.k_off), hi = min(k_hi, sg.k_off + sg.k);
    if (lo < hi)
      dispatch_segment<MT, NQ, NW, MF32>(x, K, M, N, m0, n0, sg, lo - sg.k_off, hi - sg.k_off,
                                         smem + warp * (SMEM_BYTES / NW / 16), acc);
  }
  __syncthreads();  // every ring is drained before the partials reuse it
  float (*red)[BM][BN] = reinterpret_cast<float (*)[BM][BN]>(smem);

  // the warps' partials meet in shared memory, summed in warp order
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[warp][mt * 8 + 2 * t + (r & 1)][32 * q + 4 * g + 2 * h + (r >> 1)] = acc[q][h][mt][r];
  __syncthreads();
  auto store = [&](int idx, float v) {
    const int m = m0 + idx / BN, n = n0 + idx % BN;
    if (m < M && n < N) {
      if (out_f32) static_cast<float*>(out)[(size_t)m * N + n] = v;
      else static_cast<bf16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  };
  float* part = &red[NW][0][0];  // this rank's sum of the tile, past the warps' parts
  for (int idx = threadIdx.x; idx < BM * BN; idx += NW * 32) {
    const int i = idx / BN, c = idx % BN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += red[w][i][c];
    if (n_split == 1) store(idx, sum);
    else part[idx] = sum;
  }
  if (n_split > 1) {
    // the ranks' partials, added in rank order by the rank that owns each
    // slice of the tile
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partial is in its shared memory
    const int per = (BM * BN + n_split - 1) / n_split;
    const int hi = min(BM * BN, (rank + 1) * per);
    for (int idx = rank * per + threadIdx.x; idx < hi; idx += NW * 32) {
      float sum = 0.f;
      for (int r = 0; r < n_split; ++r) sum += cluster.map_shared_rank(part, r)[idx];
      store(idx, sum);
    }
    cluster.sync();  // no block leaves while a peer still reads its shared memory
  }
}

template <int MT, int NQ, int NW, bool MF32>
cudaError_t launch_kernel(const bf16* x, void* out, int out_f32, int M, int K, int N,
                          int n_split, const Args& a, cudaStream_t st) {
  // the warps' parts and the rank's sum of the tile
  constexpr int RED = (NW + 1) * MT * 8 * NQ * 32 * 4;
  constexpr int SMEM = SMEM_BYTES > RED ? SMEM_BYTES : RED;
  auto kern = mbwq_mma_kernel<MT, NQ, NW, MF32>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + NQ * 32 - 1) / (NQ * 32) * n_split, (M + MT * 8 - 1) / (MT * 8));
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, x, out, out_f32, M, K, N, n_split, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT, int NQ, int NW>
cudaError_t launch(const void* x, void* out, int out_f32, int meta_f32, int M, int K, int N,
                   int n_split, const Args& a, cudaStream_t st) {
  const bf16* xb = static_cast<const bf16*>(x);
  if (meta_f32) return launch_kernel<MT, NQ, NW, true>(xb, out, out_f32, M, K, N, n_split, a, st);
  return launch_kernel<MT, NQ, NW, false>(xb, out, out_f32, M, K, N, n_split, a, st);
}

}  // namespace

// Kernels 1 and 7, bf16 activations, over n_seg segments (host arrays of
// per-segment pointers, widths, group sizes, rows and words per chunk, in
// the order of x's columns; kernel 1 passes one), the warps of a block (16
// for M <= 8, with 64 columns and 8 rows; else 8, with 32 columns and 16
// or 32 rows), the blocks of a cluster along K (n_split: 1 or 2) and
// the n_split * n_warps + 1 cuts of their K runs.  Shapes, dtypes,
// alignment, chunks and cuts are checked by the Python wrapper
// (ops/cuda/mbwq_matmul.py launch_mma); this returns cudaErrorInvalidValue
// on a table it cannot take, else the launch's error (a cluster the card
// cannot place included).
extern "C" int bte_mbwq_matmul_mma(const void* x, int n_seg, const void* const* packed,
                                   const void* const* scales, const void* const* zeros,
                                   const int* w_bits, const int* group_sizes, const int* k_segs,
                                   const int* chunk_words, int n_warps, int n_split,
                                   const int* cuts, void* out, int M, int K, int N,
                                   int meta_dtype, int out_dtype, void* stream) {
  if (n_seg < 1 || n_seg > MAX_SEGS || N % 4) return cudaErrorInvalidValue;
  if (n_warps != (M <= 8 ? 16 : 8)) return cudaErrorInvalidValue;
  if (n_split != 1 && n_split != MAX_SPLIT) return cudaErrorInvalidValue;
  const int n_cuts = n_warps * n_split;
  Args a = {};
  int k_off = 0;
  for (int i = 0; i < n_seg; ++i) {
    const int w = w_bits[i], c = chunk_words[i], ck = c * (32 / w);
    const bool ok = (w == 1 || w == 2 || w == 4) ? (c == 1 || c == 2 || c == 4) : (w == 8 && c == 4);
    if (!ok || ck % 16 || group_sizes[i] % ck || k_segs[i] % group_sizes[i]) return cudaErrorInvalidValue;
    a.seg[i] = Seg{static_cast<const int32_t*>(packed[i]), scales[i], zeros[i], k_off, k_segs[i],
                   w, c, group_sizes[i]};
    k_off += k_segs[i];
  }
  if (k_off != K || cuts[0] != 0 || cuts[n_cuts] != K) return cudaErrorInvalidValue;
  for (int w = 0; w <= n_cuts; ++w) {
    if (w && cuts[w] < cuts[w - 1]) return cudaErrorInvalidValue;
    // a cut falls on a chunk boundary of the segment it lies in
    for (int i = 0; i < n_seg; ++i) {
      const Seg& sg = a.seg[i];
      if (cuts[w] > sg.k_off && cuts[w] < sg.k_off + sg.k &&
          (cuts[w] - sg.k_off) % (sg.c * (32 / sg.w_bit)))
        return cudaErrorInvalidValue;
    }
    a.cut[w] = cuts[w];
  }
  a.n_seg = n_seg;
  const int out_f32 = out_dtype == 0, meta_f32 = meta_dtype == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<1, 2, 16>(x, out, out_f32, meta_f32, M, K, N, n_split, a, st);
  if (M <= 16) return launch<2, 1, 8>(x, out, out_f32, meta_f32, M, K, N, n_split, a, st);
  return launch<4, 1, 8>(x, out, out_f32, meta_f32, M, K, N, n_split, a, st);
}

extern "C" const char* bte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
