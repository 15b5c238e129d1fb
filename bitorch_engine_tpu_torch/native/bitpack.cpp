// Host-side bit-packing / checkpoint-repacking functions (OpenMP C++).
//
// The port's own copy of the JAX package's host packers: checkpoint
// ingestion of multi-GB packed LLM weights is CPU-bound in Python, so the
// conversions run here, multithreaded, and are exposed through ctypes
// (bitorch_engine_tpu_torch/native/__init__.py), which builds this file with
// g++ at first use.  The packed words are the port's "gptq" row order
// (ops/packing.py pack_rows); tpu_tiled is the TPU order the port reads.
//
// All functions operate on row-major arrays; K = logical input features,
// N = output features, ppw = 32 / w_bit values per int32 word.

#include <cstdint>
#include <cstring>

extern "C" {

// GPTQ row-packed (K/ppw, N) int32  ->  tpu_tiled row-packed (K/ppw, N).
// GPTQ order: value j of word r is logical row r*ppw + j.
// tpu_tiled order (per quant group of `gs` rows): value j of word r is
// group-local row j*(gs/ppw) + r (ops/packing.py unpack_rows_tpu_tiled).
void repack_gptq_to_tpu_tiled(const int32_t* in, int32_t* out, int64_t k,
                              int64_t n, int w_bit, int gs) {
  const int ppw = 32 / w_bit;
  const uint32_t mask = (w_bit == 32) ? 0xffffffffu : ((1u << w_bit) - 1u);
  const int64_t kw = k / ppw;        // packed rows total
  const int64_t bkp = gs / ppw;      // packed rows per group
  const int64_t groups = k / gs;

#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t g = 0; g < groups; ++g) {
    for (int64_t r = 0; r < bkp; ++r) {
      // build output word (g*bkp + r) for every column
      const int64_t out_row = g * bkp + r;
      for (int64_t c = 0; c < n; ++c) {
        uint32_t word = 0;
        for (int j = 0; j < ppw; ++j) {
          // group-local logical row j*bkp + r  ->  global row
          const int64_t k_log = g * gs + (int64_t)j * bkp + r;
          const int64_t in_row = k_log / ppw;
          const int in_j = (int)(k_log % ppw);
          const uint32_t v =
              ((uint32_t)in[in_row * n + c] >> (in_j * w_bit)) & mask;
          word |= v << (j * w_bit);
        }
        out[out_row * n + c] = (int32_t)word;
      }
    }
  }
}

// Unpack GPTQ row-packed codes to uint8 (K, N); parity with
// gptq_style_unpacking's shift/mask math (quant_operators.py:321-324).
void unpack_gptq_codes(const int32_t* in, uint8_t* out, int64_t k, int64_t n,
                       int w_bit) {
  const int ppw = 32 / w_bit;
  const uint32_t mask = (1u << w_bit) - 1u;
#pragma omp parallel for schedule(static)
  for (int64_t kk = 0; kk < k; ++kk) {
    const int64_t row = kk / ppw;
    const int shift = (int)(kk % ppw) * w_bit;
    const int32_t* src = in + row * n;
    uint8_t* dst = out + kk * n;
    for (int64_t c = 0; c < n; ++c) {
      dst[c] = (uint8_t)(((uint32_t)src[c] >> shift) & mask);
    }
  }
}

// Pack fp32 signs into uint32 words along the last axis (bit j = 1 iff
// x >= 0, LSB first) — parity with get_binary_row
// (quant_operators.py:143-151).
void pack_signs_f32(const float* in, uint32_t* out, int64_t rows,
                    int64_t cols) {
  const int64_t words = cols / 32;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    const float* src = in + r * cols;
    uint32_t* dst = out + r * words;
    for (int64_t w = 0; w < words; ++w) {
      uint32_t word = 0;
      for (int b = 0; b < 32; ++b) {
        word |= (uint32_t)(src[w * 32 + b] >= 0.0f) << b;
      }
      dst[w] = word;
    }
  }
}

// int codes (K, N) uint8 -> GPTQ row-packed int32 (K/ppw, N); inverse of
// unpack_gptq_codes, parity with pack_fp_weight's packing step
// (nbit/cuda/utils.py:133-142).
void pack_gptq_codes(const uint8_t* in, int32_t* out, int64_t k, int64_t n,
                     int w_bit) {
  const int ppw = 32 / w_bit;
  const int64_t kw = k / ppw;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < kw; ++r) {
    int32_t* dst = out + r * n;
    for (int64_t c = 0; c < n; ++c) {
      uint32_t word = 0;
      for (int j = 0; j < ppw; ++j) {
        word |= ((uint32_t)in[(r * ppw + j) * n + c]) << (j * w_bit);
      }
      dst[c] = (int32_t)word;
    }
  }
}

}  // extern "C"
