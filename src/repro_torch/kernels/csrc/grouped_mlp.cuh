// Shared pieces of the grouped expert FFN kernels (grouped_mlp.cu: forward,
// grouped_mlp_bwd.cu: dgrad and wgrad): the activation, its derivative and
// the row-tile loops that the forward and dgrad kernels share.
#pragma once

#include "common.cuh"

constexpr int GM_THREADS = 256;
constexpr int GM_R = 16;    // rows of a sub-tile
constexpr int GM_BF = 64;   // F chunk
constexpr int GM_MAXJ = 4;  // output columns per thread: D <= 4 * 256
constexpr int GM_RG = GM_THREADS / GM_BF;  // row groups in the F phase (4)
constexpr int GM_RPT = GM_R / GM_RG;       // rows per thread there (4)
constexpr int GM_BT_TRAIN = 32;  // token tile of the training form and dgrad
static_assert(GM_BT_TRAIN % GM_R == 0 && GM_BT_TRAIN <= GM_THREADS,
              "a tile is whole sub-tiles, one row per thread at most");

#define ACT_GELU 0
#define ACT_SILU 1

constexpr float GELU_K0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_K1 = 0.044715f;

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_SILU) return v / (1.0f + expf(-v));
  // tanh-form GELU, the form jax.nn.gelu computes by default
  return 0.5f * v * (1.0f + tanhf(GELU_K0 * (v + GELU_K1 * v * v * v)));
}

// act(v) into *a; returns act'(v) (the closed form of what jax.vjp of the
// activation computes)
template <int ACT>
__device__ __forceinline__ float act_and_grad(float v, float* a) {
  if (ACT == ACT_SILU) {
    const float s = 1.0f / (1.0f + expf(-v));
    *a = v * s;
    return s * (1.0f + v * (1.0f - s));
  }
  const float t = tanhf(GELU_K0 * (v + GELU_K1 * v * v * v));
  *a = 0.5f * v * (1.0f + t);
  return 0.5f * (1.0f + t) +
         0.5f * v * (1.0f - t * t) * GELU_K0 * (1.0f + 3.0f * GELU_K1 * v * v);
}

// Load the rows [r0, r0 + nr) of one slot's (rows, D) input into shared
// memory as f32, zero for rows whose rowv is 0 (and past nr).
template <typename T>
__device__ __forceinline__ void load_rows(float* xs, const T* __restrict__ xk,
                                          const int* rowv, int r0, int nr,
                                          int D) {
  for (int i = threadIdx.x; i < GM_R * D; i += GM_THREADS) {
    const int r = i / D;
    xs[i] = (r < nr && rowv[r]) ? to_f(xk[(size_t)r0 * D + i]) : 0.0f;
  }
}

// The F phase of one chunk: for this thread's column f and its rows
// rg, rg + 4, ..., a[c] = sum_d xs[row][d] * w1[d][f] (and g[c] with w2
// when TWO); w1/w2 are (D, F) row-major, f < f_end is checked by the
// caller.  Neighbouring threads read neighbouring f: coalesced.
template <typename T, bool TWO>
__device__ __forceinline__ void rows_dot_cols(const float* xs,
                                              const T* __restrict__ w1,
                                              const T* __restrict__ w2, int D,
                                              int F, int f, int rg,
                                              float a[GM_RPT],
                                              float g[GM_RPT]) {
#pragma unroll
  for (int c = 0; c < GM_RPT; ++c) a[c] = g[c] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float v1 = to_f(w1[(size_t)d * F + f]);
    const float v2 = TWO ? to_f(w2[(size_t)d * F + f]) : 0.0f;
#pragma unroll
    for (int c = 0; c < GM_RPT; ++c) {
      const float xv = xs[(rg + GM_RG * c) * D + d];
      a[c] = fmaf(xv, v1, a[c]);
      if (TWO) g[c] = fmaf(xv, v2, g[c]);
    }
  }
}

// The D phase of one chunk: acc[r][j] += sum_ff hs[r][ff] * w1[f0 + ff][d]
// (+ h2s[r][ff] * w2[f0 + ff][d] when TWO) for this thread's columns
// d = tid + 256 j; w1/w2 are (F, D) row-major.
template <typename T, bool TWO>
__device__ __forceinline__ void rows_times_chunk(
    float acc[GM_R][GM_MAXJ], const float* hs, const float* h2s,
    const T* __restrict__ w1, const T* __restrict__ w2, int f0, int nf,
    int D) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int ff = 0; ff < nf; ++ff) {
    const T* r1 = w1 + (size_t)(f0 + ff) * D;
    const T* r2 = TWO ? w2 + (size_t)(f0 + ff) * D : nullptr;
#pragma unroll
    for (int j = 0; j < GM_MAXJ; ++j) {
      const int d = tid + j * GM_THREADS;
      if (d < D) {
        const float v1 = to_f(r1[d]);
        const float v2 = TWO ? to_f(r2[d]) : 0.0f;
#pragma unroll
        for (int r = 0; r < GM_R; ++r) {
          acc[r][j] = fmaf(hs[r * GM_BF + ff], v1, acc[r][j]);
          if (TWO) acc[r][j] = fmaf(h2s[r * GM_BF + ff], v2, acc[r][j]);
        }
      }
    }
  }
}

// Zero the rows [r0, r0 + nr) of a (rows, width) row-major output.
template <typename T>
__device__ __forceinline__ void write_zero_rows(T* __restrict__ out, int r0,
                                                int nr, int width) {
  for (int i = threadIdx.x; i < nr * width; i += GM_THREADS)
    out[(size_t)r0 * width + i] = from_f<T>(0.0f);
}
