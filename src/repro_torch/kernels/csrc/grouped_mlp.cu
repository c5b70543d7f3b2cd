// Grouped expert FFN, forward (inference form, no residuals).
//
// Replaces the TPU kernel repro/kernels/grouped_mlp.py::_fwd_kernel
// (launched by _forward).  Per expert slot k it computes
//     y = mask ⊙ (act(x@wi) [⊙ x@wg]) @ wo
// over x: (K, T, D), wi/wg: (K, D, F), wo: (K, F, D), mask: (K, T) int32.
//
// What bounds it on an H100: the weights.  At decode a slot holds a few
// tokens, so every weight element feeds only a few multiply-adds and the
// kernel is bound by reading wi/wo (bytes); at prefill a slot holds tens
// of tokens and the products approach the FMA rate (operations).  Only
// slots with a valid row read their weights, once per 16-row sub-tile.
//
// Design:
// * one block per (slot k, 128-row token tile, range of F).  The TPU
//   grid's sequential F axis becomes a loop inside the block over 64-wide
//   F chunks, and the (rows × D) partial output accumulates in f32
//   registers across that loop.  Each F range writes its partial sums to
//   its own f32 plane, and a second kernel adds the planes in a fixed
//   order (no atomics: the result does not change from run to run) and
//   rounds to the input dtype.  Cutting F over blocks puts a decode tick's
//   few active slots on many SMs instead of one each (one block per slot
//   left the card idle and latency-bound);
// * the block counts the valid rows of its tile itself (the TPU kernel got
//   that count by scalar prefetch) and exits when there are none; inside a
//   tile, 16-row sub-tiles without a valid row are skipped the same way,
//   so padded capacity costs no arithmetic;
// * rows are masked on input (zeroed in shared memory) and on output (the
//   second kernel writes zero for an invalid row without reading it);
// * h is rounded to the input dtype before the product with wo, as the TPU
//   kernel does (grouped_mlp.py:139); all sums are f32, and y is rounded
//   to the input dtype once, at the end;
// * T and F may be ragged (bounds-checked loads); D <= 1024.
#include "common.cuh"

constexpr int GM_THREADS = 256;
constexpr int GM_BT = 128;  // token tile of one block
constexpr int GM_R = 16;    // rows of a sub-tile
constexpr int GM_BF = 64;   // F chunk
constexpr int GM_MAXJ = 4;  // output columns per thread: D <= 4 * 256
constexpr int GM_RG = GM_THREADS / GM_BF;  // row groups in the h phase (4)

#define ACT_GELU 0
#define ACT_SILU 1

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if (ACT == ACT_SILU) return v / (1.0f + expf(-v));
  // tanh-form GELU, the form jax.nn.gelu computes by default
  return 0.5f * v *
         (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

template <typename T, bool GATE, int ACT>
__global__ void __launch_bounds__(GM_THREADS)
    grouped_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                           const T* __restrict__ wg, const T* __restrict__ wo,
                           const int* __restrict__ mask,
                           float* __restrict__ part, int Tn, int D, int F,
                           long long swi, long long swg, long long swo,
                           int f_split) {
  extern __shared__ float smem[];
  float* xs = smem;              // [GM_R][D] masked input rows, f32
  float* hs = xs + GM_R * D;     // [GM_R][GM_BF] activated chunk
  __shared__ int rowv[GM_R];

  const int k = blockIdx.y;
  const int t0 = blockIdx.x * GM_BT;
  const int tid = threadIdx.x;
  const T* xk = x + (size_t)k * Tn * D;
  const T* wik = wi + (size_t)k * swi;
  const T* wgk = GATE ? wg + (size_t)k * swg : nullptr;
  const T* wok = wo + (size_t)k * swo;
  const int* mk = mask + (size_t)k * Tn;
  // this F range's plane of partial sums, slot k
  float* yk = part + ((size_t)blockIdx.z * gridDim.y + k) * Tn * D;
  const int t_end = min(t0 + GM_BT, Tn);
  const int f_begin = blockIdx.z * f_split;
  const int f_end = min(F, f_begin + f_split);

  // the tile's valid-row count, read by the block itself; rows without a
  // valid token are never read back, so nothing is written for them
  const int mine = (tid < GM_BT && t0 + tid < Tn) ? (mk[t0 + tid] > 0) : 0;
  if (__syncthreads_count(mine) == 0) return;

  for (int r0 = t0; r0 < t_end; r0 += GM_R) {
    const int nr = min(GM_R, t_end - r0);
    const int v = (tid < nr) ? (mk[r0 + tid] > 0) : 0;
    if (tid < GM_R) rowv[tid] = v;
    if (__syncthreads_count(v) == 0) continue;  // no valid row here
    for (int i = tid; i < GM_R * D; i += GM_THREADS) {
      const int r = i / D;
      xs[i] = (r < nr && rowv[r]) ? to_f(xk[(size_t)r0 * D + i]) : 0.0f;
    }
    float acc[GM_R][GM_MAXJ];
#pragma unroll
    for (int r = 0; r < GM_R; ++r)
#pragma unroll
      for (int j = 0; j < GM_MAXJ; ++j) acc[r][j] = 0.0f;
    __syncthreads();

    const int fl = tid % GM_BF;
    const int rg = tid / GM_BF;
    for (int f0 = f_begin; f0 < f_end; f0 += GM_BF) {
      // h chunk: rows rg, rg+4, ... of act(x@wi[:, f]) [* x@wg[:, f]]
      const int f = f0 + fl;
      float a[GM_R / GM_RG], g[GM_R / GM_RG];
#pragma unroll
      for (int c = 0; c < GM_R / GM_RG; ++c) a[c] = g[c] = 0.0f;
      if (f < f_end) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float w1 = to_f(wik[(size_t)d * F + f]);
          const float w2 = GATE ? to_f(wgk[(size_t)d * F + f]) : 0.0f;
#pragma unroll
          for (int c = 0; c < GM_R / GM_RG; ++c) {
            const float xv = xs[(rg + GM_RG * c) * D + d];
            a[c] = fmaf(xv, w1, a[c]);
            if (GATE) g[c] = fmaf(xv, w2, g[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < GM_R / GM_RG; ++c) {
        float h = act_fn<ACT>(a[c]);
        if (GATE) h *= g[c];
        hs[(rg + GM_RG * c) * GM_BF + fl] =
            (f < f_end) ? round_to<T>(h) : 0.0f;
      }
      __syncthreads();
      // y += h_chunk @ wo[f0:f0+nf, :]
      const int nf = min(GM_BF, f_end - f0);
#pragma unroll 4
      for (int ff = 0; ff < nf; ++ff) {
        const T* wrow = wok + (size_t)(f0 + ff) * D;
#pragma unroll
        for (int j = 0; j < GM_MAXJ; ++j) {
          const int d = tid + j * GM_THREADS;
          if (d < D) {
            const float w = to_f(wrow[d]);
#pragma unroll
            for (int r = 0; r < GM_R; ++r)
              acc[r][j] = fmaf(hs[r * GM_BF + ff], w, acc[r][j]);
          }
        }
      }
      __syncthreads();
    }
    // this block's share of the F sum, valid rows only
#pragma unroll
    for (int r = 0; r < GM_R; ++r) {
      if (r < nr && rowv[r]) {
#pragma unroll
        for (int j = 0; j < GM_MAXJ; ++j) {
          const int d = tid + j * GM_THREADS;
          if (d < D) yk[(size_t)(r0 + r) * D + d] = acc[r][j];
        }
      }
    }
    __syncthreads();
  }
}

// y[k, t] = mask[k, t] ? round(sum over F ranges of part[:, k, t]) : 0,
// summed in range order
template <typename T>
__global__ void grouped_mlp_reduce_kernel(const float* __restrict__ part,
                                          const int* __restrict__ mask,
                                          T* __restrict__ y, int K, int Tn,
                                          int D, int n_split) {
  const size_t n = (size_t)K * Tn * D;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    if (mask[i / D] > 0)
      for (int s = 0; s < n_split; ++s) v += part[s * n + i];
    y[i] = from_f<T>(v);
  }
}

template <typename T, bool GATE, int ACT>
static int launch(const void* x, const void* wi, const void* wg,
                  const void* wo, const int* mask, float* part, void* y,
                  int K, int Tn, int D, int F, long long swi, long long swg,
                  long long swo, int f_split, cudaStream_t stream) {
  auto kern = grouped_mlp_fwd_kernel<T, GATE, ACT>;
  const size_t smem = (size_t)(GM_R * D + GM_R * GM_BF) * sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_split = (F + f_split - 1) / f_split;
  dim3 grid((Tn + GM_BT - 1) / GM_BT, K, n_split);
  kern<<<grid, GM_THREADS, smem, stream>>>(
      (const T*)x, (const T*)wi, (const T*)wg, (const T*)wo, mask, part, Tn,
      D, F, swi, swg, swo, f_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)K * Tn * D;
  const int blocks = (int)min((n + 255) / 256, (size_t)4096);
  grouped_mlp_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      part, mask, (T*)y, K, Tn, D, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* x, const void* wi, const void* wg,
                    const void* wo, const int* mask, float* part, void* y,
                    int K, int Tn, int D, int F, long long swi, long long swg,
                    long long swo, int f_split, int act, cudaStream_t s) {
#define GM_LAUNCH_ARGS \
  x, wi, wg, wo, mask, part, y, K, Tn, D, F, swi, swg, swo, f_split, s
  if (wg != nullptr) {
    if (act == ACT_SILU)
      return launch<T, true, ACT_SILU>(GM_LAUNCH_ARGS);
    return launch<T, true, ACT_GELU>(GM_LAUNCH_ARGS);
  }
  if (act == ACT_SILU)
    return launch<T, false, ACT_SILU>(GM_LAUNCH_ARGS);
  return launch<T, false, ACT_GELU>(GM_LAUNCH_ARGS);
#undef GM_LAUNCH_ARGS
}

// x: contiguous (K, T, D); wi/wg: (K, D, F) and wo: (K, F, D), each
// contiguous within a slot, slot k at element offset k * swi / swg / swo;
// all of one dtype; mask: (K, T) int32.  wg may be NULL (no gate).
// y: contiguous (K, T, D) of the input dtype.  The F axis is cut into
// f_split-wide ranges (a multiple of 64), one block each; part is f32
// scratch of (ceil(F / f_split), K, T, D) for their partial sums.
// act: 0 gelu (tanh form), 1 silu.
REPRO_EXPORT int grouped_mlp_fwd(const void* x, const void* wi, const void* wg,
                                 const void* wo, const int* mask, float* part,
                                 void* y, int K, int Tn, int D, int F,
                                 long long swi, long long swg, long long swo,
                                 int f_split, int act, int dtype,
                                 void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 || D > GM_MAXJ * GM_THREADS ||
      f_split <= 0 || f_split % GM_BF != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(x, wi, wg, wo, mask, part, y, K, Tn, D, F,
                                   swi, swg, swo, f_split, act, s);
  if (dtype == DTYPE_F32)
    return dispatch<float>(x, wi, wg, wo, mask, part, y, K, Tn, D, F, swi,
                           swg, swo, f_split, act, s);
  return (int)cudaErrorInvalidValue;
}
