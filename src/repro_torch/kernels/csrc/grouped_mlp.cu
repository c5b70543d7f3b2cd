// Grouped expert FFN, forward: the inference form and the training form.
//
// Replaces the TPU kernel repro/kernels/grouped_mlp.py::_fwd_kernel
// (launched by _forward).  Per expert slot k it computes
//     y = mask ⊙ (act(x@wi) [⊙ x@wg]) @ wo
// over x: (K, T, D), wi/wg: (K, D, F), wo: (K, F, D), mask: (K, T) int32.
// The training form (_forward(save_residuals=True)) also writes the
// pre-activations h1 = x@wi and h2 = x@wg, rounded to x's dtype, as the
// residuals of the backward kernels (grouped_mlp_bwd.cu).
//
// What bounds it on an H100: at decode a slot holds a few tokens, so every
// weight element feeds only a few multiply-adds and the kernel is bound by
// reading wi/wo (bytes); at prefill and in training a slot holds tens to
// hundreds of tokens and the products are bound by the FMA rate
// (operations: these loops run on the FMA units, not the tensor cores).
// Only slots with a valid row read their weights, once per 16-row
// sub-tile.
//
// Design:
// * one block per (slot k, token tile, range of F).  The TPU grid's
//   sequential F axis becomes a loop inside the block over 64-wide F
//   chunks, and the (rows × D) partial output accumulates in f32 registers
//   across that loop;
// * inference form: each F range writes its partial sums to its own f32
//   plane, and a second kernel adds the planes in a fixed order (no
//   atomics: the result does not change from run to run) and rounds to the
//   input dtype.  Cutting F over blocks puts a decode tick's few active
//   slots on many SMs instead of one each;
// * training form: no F split.  Its planes would scale with K × T, and at
//   world size 1 the capacity is every token of the call (4.8 GB of planes
//   per call at gpt-moe-s training shapes, 3% of rows valid).  Instead the
//   token tile is short (GM_BT_TRAIN = 32 rows), so the hundreds of valid
//   tiles fill the SMs, and the block writes y itself: every row of its
//   tile, zeros for invalid rows and skipped tiles, so y is defined
//   everywhere without a separate memset.  h1 and h2 are written only for
//   the 16-row sub-tiles that hold a valid row (zero on their invalid
//   rows): elsewhere they stay unwritten, as the TPU kernel leaves the
//   residuals of its skipped tiles, and dgrad reads them only at valid
//   rows;
// * the block counts the valid rows of its tile itself (the TPU kernel got
//   that count by scalar prefetch) and exits when there are none; inside a
//   tile, 16-row sub-tiles without a valid row are skipped the same way,
//   so padded capacity costs no arithmetic;
// * rows are masked on input (zeroed in shared memory) and on output;
// * h is rounded to the input dtype before the product with wo, as the TPU
//   kernel does (grouped_mlp.py:139); all sums are f32, and y is rounded
//   to the input dtype once, at the end;
// * T and F may be ragged (bounds-checked loads); D <= 1024.
#include "grouped_mlp.cuh"

constexpr int GM_BT = 128;  // token tile of the inference form
static_assert(GM_BT % GM_R == 0 && GM_BT <= GM_THREADS, "see GM_BT_TRAIN");

template <typename T, bool GATE, int ACT, bool SAVE>
__global__ void __launch_bounds__(GM_THREADS)
    grouped_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                           const T* __restrict__ wg, const T* __restrict__ wo,
                           const int* __restrict__ mask,
                           float* __restrict__ part, T* __restrict__ y,
                           T* __restrict__ h1, T* __restrict__ h2, int Tn,
                           int D, int F, long long swi, long long swg,
                           long long swo, int f_split) {
  constexpr int bt = SAVE ? GM_BT_TRAIN : GM_BT;
  extern __shared__ float smem[];
  float* xs = smem;              // [GM_R][D] masked input rows, f32
  float* hs = xs + GM_R * D;     // [GM_R][GM_BF] activated chunk
  __shared__ int rowv[GM_R];

  const int k = blockIdx.y;
  const int t0 = blockIdx.x * bt;
  const int tid = threadIdx.x;
  const T* xk = x + (size_t)k * Tn * D;
  const T* wik = wi + (size_t)k * swi;
  const T* wgk = GATE ? wg + (size_t)k * swg : nullptr;
  const T* wok = wo + (size_t)k * swo;
  const int* mk = mask + (size_t)k * Tn;
  // inference form: this F range's plane of partial sums, slot k
  float* pk = SAVE ? nullptr
                   : part + ((size_t)blockIdx.z * gridDim.y + k) * Tn * D;
  T* yk = SAVE ? y + (size_t)k * Tn * D : nullptr;
  T* h1k = SAVE ? h1 + (size_t)k * Tn * F : nullptr;
  T* h2k = (SAVE && GATE) ? h2 + (size_t)k * Tn * F : nullptr;
  const int t_end = min(t0 + bt, Tn);
  const int f_begin = blockIdx.z * f_split;
  const int f_end = min(F, f_begin + f_split);

  // the tile's valid-row count, read by the block itself
  const int mine = (tid < t_end - t0) ? (mk[t0 + tid] > 0) : 0;
  if (__syncthreads_count(mine) == 0) {
    // the inference form never reads these rows back; the residuals of a
    // skipped tile are never read
    if (SAVE) write_zero_rows(yk, t0, t_end - t0, D);
    return;
  }

  for (int r0 = t0; r0 < t_end; r0 += GM_R) {
    const int nr = min(GM_R, t_end - r0);
    const int v = (tid < nr) ? (mk[r0 + tid] > 0) : 0;
    if (tid < GM_R) rowv[tid] = v;
    if (__syncthreads_count(v) == 0) {  // no valid row here
      if (SAVE) write_zero_rows(yk, r0, nr, D);
      continue;
    }
    load_rows(xs, xk, rowv, r0, nr, D);
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
      float a[GM_RPT], g[GM_RPT];
      if (f < f_end) {
        rows_dot_cols<T, GATE>(xs, wik, wgk, D, F, f, rg, a, g);
      } else {
#pragma unroll
        for (int c = 0; c < GM_RPT; ++c) a[c] = g[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < GM_RPT; ++c) {
        const int row = rg + GM_RG * c;
        float h = act_fn<ACT>(a[c]);
        if (GATE) h *= g[c];
        hs[row * GM_BF + fl] = (f < f_end) ? round_to<T>(h) : 0.0f;
        // residuals: invalid rows were zeroed on input, so a = g = 0 there
        if (SAVE && f < f_end && row < nr) {
          h1k[(size_t)(r0 + row) * F + f] = from_f<T>(a[c]);
          if (GATE) h2k[(size_t)(r0 + row) * F + f] = from_f<T>(g[c]);
        }
      }
      __syncthreads();
      // y += h_chunk @ wo[f0:f0+nf, :]
      rows_times_chunk<T, false>(acc, hs, nullptr, wok, nullptr, f0,
                                 min(GM_BF, f_end - f0), D);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < GM_R; ++r) {
      if (r < nr && (SAVE || rowv[r])) {
#pragma unroll
        for (int j = 0; j < GM_MAXJ; ++j) {
          const int d = tid + j * GM_THREADS;
          if (d >= D) continue;
          if (SAVE)  // the whole output, rounded, zero for invalid rows
            yk[(size_t)(r0 + r) * D + d] =
                from_f<T>(rowv[r] ? acc[r][j] : 0.0f);
          else  // this block's share of the F sum, valid rows only
            pk[(size_t)(r0 + r) * D + d] = acc[r][j];
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

struct FwdArgs {
  const void *x, *wi, *wg, *wo;
  const int* mask;
  float* part;
  void *y, *h1, *h2;
  int K, Tn, D, F;
  long long swi, swg, swo;
  int f_split, act;
  cudaStream_t stream;
};

template <typename T, bool GATE, int ACT, bool SAVE>
static int launch(const FwdArgs& a) {
  auto kern = grouped_mlp_fwd_kernel<T, GATE, ACT, SAVE>;
  const size_t smem = (size_t)(GM_R * a.D + GM_R * GM_BF) * sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int f_split = SAVE ? a.F : a.f_split;
  const int n_split = (a.F + f_split - 1) / f_split;
  constexpr int bt = SAVE ? GM_BT_TRAIN : GM_BT;
  dim3 grid((a.Tn + bt - 1) / bt, a.K, n_split);
  kern<<<grid, GM_THREADS, smem, a.stream>>>(
      (const T*)a.x, (const T*)a.wi, (const T*)a.wg, (const T*)a.wo, a.mask,
      a.part, (T*)a.y, (T*)a.h1, (T*)a.h2, a.Tn, a.D, a.F, a.swi, a.swg,
      a.swo, f_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || SAVE) return (int)e;
  const size_t n = (size_t)a.K * a.Tn * a.D;
  const int blocks = (int)min((n + 255) / 256, (size_t)4096);
  grouped_mlp_reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(
      a.part, a.mask, (T*)a.y, a.K, a.Tn, a.D, n_split);
  return (int)cudaGetLastError();
}

template <typename T, bool SAVE>
static int dispatch(const FwdArgs& a) {
  if (a.wg != nullptr) {
    if (a.act == ACT_SILU) return launch<T, true, ACT_SILU, SAVE>(a);
    return launch<T, true, ACT_GELU, SAVE>(a);
  }
  if (a.act == ACT_SILU) return launch<T, false, ACT_SILU, SAVE>(a);
  return launch<T, false, ACT_GELU, SAVE>(a);
}

template <bool SAVE>
static int run(const FwdArgs& a, int dtype) {
  if (a.K <= 0 || a.Tn <= 0 || a.D <= 0 || a.F <= 0 ||
      a.D > GM_MAXJ * GM_THREADS ||
      (!SAVE && (a.f_split <= 0 || a.f_split % GM_BF)))
    return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16) return dispatch<__nv_bfloat16, SAVE>(a);
  if (dtype == DTYPE_F32) return dispatch<float, SAVE>(a);
  return (int)cudaErrorInvalidValue;
}

// Inference form.  x: contiguous (K, T, D); wi/wg: (K, D, F) and wo:
// (K, F, D), each contiguous within a slot, slot k at element offset
// k * swi / swg / swo; all of one dtype; mask: (K, T) int32.  wg may be
// NULL (no gate).  y: contiguous (K, T, D) of the input dtype.  The F axis
// is cut into f_split-wide ranges (a multiple of 64), one block each; part
// is f32 scratch of (ceil(F / f_split), K, T, D) for their partial sums.
// act: 0 gelu (tanh form), 1 silu.
REPRO_EXPORT int grouped_mlp_fwd(const void* x, const void* wi, const void* wg,
                                 const void* wo, const int* mask, float* part,
                                 void* y, int K, int Tn, int D, int F,
                                 long long swi, long long swg, long long swo,
                                 int f_split, int act, int dtype,
                                 void* stream) {
  FwdArgs a{x,  wi, wg,  wo,  mask, part,    y,       nullptr, nullptr,
            K,  Tn, D,   F,   swi,  swg,     swo,     f_split, act,
            (cudaStream_t)stream};
  return run<false>(a, dtype);
}

// Training form: as the inference form, without the F split, and with
// y: (K, T, D) and h1 (h2 when wg is given): (K, T, F), contiguous, of the
// input dtype.  y is written in full (zero on invalid rows); h1 and h2 only
// in the 16-row sub-tiles that hold a valid row (zero on their invalid
// rows).
REPRO_EXPORT int grouped_mlp_fwd_train(const void* x, const void* wi,
                                       const void* wg, const void* wo,
                                       const int* mask, void* y, void* h1,
                                       void* h2, int K, int Tn, int D, int F,
                                       long long swi, long long swg,
                                       long long swo, int act, int dtype,
                                       void* stream) {
  if (wg != nullptr && h2 == nullptr) return (int)cudaErrorInvalidValue;
  FwdArgs a{x,  wi, wg, wo,  mask, nullptr, y,   h1,  h2,
            K,  Tn, D,  F,   swi,  swg,     swo, F,   act,
            (cudaStream_t)stream};
  return run<true>(a, dtype);
}
