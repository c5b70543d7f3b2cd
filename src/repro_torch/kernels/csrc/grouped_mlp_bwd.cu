// Grouped expert FFN, backward: dgrad and wgrad.
//
// dgrad replaces the TPU kernel repro/kernels/grouped_mlp.py::_dgrad_kernel
// (launched by _dgrad).  From the masked cotangent g = mask ⊙ dy and the
// forward's residuals h1 = x@wi, h2 = x@wg it computes, per slot,
//     dh  = g @ woᵀ                       (f32, never rounded)
//     dh1 = act'(h1) ⊙ dh [⊙ h2],  dh2 = dh ⊙ act(h1),  h = act(h1) [⊙ h2]
//     dx  = mask ⊙ (dh1 @ wiᵀ [+ dh2 @ wgᵀ])   (from the f32 dh1/dh2)
// and writes dx, dh1, dh2 and h in dy's dtype, as the TPU kernel does.
//
// wgrad replaces repro/kernels/grouped_mlp.py::_wgrad_kernel (launched by
// _wgrad): dwi = xᵀ@dh1, dwg = xᵀ@dh2, dwo = hᵀ@g over the valid rows of
// each slot, summed in f32 and written in the weight dtype.
//
// What bounds them on an H100: operations.  At gpt-moe-s training shapes a
// slot holds ~128 valid rows, so each weight element feeds ~128
// multiply-adds per product, far above the card's bytes-per-operation
// line; these simple kernels run on the FMA units (not the tensor cores),
// so the FMA rate is their ceiling.
//
// dgrad design: the forward kernel's loops with the weights transposed.
// The wrapper passes woᵀ as (K, D, F) and wiᵀ/wgᵀ as (K, F, D), contiguous
// copies, so that dh = g@woᵀ is the forward's x@wi loop and dx = dh1@wiᵀ
// its h@wo loop, both with neighbouring threads on neighbouring addresses.
// One block per (slot, 32-row token tile: GM_BT_TRAIN); it counts its
// valid rows itself and skips tiles and 16-row sub-tiles without one.  It
// reads h1 and h2 at valid rows only.  It writes every row
// of its tile: zeros for invalid rows and skipped tiles, as the TPU
// kernel's skipped tiles write zeros (grouped_mlp.py:265-272).
//
// wgrad design: one block per (slot, 64-wide D tile, 64-wide F tile), with
// a 4×4 register tile of each of dwi, dwg and dwo per thread.  The block
// walks the slot's valid 32-row token tiles, listed by the wrapper in
// increasing order, stages x, g, dh1, dh2 and h of the tile in shared
// memory and accumulates the outer products in f32.  Every sum is taken in
// one fixed order by one thread: no atomics, so the result is the same
// from run to run (random-init gpt-moe-s amplifies run-to-run differences
// into route flips).  A slot without a valid row writes zero gradients.
#include "grouped_mlp.cuh"

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------
template <typename T, bool GATE, int ACT>
__global__ void __launch_bounds__(GM_THREADS)
    grouped_mlp_dgrad_kernel(const T* __restrict__ dy,
                             const T* __restrict__ woT,
                             const T* __restrict__ wiT,
                             const T* __restrict__ wgT,
                             const int* __restrict__ mask,
                             const T* __restrict__ h1,
                             const T* __restrict__ h2, T* __restrict__ dx,
                             T* __restrict__ dh1o, T* __restrict__ dh2o,
                             T* __restrict__ ho, int Tn, int D, int F) {
  constexpr int bt = GM_BT_TRAIN;
  extern __shared__ float smem[];
  float* gs = smem;               // [GM_R][D] masked dy rows, f32
  float* d1s = gs + GM_R * D;     // [GM_R][GM_BF] dh1 chunk, f32
  float* d2s = d1s + GM_R * GM_BF;  // [GM_R][GM_BF] dh2 chunk (GATE)
  __shared__ int rowv[GM_R];

  const int k = blockIdx.y;
  const int t0 = blockIdx.x * bt;
  const int tid = threadIdx.x;
  const T* gk = dy + (size_t)k * Tn * D;
  const T* woTk = woT + (size_t)k * D * F;
  const T* wiTk = wiT + (size_t)k * F * D;
  const T* wgTk = GATE ? wgT + (size_t)k * F * D : nullptr;
  const int* mk = mask + (size_t)k * Tn;
  const T* h1k = h1 + (size_t)k * Tn * F;
  const T* h2k = GATE ? h2 + (size_t)k * Tn * F : nullptr;
  T* dxk = dx + (size_t)k * Tn * D;
  T* dh1k = dh1o + (size_t)k * Tn * F;
  T* dh2k = GATE ? dh2o + (size_t)k * Tn * F : nullptr;
  T* hk = ho + (size_t)k * Tn * F;
  const int t_end = min(t0 + bt, Tn);

  const int mine = (tid < t_end - t0) ? (mk[t0 + tid] > 0) : 0;
  const bool skip_tile = __syncthreads_count(mine) == 0;
  for (int r0 = t0; r0 < t_end; r0 += GM_R) {
    const int nr = min(GM_R, t_end - r0);
    int v = 0;
    if (!skip_tile) {
      v = (tid < nr) ? (mk[r0 + tid] > 0) : 0;
      if (tid < GM_R) rowv[tid] = v;
    }
    if (skip_tile || __syncthreads_count(v) == 0) {
      write_zero_rows(dxk, r0, nr, D);
      write_zero_rows(dh1k, r0, nr, F);
      write_zero_rows(hk, r0, nr, F);
      if (GATE) write_zero_rows(dh2k, r0, nr, F);
      continue;
    }
    load_rows(gs, gk, rowv, r0, nr, D);
    float acc[GM_R][GM_MAXJ];
#pragma unroll
    for (int r = 0; r < GM_R; ++r)
#pragma unroll
      for (int j = 0; j < GM_MAXJ; ++j) acc[r][j] = 0.0f;
    __syncthreads();

    const int fl = tid % GM_BF;
    const int rg = tid / GM_BF;
    for (int f0 = 0; f0 < F; f0 += GM_BF) {
      const int f = f0 + fl;
      float dh[GM_RPT], unused[GM_RPT];
      if (f < F) {
        rows_dot_cols<T, false>(gs, woTk, nullptr, D, F, f, rg, dh, unused);
      } else {
#pragma unroll
        for (int c = 0; c < GM_RPT; ++c) dh[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < GM_RPT; ++c) {
        const int row = rg + GM_RG * c;
        float d1 = 0.0f, d2 = 0.0f, h = 0.0f;
        if (f < F && row < nr && rowv[row]) {
          const size_t o = (size_t)(r0 + row) * F + f;
          float a;
          const float da = act_and_grad<ACT>(to_f(h1k[o]), &a);
          if (GATE) {
            const float v2 = to_f(h2k[o]);
            d1 = da * (dh[c] * v2);
            d2 = dh[c] * a;
            h = a * v2;
          } else {
            d1 = da * dh[c];
            h = a;
          }
        }
        if (f < F && row < nr) {
          const size_t o = (size_t)(r0 + row) * F + f;
          dh1k[o] = from_f<T>(d1);
          hk[o] = from_f<T>(h);
          if (GATE) dh2k[o] = from_f<T>(d2);
        }
        d1s[row * GM_BF + fl] = d1;  // dx takes the unrounded values
        if (GATE) d2s[row * GM_BF + fl] = d2;
      }
      __syncthreads();
      // dx += dh1_chunk @ wiᵀ[f0:f0+nf, :] [+ dh2_chunk @ wgᵀ[f0:f0+nf, :]]
      rows_times_chunk<T, GATE>(acc, d1s, d2s, wiTk, wgTk, f0,
                                min(GM_BF, F - f0), D);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < GM_R; ++r) {
      if (r < nr) {
#pragma unroll
        for (int j = 0; j < GM_MAXJ; ++j) {
          const int d = tid + j * GM_THREADS;
          if (d < D)
            dxk[(size_t)(r0 + r) * D + d] =
                from_f<T>(rowv[r] ? acc[r][j] : 0.0f);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool GATE, int ACT>
static int launch_dgrad(const void* dy, const void* woT, const void* wiT,
                        const void* wgT, const int* mask, const void* h1,
                        const void* h2, void* dx, void* dh1, void* dh2,
                        void* h, int K, int Tn, int D, int F,
                        cudaStream_t stream) {
  auto kern = grouped_mlp_dgrad_kernel<T, GATE, ACT>;
  const size_t smem =
      (size_t)(GM_R * D + 2 * GM_R * GM_BF) * sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tn + GM_BT_TRAIN - 1) / GM_BT_TRAIN, K);
  kern<<<grid, GM_THREADS, smem, stream>>>(
      (const T*)dy, (const T*)woT, (const T*)wiT, (const T*)wgT, mask,
      (const T*)h1, (const T*)h2, (T*)dx, (T*)dh1, (T*)dh2, (T*)h, Tn, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_dgrad(const void* dy, const void* woT, const void* wiT,
                          const void* wgT, const int* mask, const void* h1,
                          const void* h2, void* dx, void* dh1, void* dh2,
                          void* h, int K, int Tn, int D, int F, int act,
                          cudaStream_t s) {
#define GM_DGRAD_ARGS dy, woT, wiT, wgT, mask, h1, h2, dx, dh1, dh2, h, K, Tn, \
                      D, F, s
  if (wgT != nullptr) {
    if (act == ACT_SILU) return launch_dgrad<T, true, ACT_SILU>(GM_DGRAD_ARGS);
    return launch_dgrad<T, true, ACT_GELU>(GM_DGRAD_ARGS);
  }
  if (act == ACT_SILU) return launch_dgrad<T, false, ACT_SILU>(GM_DGRAD_ARGS);
  return launch_dgrad<T, false, ACT_GELU>(GM_DGRAD_ARGS);
#undef GM_DGRAD_ARGS
}

// dy: (K, T, D); woT: (K, D, F); wiT, wgT: (K, F, D); h1, h2: (K, T, F);
// mask: (K, T) int32; outputs dx: (K, T, D), dh1, dh2, h: (K, T, F).  All
// contiguous and of one dtype.  wgT, h2 and dh2 are NULL without a gate.
// h1 and h2 are read at valid rows only.  act: 0 gelu (tanh form), 1 silu.
REPRO_EXPORT int grouped_mlp_dgrad(const void* dy, const void* woT,
                                   const void* wiT, const void* wgT,
                                   const int* mask, const void* h1,
                                   const void* h2, void* dx, void* dh1,
                                   void* dh2, void* h, int K, int Tn, int D,
                                   int F, int act, int dtype,
                                   void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 || D > GM_MAXJ * GM_THREADS ||
      (wgT != nullptr && (h2 == nullptr || dh2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return dispatch_dgrad<__nv_bfloat16>(dy, woT, wiT, wgT, mask, h1, h2, dx,
                                         dh1, dh2, h, K, Tn, D, F, act, s);
  if (dtype == DTYPE_F32)
    return dispatch_dgrad<float>(dy, woT, wiT, wgT, mask, h1, h2, dx, dh1,
                                 dh2, h, K, Tn, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------
constexpr int WG_TILE = 32;  // token rows per staged tile
constexpr int WG_B = 64;     // D and F width of a block's output tile

template <typename T, bool GATE>
__global__ void __launch_bounds__(GM_THREADS)
    grouped_mlp_wgrad_kernel(const T* __restrict__ x,
                             const T* __restrict__ dy,
                             const int* __restrict__ mask,
                             const T* __restrict__ dh1,
                             const T* __restrict__ dh2,
                             const T* __restrict__ h,
                             const int* __restrict__ tiles,
                             const int* __restrict__ ntiles,
                             T* __restrict__ dwi, T* __restrict__ dwg,
                             T* __restrict__ dwo, int Tn, int D, int F,
                             int n_tile) {
  __shared__ float xs[WG_TILE][WG_B];   // x[t][d0 + c]
  __shared__ float gs[WG_TILE][WG_B];   // g[t][d0 + c]
  __shared__ float d1s[WG_TILE][WG_B];  // dh1[t][f0 + c]
  __shared__ float d2s[GATE ? WG_TILE : 1][WG_B];
  __shared__ float hs[WG_TILE][WG_B];   // h[t][f0 + c]
  __shared__ int rowv[WG_TILE];

  const int f0 = blockIdx.x * WG_B;
  const int d0 = blockIdx.y * WG_B;
  const int k = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t rk = (size_t)k * Tn;  // first row of slot k

  float ai[4][4], ag[4][4], ao[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ai[i][j] = ag[i][j] = ao[i][j] = 0.0f;

  const int nt = ntiles[k];
  for (int it = 0; it < nt; ++it) {
    const int t0 = tiles[(size_t)k * n_tile + it] * WG_TILE;
    if (tid < WG_TILE) {
      const int t = t0 + tid;
      rowv[tid] = (t < Tn) ? (mask[rk + t] > 0) : 0;
    }
    __syncthreads();
    for (int e = tid; e < WG_TILE * WG_B; e += GM_THREADS) {
      const int r = e / WG_B;
      const int c = e % WG_B;
      const size_t row = rk + t0 + r;
      const bool ok = rowv[r] != 0;
      const bool dok = ok && d0 + c < D;
      const bool fok = ok && f0 + c < F;
      xs[r][c] = dok ? to_f(x[row * D + d0 + c]) : 0.0f;
      gs[r][c] = dok ? to_f(dy[row * D + d0 + c]) : 0.0f;
      d1s[r][c] = fok ? to_f(dh1[row * F + f0 + c]) : 0.0f;
      if (GATE) d2s[r][c] = fok ? to_f(dh2[row * F + f0 + c]) : 0.0f;
      hs[r][c] = fok ? to_f(h[row * F + f0 + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG_TILE; ++r) {
      float xv[4], hv[4], dv[4], d2v[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = xs[r][ty + 16 * i];
        hv[i] = hs[r][ty + 16 * i];
        dv[i] = d1s[r][tx + 16 * i];
        d2v[i] = GATE ? d2s[r][tx + 16 * i] : 0.0f;
        gv[i] = gs[r][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ai[i][j] = fmaf(xv[i], dv[j], ai[i][j]);
          if (GATE) ag[i][j] = fmaf(xv[i], d2v[j], ag[i][j]);
          ao[i][j] = fmaf(hv[i], gv[j], ao[i][j]);
        }
    }
    __syncthreads();
  }
  // dwi/dwg[k][d][f] with d = d0 + ty + 16 i, f = f0 + tx + 16 j;
  // dwo[k][f][d] with f = f0 + ty + 16 i, d = d0 + tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + ty + 16 * i, f = f0 + tx + 16 * j;
      if (d < D && f < F) {
        dwi[((size_t)k * D + d) * F + f] = from_f<T>(ai[i][j]);
        if (GATE) dwg[((size_t)k * D + d) * F + f] = from_f<T>(ag[i][j]);
      }
      const int fo = f0 + ty + 16 * i, dd = d0 + tx + 16 * j;
      if (fo < F && dd < D)
        dwo[((size_t)k * F + fo) * D + dd] = from_f<T>(ao[i][j]);
    }
}

template <typename T, bool GATE>
static int launch_wgrad(const void* x, const void* dy, const int* mask,
                        const void* dh1, const void* dh2, const void* h,
                        const int* tiles, const int* ntiles, void* dwi,
                        void* dwg, void* dwo, int K, int Tn, int D, int F,
                        int n_tile, cudaStream_t stream) {
  dim3 grid((F + WG_B - 1) / WG_B, (D + WG_B - 1) / WG_B, K);
  grouped_mlp_wgrad_kernel<T, GATE><<<grid, GM_THREADS, 0, stream>>>(
      (const T*)x, (const T*)dy, mask, (const T*)dh1, (const T*)dh2,
      (const T*)h, tiles, ntiles, (T*)dwi, (T*)dwg, (T*)dwo, Tn, D, F,
      n_tile);
  return (int)cudaGetLastError();
}

// x, dy: (K, T, D); dh1, dh2, h: (K, T, F); mask: (K, T) int32; tiles:
// (K, n_tile) int32, slot k's valid 32-row token tiles in increasing order
// in its first ntiles[k] entries (ntiles: (K,) int32); outputs dwi, dwg:
// (K, D, F), dwo: (K, F, D).  All contiguous, one dtype; dh2 and dwg are
// NULL without a gate.  n_tile = ceil(T / 32).
REPRO_EXPORT int grouped_mlp_wgrad(const void* x, const void* dy,
                                   const int* mask, const void* dh1,
                                   const void* dh2, const void* h,
                                   const int* tiles, const int* ntiles,
                                   void* dwi, void* dwg, void* dwo, int K,
                                   int Tn, int D, int F, int n_tile,
                                   int dtype, void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 ||
      n_tile != (Tn + WG_TILE - 1) / WG_TILE ||
      (dh2 == nullptr) != (dwg == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool gate = dh2 != nullptr;
#define GM_WGRAD_ARGS x, dy, mask, dh1, dh2, h, tiles, ntiles, dwi, dwg, dwo, \
                      K, Tn, D, F, n_tile, s
  if (dtype == DTYPE_BF16)
    return gate ? launch_wgrad<__nv_bfloat16, true>(GM_WGRAD_ARGS)
                : launch_wgrad<__nv_bfloat16, false>(GM_WGRAD_ARGS);
  if (dtype == DTYPE_F32)
    return gate ? launch_wgrad<float, true>(GM_WGRAD_ARGS)
                : launch_wgrad<float, false>(GM_WGRAD_ARGS);
#undef GM_WGRAD_ARGS
  return (int)cudaErrorInvalidValue;
}
