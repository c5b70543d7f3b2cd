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
// What bounds them on an H100: dgrad's whole dx, dh1 and h (7.8 GB at
// gpt-moe-s training shapes, 97% of the rows invalid) are most of its
// bytes, and at ~128 valid rows per slot its products are far above the
// card's bytes-per-operation line.  wgrad at those shapes reads 0.3 GB of
// valid rows and writes 0.3 GB of gradients for 155 GFLOP: its bound is
// the bytes (0.18 ms) by a little over the operations (0.16 ms).
//
// dgrad, bfloat16 (the main path's; grouped_mlp_dgrad_bf16): a pass that
// writes the invalid rows of dx, dh1 and h as zeros (measured faster as a
// pass of its own at full occupancy than shared out to the product
// blocks), then two tensor-core products (grouped_mlp_tc.cuh) over the
// 64-row token tiles that hold a valid row:
//   1. over (listed tile, 128-wide F tile): dh = g@woᵀ, with wo read in the
//      layout the slot holds it; the epilogue reads h1 at valid rows and
//      writes dh1 and h there, and lo = bf16(dh1 - bf16(dh1)) into a
//      compact scratch;
//   2. over (listed tile, 128-wide D tile): dx = (hi + lo)@wiᵀ at valid
//      rows, hi being the dh1 output.  A bf16 product cannot take the f32
//      dh1 that the TPU kernel multiplies (grouped_mlp.py:253-263); the two
//      terms carry it to ~2^-16, for three products instead of two.
// No weight is transposed or copied.
//
// dgrad, float32: the forward kernel's FMA loops with the weights
// transposed.  The wrapper passes woᵀ as (K, D, F) and wiᵀ/wgᵀ as
// (K, F, D), contiguous copies, so that dh = g@woᵀ is the forward's x@wi
// loop and dx = dh1@wiᵀ its h@wo loop, both with neighbouring threads on
// neighbouring addresses.  One block per (slot, 32-row token tile:
// GM_BT_TRAIN, chunk of 1,024 columns of dx: GM_DC); it counts its valid
// rows itself and skips tiles and 16-row sub-tiles without one.  Every
// column chunk's block computes the dh chunks of its rows, and the first
// one writes dh1, h and dh2 (the forward's split over D).  It reads h1
// and h2 at valid rows only.  It writes every row of its tile: zeros for
// invalid rows and skipped tiles, as the TPU kernel's skipped tiles write
// zeros (grouped_mlp.py:265-272).  D <= GM_MAX_D holds the tile's dy rows
// in shared memory; up to twice that (XH) they go through it in two halves
// of D for each F chunk, as in the forward.
//
// wgrad, bfloat16 (the main path's; grouped_mlp_wgrad_bf16): tensor-core
// products over the token rows.  One block per (128 × 128 output tile,
// slot, product), the products being dwi = xᵀ@dh1 [, dwg = xᵀ@dh2] and
// dwo = hᵀ@g.  The grid depends on K, D and F alone: no count is read
// back.  The block walks its slot's 64-row tiles of the forward's tile
// list (sorted by k * nt + t; the wrapper finds slot k's range
// [starts[k], starts[k + 1]) with a device-side searchsorted), one tile
// per stage of a 3-stage cp.async ring.  Both operands are read as they
// are stored, as row tiles (rows × 128 columns): the A operand (x or h)
// through ldmatrix.trans, which gives its transpose, and the B operand
// (dh1, dh2 or dy) through ldmatrix.trans as the forward reads wi.  A
// row's validity decides its copy: an invalid row is zero-filled by
// cp.async (source size 0) in both operands, which masks x and dy as the
// TPU kernel masks them (grouped_mlp.py:345-346).  Eight warps own 64 × 32
// of the output each as f32 accumulators; each output element is summed
// in one fixed order (the list's, then mma's) by one block: no atomics, no
// split over blocks, the same bits every run.  A slot without a valid tile
// writes zeros.  VEC = false loads element by element (D or F not a
// multiple of 8, rows not 16-byte aligned).
//
// wgrad, float32: the first port's FMA loops.  One block per (slot,
// 64-wide D tile, 64-wide F tile), with a 4×4 register tile of each of
// dwi, dwg and dwo per thread; it walks the same per-slot ranges of the
// 64-row tile list, in 32-row halves staged in shared memory.
#include "grouped_mlp_tc.cuh"

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------
template <typename T, bool GATE, int ACT, bool XH>
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
  // [GM_R][D] masked dy rows, f32 (XH: [GM_R][ceil(D / 2)], one half)
  float* gs = smem;
  float* d1s = gs + GM_R * (XH ? (D + 1) / 2 : D);  // [GM_R][GM_BF] dh1
  float* d2s = d1s + GM_R * GM_BF;  // [GM_R][GM_BF] dh2 chunk (GATE)
  __shared__ int rowv[GM_R];

  const int k = blockIdx.y;
  const int nd = (D + GM_DC - 1) / GM_DC;  // column chunks of dx
  const int dc = blockIdx.x % nd;
  const int d0 = dc * GM_DC, d_end = min(D, d0 + GM_DC);
  const int t0 = blockIdx.x / nd * bt;
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
      write_zero_rows(dxk, r0, nr, D, d0, d_end);
      if (dc == 0) {
        write_zero_rows(dh1k, r0, nr, F, 0, F);
        write_zero_rows(hk, r0, nr, F, 0, F);
        if (GATE) write_zero_rows(dh2k, r0, nr, F, 0, F);
      }
      continue;
    }
    if constexpr (!XH) load_rows(gs, gk, rowv, r0, nr, D);
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
      if constexpr (XH) {
        rows_dot_cols_halves<T, false>(gs, gk, rowv, r0, nr, woTk, nullptr,
                                       D, F, f, f < F, rg, dh, unused);
      } else if (f < F) {
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
        if (dc == 0 && f < F && row < nr) {
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
                                min(GM_BF, F - f0), d0, D);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < GM_R; ++r) {
      if (r < nr) {
#pragma unroll
        for (int j = 0; j < GM_MAXJ; ++j) {
          const int d = d0 + tid + j * GM_THREADS;
          if (d < D)
            dxk[(size_t)(r0 + r) * D + d] =
                from_f<T>(rowv[r] ? acc[r][j] : 0.0f);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool GATE, int ACT, bool XH>
static int launch_dgrad(const void* dy, const void* woT, const void* wiT,
                        const void* wgT, const int* mask, const void* h1,
                        const void* h2, void* dx, void* dh1, void* dh2,
                        void* h, int K, int Tn, int D, int F,
                        cudaStream_t stream) {
  auto kern = grouped_mlp_dgrad_kernel<T, GATE, ACT, XH>;
  const size_t smem =
      (size_t)(GM_R * (XH ? (D + 1) / 2 : D) + 2 * GM_R * GM_BF) *
      sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tn + GM_BT_TRAIN - 1) / GM_BT_TRAIN * ((D + GM_DC - 1) / GM_DC),
            K);
  kern<<<grid, GM_THREADS, smem, stream>>>(
      (const T*)dy, (const T*)woT, (const T*)wiT, (const T*)wgT, mask,
      (const T*)h1, (const T*)h2, (T*)dx, (T*)dh1, (T*)dh2, (T*)h, Tn, D, F);
  return (int)cudaGetLastError();
}

template <typename T, bool XH>
static int dispatch_dgrad(const void* dy, const void* woT, const void* wiT,
                          const void* wgT, const int* mask, const void* h1,
                          const void* h2, void* dx, void* dh1, void* dh2,
                          void* h, int K, int Tn, int D, int F, int act,
                          cudaStream_t s) {
#define GM_DGRAD_ARGS dy, woT, wiT, wgT, mask, h1, h2, dx, dh1, dh2, h, K, Tn, \
                      D, F, s
  if (wgT != nullptr) {
    if (act == ACT_SILU)
      return launch_dgrad<T, true, ACT_SILU, XH>(GM_DGRAD_ARGS);
    return launch_dgrad<T, true, ACT_GELU, XH>(GM_DGRAD_ARGS);
  }
  if (act == ACT_SILU)
    return launch_dgrad<T, false, ACT_SILU, XH>(GM_DGRAD_ARGS);
  return launch_dgrad<T, false, ACT_GELU, XH>(GM_DGRAD_ARGS);
#undef GM_DGRAD_ARGS
}

// float32.  dy: (K, T, D); woT: (K, D, F); wiT, wgT: (K, F, D); h1, h2:
// (K, T, F); mask: (K, T) int32; outputs dx: (K, T, D), dh1, dh2, h:
// (K, T, F).  All contiguous.  wgT, h2 and dh2 are NULL without a gate.
// h1 and h2 are read at valid rows only.  D <= 2 * GM_MAX_D (6,144).  act:
// 0 gelu (tanh form), 1 silu.
REPRO_EXPORT int grouped_mlp_dgrad(const void* dy, const void* woT,
                                   const void* wiT, const void* wgT,
                                   const int* mask, const void* h1,
                                   const void* h2, void* dx, void* dh1,
                                   void* dh2, void* h, int K, int Tn, int D,
                                   int F, int act, int dtype,
                                   void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 || D > 2 * GM_MAX_D ||
      (wgT != nullptr && (h2 == nullptr || dh2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  // bf16 is grouped_mlp_dgrad_bf16 (tensor cores)
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if (D > GM_MAX_D)
    return dispatch_dgrad<float, true>(dy, woT, wiT, wgT, mask, h1, h2, dx,
                                       dh1, dh2, h, K, Tn, D, F, act,
                                       (cudaStream_t)stream);
  return dispatch_dgrad<float, false>(dy, woT, wiT, wgT, mask, h1, h2, dx,
                                      dh1, dh2, h, K, Tn, D, F, act,
                                      (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// dgrad, bfloat16, on the tensor cores (grouped_mlp_tc.cuh)
// ---------------------------------------------------------------------------
template <bool GATE, int ACT, bool VEC>
static int dgrad_tc(const TcParams& ph, const TcParams& px, int n_tiles,
                    cudaStream_t s) {
  const int e = launch_tc<TC_DG_DH, GATE, ACT, VEC>(ph, n_tiles, s);
  if (e) return e;
  // ACT is not read by dx's epilogue: one instantiation serves both
  return launch_tc<TC_DG_DX, GATE, ACT_GELU, VEC>(px, n_tiles, s);
}

// dy: contiguous (K, T, D); wi/wg: (K, D, F) and wo: (K, F, D), each dense
// within a slot, slot k at element offset k * swi / swg / swo (the layout
// the forward reads: no transposed copies); h1, h2: (K, T, F), read at valid
// rows; mask: (K, T) int32; tiles: the n_tiles 64-row token tiles that hold
// a valid row, as k * ceil(T / 64) + tile, increasing; lo: (n_tiles * 64, F)
// scratch (twice that with a gate) for dh1 - bf16(dh1) [and dh2 - bf16(dh2)].
// Outputs dx: (K, T, D), dh1, dh2, h: (K, T, F), contiguous, written whole
// (zero on invalid rows).  All bfloat16; wg, h2, dh2 NULL without a gate.
// act: 0 gelu (tanh form), 1 silu.
REPRO_EXPORT int grouped_mlp_dgrad_bf16(
    const void* dy, const void* wi, const void* wg, const void* wo,
    const int* mask, const void* h1, const void* h2, const int* tiles,
    int n_tiles, void* lo, void* dx, void* dh1, void* dh2, void* h, int K,
    int Tn, int D, int F, long long swi, long long swg, long long swo,
    int act, void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 || n_tiles < 0 ||
      (wg != nullptr && (h2 == nullptr || dh2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  cudaStream_t s = (cudaStream_t)stream;
  const bool gate = wg != nullptr;
  const bool vec = tc_vec({dy, wi, wg, wo, h1, h2, lo, dx, dh1, dh2, h},
                          {D, F, swi, gate ? swg : 0, swo});
  // the zero rows first, in a pass of their own at full occupancy: 7.8 GB
  // at training shapes, most of the call's time (sharing them out to the
  // product blocks, as the forward does with y's, measured slower here)
  const ZeroRows z{{(bf*)dx, (bf*)dh1, (bf*)h, (bf*)dh2}, {D, F, F, F},
                   gate ? 4 : 3};
  const int e = launch_zero_rows(mask, (long long)K * Tn, z, vec, s);
  if (e || n_tiles == 0) return e;
  bf* lo2 = gate ? (bf*)lo + (size_t)n_tiles * TC_BM * F : nullptr;
  TcParams ph{};  // dh = g@woᵀ -> dh1, h [, dh2], lo [, lo2]
  ph.a[0] = (const bf*)dy;
  ph.b[0] = (const bf*)wo;
  ph.sb[0] = swo;
  ph.mask = mask;
  ph.tiles = tiles;
  ph.e[0] = (const bf*)h1;
  ph.e[1] = (const bf*)h2;
  ph.o[0] = (bf*)dh1;
  ph.o[1] = (bf*)h;
  ph.o[2] = (bf*)dh2;
  ph.o[3] = (bf*)lo;
  ph.o[4] = lo2;
  ph.T = Tn;
  ph.nt = (Tn + TC_BM - 1) / TC_BM;
  ph.Kd = D;
  ph.N = F;
  TcParams px = ph;  // dx = (dh1 + lo)@wiᵀ [+ (dh2 + lo2)@wgᵀ]
  px.a[0] = (const bf*)dh1;
  px.a[1] = (const bf*)lo;
  px.a[2] = (const bf*)dh2;
  px.a[3] = lo2;
  px.b[0] = (const bf*)wi;
  px.b[1] = (const bf*)wg;
  px.sb[0] = swi;
  px.sb[1] = swg;
  px.o[0] = (bf*)dx;
  px.Kd = F;
  px.N = D;
#define GM_DGRAD_TC(G, A)                              \
  return vec ? dgrad_tc<G, A, true>(ph, px, n_tiles, s) \
             : dgrad_tc<G, A, false>(ph, px, n_tiles, s)
  if (gate) {
    if (act == ACT_SILU) GM_DGRAD_TC(true, ACT_SILU);
    GM_DGRAD_TC(true, ACT_GELU);
  }
  if (act == ACT_SILU) GM_DGRAD_TC(false, ACT_SILU);
  GM_DGRAD_TC(false, ACT_GELU);
#undef GM_DGRAD_TC
}

// ---------------------------------------------------------------------------
// wgrad, float32 (FMA units)
// ---------------------------------------------------------------------------
constexpr int WG_TILE = 32;  // token rows per staged half of a listed tile
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
                             const int* __restrict__ starts,
                             T* __restrict__ dwi, T* __restrict__ dwg,
                             T* __restrict__ dwo, int Tn, int D, int F) {
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
  const int nt = (Tn + TC_BM - 1) / TC_BM;

  float ai[4][4], ag[4][4], ao[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ai[i][j] = ag[i][j] = ao[i][j] = 0.0f;

  for (int it = starts[k]; it < starts[k + 1]; ++it)
    for (int half = 0; half < TC_BM / WG_TILE; ++half) {
      const int t0 = (tiles[it] - k * nt) * TC_BM + half * WG_TILE;
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

// x, dy: (K, T, D); dh1, dh2, h: (K, T, F); mask: (K, T) int32; tiles: the
// 64-row token tiles that hold a valid row, as k * ceil(T / 64) + tile,
// increasing; starts: (K + 1,) int32, slot k's tiles being
// tiles[starts[k]:starts[k + 1]]; outputs dwi, dwg: (K, D, F), dwo:
// (K, F, D).  All contiguous, float32; dh2 and dwg are NULL without a gate.
REPRO_EXPORT int grouped_mlp_wgrad(const void* x, const void* dy,
                                   const int* mask, const void* dh1,
                                   const void* dh2, const void* h,
                                   const int* tiles, const int* starts,
                                   void* dwi, void* dwg, void* dwo, int K,
                                   int Tn, int D, int F, int dtype,
                                   void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 ||
      (dh2 == nullptr) != (dwg == nullptr))
    return (int)cudaErrorInvalidValue;
  // bf16 is grouped_mlp_wgrad_bf16 (tensor cores)
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  dim3 grid((F + WG_B - 1) / WG_B, (D + WG_B - 1) / WG_B, K);
  auto kern = dh2 != nullptr ? grouped_mlp_wgrad_kernel<float, true>
                             : grouped_mlp_wgrad_kernel<float, false>;
  kern<<<grid, GM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dy, mask, (const float*)dh1,
      (const float*)dh2, (const float*)h, tiles, starts, (float*)dwi,
      (float*)dwg, (float*)dwo, Tn, D, F);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad, bfloat16, on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WT_BM = 128, WT_BN = 128;  // output tile (M × N)
constexpr int WT_BK = TC_BM;   // token rows of a stage: one listed tile
constexpr int WT_WARPS = 8;    // 2 (M) × 4 (N), 64 × 32 of the tile each
constexpr int WT_THREADS = WT_WARPS * 32;
constexpr int WT_STAGES = 3;
constexpr int WT_LD = WT_BM + 8;         // smem row stride (elements)
constexpr int WT_TILE = WT_BK * WT_LD;   // one operand of one stage
constexpr size_t WT_SMEM = (size_t)WT_STAGES * 2 * WT_TILE * 2;
static_assert(WT_BM == WT_BN && WT_BK * (WT_BM / 8) == 4 * WT_THREADS,
              "a stage is 4 16-byte chunks of one row per thread");

struct WgParams {
  const __nv_bfloat16* a[3];  // per product: A (K, T, M), read transposed
  const __nv_bfloat16* b[3];  // B (K, T, N)
  __nv_bfloat16* o[3];        // the product, (K, M, N)
  int m[3], n[3];
  const int* mask;    // (K, T) validity
  const int* tiles;   // the forward's 64-row tile list
  const int* starts;  // (K + 1,): slot k's range of it
  int T, nt;
};

template <bool VEC>
__global__ void __launch_bounds__(WT_THREADS, 2)
    gm_wgrad_tc_kernel(const WgParams p) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char wt_smem[];
  bf* sm = reinterpret_cast<bf*>(wt_smem);
  const int z = blockIdx.z, k = blockIdx.y;
  // product z's entries, selected without indexing the parameter arrays
  // (an index unknown at compile time copies them to local memory)
  auto pick = [z](const auto& v) {
    return z == 0 ? v[0] : z == 1 ? v[1] : v[2];
  };
  const int M = pick(p.m), N = pick(p.n);
  const int nbn = (N + WT_BN - 1) / WT_BN;
  const int m0 = (blockIdx.x / nbn) * WT_BM, n0 = (blockIdx.x % nbn) * WT_BN;
  if (m0 >= M) return;  // (every product has as many tiles; kept safe)
  const bf* A = pick(p.a) + (size_t)k * p.T * M;
  const bf* B = pick(p.b) + (size_t)k * p.T * N;
  const int* mk = p.mask + (size_t)k * p.T;
  const int lo = p.starts[k], n = p.starts[k + 1] - lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int lr = tid >> 2, lc = (tid & 3) * 8;  // loader: row, first column
  const bf zero = __float2bfloat16(0.0f);

  // The stage to issue next (s_next), its tile and this thread's row's
  // mask entry, and the tile after it: loaded one issue ahead and read at
  // the next issue, so no copy waits on the list or the mask.
  auto first_row = [&](int tile) { return (tile - k * p.nt) * WT_BK; };
  auto row_mask = [&](int tile) {
    const int t = first_row(tile) + lr;
    return t < p.T ? mk[t] : 0;
  };
  int s_next = 0;
  int tile_n = n > 0 ? p.tiles[lo] : 0;
  int tile_nn = n > 1 ? p.tiles[lo + 1] : 0;
  int mv_n = VEC && n > 0 ? row_mask(tile_n) : 0;

  auto issue = [&]() {
    bf* as = sm + (s_next % WT_STAGES) * 2 * WT_TILE;
    bf* bs = as + WT_TILE;
    const int t0 = first_row(tile_n);
    if (VEC) {
      const bf* ar = A + (size_t)(t0 + lr) * M + m0;
      const bf* br = B + (size_t)(t0 + lr) * N + n0;
#pragma unroll
      for (int j = 0; j < WT_BM / 32; ++j) {
        const int c = lc + 32 * j;
        const bool ia = mv_n > 0 && m0 + c < M, ib = mv_n > 0 && n0 + c < N;
        cp_async16(as + lr * WT_LD + c, ia ? ar + c : A, ia);
        cp_async16(bs + lr * WT_LD + c, ib ? br + c : B, ib);
      }
      mv_n = s_next + 1 < n ? row_mask(tile_nn) : 0;
    } else {
      for (int e = tid; e < WT_BK * WT_BM; e += WT_THREADS) {
        const int r = e / WT_BM, c = e % WT_BM, t = t0 + r;
        const bool ok = t < p.T && mk[t] > 0;
        as[r * WT_LD + c] =
            ok && m0 + c < M ? A[(size_t)t * M + m0 + c] : zero;
        bs[r * WT_LD + c] =
            ok && n0 + c < N ? B[(size_t)t * N + n0 + c] : zero;
      }
    }
    tile_n = tile_nn;
    tile_nn = s_next + 2 < n ? p.tiles[lo + s_next + 2] : 0;
    ++s_next;
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < WT_STAGES - 1; ++s) {
    if (s < n) issue();
    cp_async_commit();
  }
  const int mi = lane >> 3, r8 = lane & 7;
  for (int kt = 0; kt < n; ++kt) {
    cp_async_wait<WT_STAGES - 2>();  // stage kt has landed
    __syncthreads();                 // ... for every thread; kt - 1 is done
    if (kt + WT_STAGES - 1 < n) issue();
    cp_async_commit();
    const bf* as = sm + (kt % WT_STAGES) * 2 * WT_TILE;
    const bf* bs = as + WT_TILE;
#pragma unroll
    for (int kk = 0; kk < WT_BK / 16; ++kk) {
      const int kr = kk * 16 + r8;
      unsigned bfr[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned r4[4];
        ldsm_x4_t(r4, bs + (kr + (mi & 1) * 8) * WT_LD + wn * 32 + jp * 16 +
                          (mi >> 1) * 8);
        bfr[2 * jp][0] = r4[0];
        bfr[2 * jp][1] = r4[1];
        bfr[2 * jp + 1][0] = r4[2];
        bfr[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // A stored (rows, M): the transposed read gives the (M, rows)
        // fragment, matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7,
        // k 8-15), (m 8-15, k 8-15)
        unsigned af[4];
        ldsm_x4_t(af, as + (kr + (mi >> 1) * 8) * WT_LD + wm * 64 + mt * 16 +
                          (mi & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af, bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // this thread's rows m0 + wm·64 + mt·16 + g (+ 8), columns
  // n0 + wn·32 + nt·8 + 2·t4 (+ 1)
  const int g = lane >> 2, t4 = lane & 3;
  bf* o = pick(p.o) + (size_t)k * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 64 + mt * 16 + g + hf * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn * 32 + nt * 8 + 2 * t4;
        store2<VEC>(o, (size_t)m * N + c, c, N, acc[mt][nt][2 * hf],
                    acc[mt][nt][2 * hf + 1]);
      }
    }
}

// x, dy: (K, T, D); dh1, dh2, h: (K, T, F); mask, tiles, starts as for
// grouped_mlp_wgrad; outputs dwi, dwg: (K, D, F), dwo: (K, F, D).  All
// contiguous, bfloat16; dh2 and dwg are NULL without a gate.
REPRO_EXPORT int grouped_mlp_wgrad_bf16(const void* x, const void* dy,
                                        const int* mask, const void* dh1,
                                        const void* dh2, const void* h,
                                        const int* tiles, const int* starts,
                                        void* dwi, void* dwg, void* dwo,
                                        int K, int Tn, int D, int F,
                                        void* stream) {
  if (K <= 0 || K > 65535 || Tn <= 0 || D <= 0 || F <= 0 ||
      (dh2 == nullptr) != (dwg == nullptr))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const bool gate = dh2 != nullptr;
  WgParams p{};
  int np = 0;
  auto product = [&](const void* a, const void* b, void* o, int m, int n) {
    p.a[np] = (const bf*)a;
    p.b[np] = (const bf*)b;
    p.o[np] = (bf*)o;
    p.m[np] = m;
    p.n[np] = n;
    ++np;
  };
  product(x, dh1, dwi, D, F);
  if (gate) product(x, dh2, dwg, D, F);
  product(h, dy, dwo, F, D);
  p.mask = mask;
  p.tiles = tiles;
  p.starts = starts;
  p.T = Tn;
  p.nt = (Tn + TC_BM - 1) / TC_BM;
  const bool vec = tc_vec({x, dy, dh1, dh2, h, dwi, dwg, dwo}, {D, F});
  auto kern = vec ? gm_wgrad_tc_kernel<true> : gm_wgrad_tc_kernel<false>;
  cudaError_t e = allow_smem(kern, WT_SMEM);
  if (e != cudaSuccess) return (int)e;
  // as many output tiles in dwo (F × D) as in dwi (D × F)
  dim3 grid(((D + WT_BM - 1) / WT_BM) * ((F + WT_BN - 1) / WT_BN), K, np);
  kern<<<grid, WT_THREADS, WT_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
