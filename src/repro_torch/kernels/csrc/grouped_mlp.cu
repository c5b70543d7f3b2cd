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
// hundreds of tokens and the products are bound by operations.  In
// training the contract's whole y (1.6 GB at gpt-moe-s training shapes,
// 97% of its rows invalid) is most of the bytes.
//
// Training form, bfloat16 (the main path's; grouped_mlp_fwd_train_bf16):
// the products run on the tensor cores (mma.sync, grouped_mlp_tc.cuh).
// The wrapper lists the 64-row token tiles that hold a valid row, and
// blocks are launched over that list only: at world size 1 the capacity is
// every token of the call, so a grid over all tiles would be 97% blocks
// that only write zeros.  The FFN is two products, because a fused block's
// 64 × D f32 accumulator does not fit in registers at D = 768:
//   1. over (listed tile, 128-wide F tile): h1 = x@wi, written as the
//      residual, and h = bf16(act(h1)) into a compact scratch of 64 rows
//      per listed tile; the blocks then write a share each of y's invalid
//      rows as zeros, which overlaps that bandwidth-bound work with the
//      other blocks' products;
//   2. over (listed tile, 128-wide D tile): y = h@wo from the scratch, at
//      valid rows.
// h is stored in bf16, exactly the value the TPU kernel feeds its second
// product (grouped_mlp.py:139); sums are f32 and y is rounded once.
//
// Inference form, bfloat16 (the serving path's; grouped_mlp_fwd_bf16): the
// same two products, with the h1 product's epilogue writing h alone (no
// residuals).  The serving tick is bound by the host, so this form reads
// nothing back and adds no host-side op: a one-block kernel in the same
// call builds its tile list (gm_tile_list_kernel) at the length the host
// knows, every tile of the call (K * ceil(T / 64)), the listed tiles first
// and -1 after them, and the scratch holds 64 rows per entry.  Blocks on
// a -1 entry only write their share of y's zero rows.  At a decode tick
// (8 valid rows in 8 of 64 slots) the kernel reads the 8 slots' weights
// once, one 64-row tile each; at a 512-token prefill (~16 rows in each
// slot) all 64 slots' weights, still once each.  Each output element is
// summed over F in one fixed order inside one block's accumulators: the
// same bits every run.
//
// The inference form and the training form in float32 keep the first
// port's loops on the FMA units:
// * one block per (slot k, token tile, range of F, chunk of 1,024 output
//   columns).  The TPU grid's sequential F axis becomes a loop inside the
//   block over 64-wide F chunks, and the block's (rows × 1,024) partial
//   output accumulates in f32 registers across that loop (4 columns a
//   thread).  Each column chunk's block computes the whole h chunk of its
//   rows again: at D = 2,048 the h products run twice, which keeps the
//   registers of the one-chunk case that D <= 1,024 runs;
// * inference form: each F range writes its partial sums to its own f32
//   plane, and a second kernel adds the planes in a fixed order (no
//   atomics: the result does not change from run to run) and rounds to the
//   input dtype.  Cutting F over blocks puts a decode tick's few active
//   slots on many SMs instead of one each;
// * float32 training form: no F split (its planes would scale with K × T).
//   The token tile is short (GM_BT_TRAIN = 32 rows), and the block writes
//   y itself: every row of its tile, zeros for invalid rows and skipped
//   tiles.  h1 and h2 are written only for the 16-row sub-tiles that hold
//   a valid row (zero on their invalid rows): elsewhere they stay
//   unwritten, as the TPU kernel leaves the residuals of its skipped tiles,
//   and dgrad reads them only at valid rows;
// * the block counts the valid rows of its tile itself (the TPU kernel got
//   that count by scalar prefetch) and exits when there are none; inside a
//   tile, 16-row sub-tiles without a valid row are skipped the same way;
// * rows are masked on input (zeroed in shared memory) and on output;
// * h is rounded to the input dtype before the product with wo, as the TPU
//   kernel does (grouped_mlp.py:139); all sums are f32, and y is rounded
//   to the input dtype once, at the end;
// * T and F may be ragged (bounds-checked loads); D <= GM_MAX_D keeps the
//   block's 16 input rows of D f32 values in shared memory for the whole
//   tile.  Up to twice that (XH: Jamba's experts at D = 4,096) they go
//   through shared memory in two halves of D for each F chunk, and the two
//   halves' sums of h are added (rows_dot_cols_halves): the rows are read
//   again for every F chunk, from L2.  The instantiations without XH are
//   those of D <= GM_MAX_D, unchanged.
#include "grouped_mlp_tc.cuh"

constexpr int GM_BT = 128;  // token tile of the inference form
static_assert(GM_BT % GM_R == 0 && GM_BT <= GM_THREADS, "see GM_BT_TRAIN");

template <typename T, bool GATE, int ACT, bool SAVE, bool XH>
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
  // [GM_R][D] masked input rows, f32 (XH: [GM_R][ceil(D / 2)], one half)
  float* xs = smem;
  float* hs = xs + GM_R * (XH ? (D + 1) / 2 : D);  // [GM_R][GM_BF] h chunk
  __shared__ int rowv[GM_R];

  const int k = blockIdx.y;
  const int nd = (D + GM_DC - 1) / GM_DC;  // column chunks
  const int dc = blockIdx.x % nd;
  const int d0 = dc * GM_DC, d_end = min(D, d0 + GM_DC);
  const int t0 = blockIdx.x / nd * bt;
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
    if (SAVE) write_zero_rows(yk, t0, t_end - t0, D, d0, d_end);
    return;
  }

  for (int r0 = t0; r0 < t_end; r0 += GM_R) {
    const int nr = min(GM_R, t_end - r0);
    const int v = (tid < nr) ? (mk[r0 + tid] > 0) : 0;
    if (tid < GM_R) rowv[tid] = v;
    if (__syncthreads_count(v) == 0) {  // no valid row here
      if (SAVE) write_zero_rows(yk, r0, nr, D, d0, d_end);
      continue;
    }
    if constexpr (!XH) load_rows(xs, xk, rowv, r0, nr, D);
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
      if constexpr (XH) {
        rows_dot_cols_halves<T, GATE>(xs, xk, rowv, r0, nr, wik, wgk, D, F,
                                      f, f < f_end, rg, a, g);
      } else if (f < f_end) {
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
        // residuals, from the first column chunk's block: invalid rows
        // were zeroed on input, so a = g = 0 there
        if (SAVE && dc == 0 && f < f_end && row < nr) {
          h1k[(size_t)(r0 + row) * F + f] = from_f<T>(a[c]);
          if (GATE) h2k[(size_t)(r0 + row) * F + f] = from_f<T>(g[c]);
        }
      }
      __syncthreads();
      // y += h_chunk @ wo[f0:f0+nf, :]
      rows_times_chunk<T, false>(acc, hs, nullptr, wok, nullptr, f0,
                                 min(GM_BF, f_end - f0), d0, D);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < GM_R; ++r) {
      if (r < nr && (SAVE || rowv[r])) {
#pragma unroll
        for (int j = 0; j < GM_MAXJ; ++j) {
          const int d = d0 + tid + j * GM_THREADS;
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

template <typename T, bool GATE, int ACT, bool SAVE, bool XH>
static int launch(const FwdArgs& a) {
  auto kern = grouped_mlp_fwd_kernel<T, GATE, ACT, SAVE, XH>;
  const size_t smem =
      (size_t)(GM_R * (XH ? (a.D + 1) / 2 : a.D) + GM_R * GM_BF) *
      sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int f_split = SAVE ? a.F : a.f_split;
  const int n_split = (a.F + f_split - 1) / f_split;
  constexpr int bt = SAVE ? GM_BT_TRAIN : GM_BT;
  dim3 grid((a.Tn + bt - 1) / bt * ((a.D + GM_DC - 1) / GM_DC), a.K,
            n_split);
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

template <typename T, bool SAVE, bool XH>
static int dispatch_xh(const FwdArgs& a) {
  if (a.wg != nullptr) {
    if (a.act == ACT_SILU) return launch<T, true, ACT_SILU, SAVE, XH>(a);
    return launch<T, true, ACT_GELU, SAVE, XH>(a);
  }
  if (a.act == ACT_SILU) return launch<T, false, ACT_SILU, SAVE, XH>(a);
  return launch<T, false, ACT_GELU, SAVE, XH>(a);
}

template <typename T, bool SAVE>
static int dispatch(const FwdArgs& a) {
  if (a.D > GM_MAX_D) return dispatch_xh<T, SAVE, true>(a);
  return dispatch_xh<T, SAVE, false>(a);
}

template <bool SAVE>
static int run(const FwdArgs& a, int dtype) {
  if (a.K <= 0 || a.Tn <= 0 || a.D <= 0 || a.F <= 0 ||
      a.D > 2 * GM_MAX_D ||
      (!SAVE && (a.f_split <= 0 || a.f_split % GM_BF)))
    return (int)cudaErrorInvalidValue;
  // bf16 is grouped_mlp_fwd_bf16 and grouped_mlp_fwd_train_bf16 (tensor
  // cores)
  if (dtype == DTYPE_F32) return dispatch<float, SAVE>(a);
  return (int)cudaErrorInvalidValue;
}

// Inference form, float32.  x: contiguous (K, T, D); wi/wg: (K, D, F)
// and wo: (K, F, D), each contiguous within a slot, slot k at element
// offset k * swi / swg / swo; mask: (K, T) int32.  wg may be NULL (no
// gate).  y: contiguous (K, T, D).  The F axis
// is cut into f_split-wide ranges (a multiple of 64), one block each; part
// is f32 scratch of (ceil(F / f_split), K, T, D) for their partial sums.
// D <= 2 * GM_MAX_D (6,144).  act: 0 gelu (tanh form), 1 silu.
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

// Training form, float32: as the inference form, without the F split, and
// with y: (K, T, D) and h1 (h2 when wg is given): (K, T, F), contiguous,
// float32.  y is written in full (zero on invalid rows); h1 and h2 only in
// the 16-row sub-tiles that hold a valid row (zero on their invalid rows).
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

// ---------------------------------------------------------------------------
// Both forms, bfloat16, on the tensor cores (grouped_mlp_tc.cuh)
// ---------------------------------------------------------------------------
constexpr int GL_THREADS = 1024;

// The inference form's tile list: the ids k * nt + t of the 64-row token
// tiles that hold a valid row, increasing, then -1 up to K * nt entries
// (ref.tile_list_padded is its plain version).  One block; each thread
// checks one tile per pass, and a block-wide count of the hits before it
// places the listed ones.
__global__ void __launch_bounds__(GL_THREADS)
    gm_tile_list_kernel(const int* __restrict__ mask, int K, int Tn,
                        int* __restrict__ tiles) {
  __shared__ int warp_hits[GL_THREADS / 32];
  const int nt = (Tn + TC_BM - 1) / TC_BM, n = K * nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int listed = 0;  // tiles listed by the passes before, in every thread
  for (int base = 0; base < n; base += GL_THREADS) {
    const int id = base + threadIdx.x;
    int hit = 0;
    if (id < n) {
      const int k = id / nt, t0 = (id - k * nt) * TC_BM;
      const int* m = mask + (size_t)k * Tn + t0;
      const int rows = min(TC_BM, Tn - t0);
#pragma unroll 16
      for (int r = 0; r < TC_BM; ++r) hit |= r < rows && m[r] > 0;
    }
    const unsigned b = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(b);
    __syncthreads();
    int at = listed + __popc(b & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < GL_THREADS / 32; ++w) {
      const int c = warp_hits[w];
      at += w < warp ? c : 0;
      total += c;
    }
    if (hit) tiles[at] = id;
    listed += total;
    __syncthreads();  // warp_hits is written again by the next pass
  }
  for (int i = listed + threadIdx.x; i < n; i += GL_THREADS) tiles[i] = -1;
}

template <int EPI, bool GATE, int ACT, bool VEC>
static int fwd_tc(const TcParams& ph, const TcParams& py, int n_tiles,
                  cudaStream_t s) {
  const int e = launch_tc<EPI, GATE, ACT, VEC>(ph, n_tiles, s);
  if (e) return e;
  // ACT is not read by y's epilogue: one instantiation serves both
  return launch_tc<TC_FWD_Y, false, ACT_GELU, VEC>(py, n_tiles, s);
}

template <int EPI>
static int fwd_bf16(const void* x, const void* wi, const void* wg,
                    const void* wo, const int* mask, const int* tiles,
                    int n_tiles, void* hs, void* y, void* h1, void* h2, int K,
                    int Tn, int D, int F, long long swi, long long swg,
                    long long swo, int act, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bool vec = tc_vec({x, wi, wg, wo, hs, y, h1, h2},
                          {D, F, swi, wg ? swg : 0, swo});
  const ZeroRows z{{(bf*)y}, {D}, 1};
  if (n_tiles == 0)
    return launch_zero_rows(mask, (long long)K * Tn, z, vec, s);
  if (EPI == TC_INF_H) {
    gm_tile_list_kernel<<<1, GL_THREADS, 0, s>>>(mask, K, Tn, (int*)tiles);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  TcParams ph{};   // h1 = x@wi [, h2 = x@wg] -> [h1, h2,] h scratch
  ph.a[0] = (const bf*)x;
  ph.b[0] = (const bf*)wi;
  ph.b[1] = (const bf*)wg;
  ph.sb[0] = swi;
  ph.sb[1] = swg;
  ph.mask = mask;
  ph.tiles = tiles;
  ph.o[0] = (bf*)h1;
  ph.o[1] = (bf*)h2;
  ph.o[2] = (bf*)hs;
  ph.T = Tn;
  ph.nt = (Tn + TC_BM - 1) / TC_BM;
  ph.Kd = D;
  ph.N = F;
  // y's zero rows, beside the products: each product's blocks take half
  ph.z = z;
  ph.z_first = 0;
  ph.z_last = (long long)K * Tn / 2;
  TcParams py = ph;  // y = h@wo from the scratch
  py.a[0] = (const bf*)hs;
  py.b[0] = (const bf*)wo;
  py.sb[0] = swo;
  py.o[0] = (bf*)y;
  py.Kd = F;
  py.N = D;
  py.z_first = ph.z_last;
  py.z_last = (long long)K * Tn;
#define GM_FWD_TC(G, A)                                          \
  return vec ? fwd_tc<EPI, G, A, true>(ph, py, n_tiles, s) \
             : fwd_tc<EPI, G, A, false>(ph, py, n_tiles, s)
  if (wg != nullptr) {
    if (act == ACT_SILU) GM_FWD_TC(true, ACT_SILU);
    GM_FWD_TC(true, ACT_GELU);
  }
  if (act == ACT_SILU) GM_FWD_TC(false, ACT_SILU);
  GM_FWD_TC(false, ACT_GELU);
#undef GM_FWD_TC
}

// Inference form.  x: contiguous (K, T, D); wi/wg: (K, D, F) and wo:
// (K, F, D), each dense within a slot, slot k at element offset
// k * swi / swg / swo; mask: (K, T) int32; tiles: int32 scratch of
// n_tiles = K * ceil(T / 64) entries, where the call lists the 64-row token
// tiles that hold a valid row as k * ceil(T / 64) + tile, increasing, then
// -1; hs: (n_tiles * 64, F) scratch for h = bf16(act(x@wi) [⊙ x@wg]).
// Output y: (K, T, D), written whole (zero on invalid rows).  All bfloat16;
// wg NULL without a gate.  act: 0 gelu (tanh form), 1 silu.
REPRO_EXPORT int grouped_mlp_fwd_bf16(const void* x, const void* wi,
                                      const void* wg, const void* wo,
                                      const int* mask, int* tiles,
                                      int n_tiles, void* hs, void* y, int K,
                                      int Tn, int D, int F, long long swi,
                                      long long swg, long long swo, int act,
                                      void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 ||
      n_tiles != K * ((Tn + TC_BM - 1) / TC_BM))
    return (int)cudaErrorInvalidValue;
  return fwd_bf16<TC_INF_H>(x, wi, wg, wo, mask, tiles, n_tiles, hs, y,
                            nullptr, nullptr, K, Tn, D, F, swi, swg, swo, act,
                            (cudaStream_t)stream);
}

// Training form.  As the inference form, with tiles: the n_tiles 64-row
// token tiles that hold a valid row (no -1 entries).  Outputs y: (K, T, D),
// written whole (zero on invalid rows), and h1 [h2]: (K, T, F), written on
// every row of the listed tiles (zero on their invalid rows).  h2 NULL
// without a gate.
REPRO_EXPORT int grouped_mlp_fwd_train_bf16(
    const void* x, const void* wi, const void* wg, const void* wo,
    const int* mask, const int* tiles, int n_tiles, void* hs, void* y,
    void* h1, void* h2, int K, int Tn, int D, int F, long long swi,
    long long swg, long long swo, int act, void* stream) {
  if (K <= 0 || Tn <= 0 || D <= 0 || F <= 0 || n_tiles < 0 ||
      (wg != nullptr && h2 == nullptr))
    return (int)cudaErrorInvalidValue;
  return fwd_bf16<TC_FWD_H>(x, wi, wg, wo, mask, tiles, n_tiles, hs, y, h1,
                            h2, K, Tn, D, F, swi, swg, swo, act,
                            (cudaStream_t)stream);
}
