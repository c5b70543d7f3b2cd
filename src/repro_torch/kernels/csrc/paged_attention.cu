// Block-paged decode attention (one query token per sequence).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_kernel
// (launched by paged_decode_attention): decode attention read in place
// from the flat KV pool (num_rows, nkv, hd) through a page table
// block_tbl (B, max_kv / page_size), native GQA, softcap before the mask,
// optional sliding window, online softmax in f32 on upcast inputs.
//
// What bounds it on an H100: bytes.  Each live KV row is read once and
// feeds a handful of multiply-adds, so the least time is the live rows
// over the memory rate: ~2 MB, 0.6 µs, at a served decode tick.  Far above
// that, a launch's fixed cost and the latency of the loads that depend on
// each other bound it.  The first version dealt the group's query heads
// to warps (with nq == nkv, 3 of 4 warps idled), scored one token per
// lane (24 of 32 lanes idled on an 8-token page) and walked the pages in
// series, two block barriers and one exposed memory round trip each
// (~38 in a row for a 300-token sequence); it took 0.15 ms at the tick.
//
// Design:
// * every warp works: one block per (sequence b, KV head g, chunk of up
//   to 4 query heads of g's group), 8 warps.  The live pages, from the
//   first page inside the window to pos // page_size, are dealt to the
//   warps round-robin (warp w takes pages lo + w, lo + w + 8, ...); each
//   warp reads its page ids from the table itself and keeps its own
//   online-softmax state (m, l, acc) for the chunk's heads in registers;
// * vector loads, lanes across hd: a lane loads 16 bytes of a K or V row
//   (hd / 8 lanes per bf16 row, so 4 rows per load at hd = 64), takes a
//   partial dot product over them and the row's lanes sum it by shuffles.
//   Each K row is scored for every head of the chunk while it is in
//   registers.  The loads of a warp's next page are issued before its
//   current page is computed (a register double buffer); no block-wide
//   barrier per page.  hd (or a pool row) that is not a multiple of 16
//   bytes loads element by element in the same kernel;
// * a merge in fixed order: the warps' states meet in shared memory and
//   fold in warp order 0, 1, ..., 7 (m = max, l and acc rescaled; an
//   empty state is m = -1e30, l = 0, acc = 0 and changes nothing).  No
//   atomics: two identical calls give the same bits;
// * token t counts iff t <= positions[b] and, with a window,
//   t > positions[b] - window; masked tokens add exactly zero mass, so the
//   trash page 0 never contributes to a live sequence, and an idle slot
//   parked on it (all-zero table, position 0) reduces over row 0 alone,
//   as the plain version does.  All arithmetic is f32 (the TPU kernel
//   rounds nothing);
// * hd up to 256 (Gemma-2's 256): an instantiation of its own with a
//   256-wide merge buffer, so the hd <= 128 ones keep theirs.  A bf16 row
//   of 256 is 32 lanes of 16 bytes, as a row of 128 is 16; in f32 each
//   lane loads two 16-byte chunks of a row.  A step takes half the rows a
//   lane of the hd <= 128 kernels (2 in bf16, 1 in f32), which halves the
//   K/V double buffer that the wider rows and the query heads' doubled
//   accumulators would otherwise push into spills.
#include <stdint.h>

#include "common.cuh"

constexpr int PA_WARPS = 8;
constexpr int PA_THREADS = PA_WARPS * 32;
constexpr int PA_GM = 4;      // query heads per block (a chunk of a group)
constexpr float PA_NEG_INF = -1e30f;

// VEC elements of one row, as loaded by one lane
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Chunk {
  T x[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> load_chunk(const T* p, bool in) {
  Chunk<T, VEC> c;
  if (in) {
    if constexpr (sizeof(T) * VEC == 16) {    // one 16-byte load
      *reinterpret_cast<uint4*>(c.x) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) c.x[e] = p[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) c.x[e] = from_f<T>(0.0f);
  }
  return c;
}

// T: element type; VEC: elements per lane-load (16 bytes, or 1);
// NCH: loads per lane per row (hd > VEC · lanes per row); NR: rows per
// lane per page step; GM: query heads per block; HDM: the largest hd
template <typename T, int VEC, int NCH, int NR, int GM, int HDM>
__global__ void __launch_bounds__(PA_THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ tbl,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int nq, int nkv, int hd, int num_rows, int n_blk,
                        int ps, int lpr, int window, float softcap,
                        float scale) {
  __shared__ float sm_acc[PA_WARPS][GM][HDM];
  __shared__ float sm_m[PA_WARPS][GM], sm_l[PA_WARPS][GM];

  const int g = blockIdx.x, b = blockIdx.y;
  const int G = nq / nkv;
  const int h0 = blockIdx.z * GM;               // first head of the chunk
  const int gc = min(GM, G - h0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpl = 32 / lpr;                     // rows per load step
  const int lr = lane % lpr, rg = lane / lpr;   // lane in row, row group
  const int pos = positions[b];
  const size_t qbase = ((size_t)b * nq + (size_t)g * G + h0) * hd;

  // this lane's columns of the chunk's query heads
  float qf[GM][NCH][VEC];
#pragma unroll
  for (int h = 0; h < GM; ++h)
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c0 = (lr + lpr * i) * VEC;
      const bool in = h < gc && c0 < hd;
      Chunk<T, VEC> c = load_chunk<T, VEC>(q + qbase + (size_t)h * hd + c0,
                                           in);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[h][i][e] = to_f(c.x[e]);
    }

  // the live pages [lo, hi], dealt round-robin; a page of more than
  // NR · rpl rows goes as several steps
  const int hi = min(pos / ps, n_blk - 1);
  int lo = 0;
  if (window > 0) {
    const int first = pos - window + 1;
    if (first > 0) lo = first / ps;
  }
  const int step_rows = NR * rpl;
  const int spp = (ps + step_rows - 1) / step_rows;   // steps per page
  const int n_steps = (hi - lo + 1) * spp;

  Chunk<T, VEC> kc[2][NR][NCH], vc[2][NR][NCH];
  auto issue = [&](int u, int buf) {
    const int i = lo + u / spp;
    const int j0 = (u % spp) * step_rows + rg;
    int page = tbl[(size_t)b * n_blk + i];
    // a page id outside the pool reads the trash page instead of memory
    // past the pool's end
    if (page < 0 || (size_t)(page + 1) * ps > (size_t)num_rows) page = 0;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int j = j0 + r * rpl;
      const size_t row = ((size_t)page * ps + j) * nkv + g;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int c0 = (lr + lpr * c) * VEC;
        const bool in = j < ps && c0 < hd;
        kc[buf][r][c] = load_chunk<T, VEC>(kpool + row * hd + c0, in);
        vc[buf][r][c] = load_chunk<T, VEC>(vpool + row * hd + c0, in);
      }
    }
  };

  float m[GM], l[GM], acc[GM][NCH][VEC];
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    m[h] = PA_NEG_INF;
    l[h] = 0.0f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[h][i][e] = 0.0f;
  }

  // the steps of warp w: u = w, w + 8, ...  Two buffers, fixed indices:
  // the loop body is unrolled twice so that no buffer index is dynamic
  auto compute = [&](int u, int buf) {
    const int i = lo + u / spp;
    const int j0 = (u % spp) * step_rows + rg;
    float s[GM][NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int j = j0 + r * rpl;
      const int t = i * ps + j;
      const bool ok = j < ps && t <= pos && (window <= 0 || t > pos - window);
#pragma unroll
      for (int h = 0; h < GM; ++h) {
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(qf[h][c][e], to_f(kc[buf][r][c].x[e]), dot);
        for (int off = lpr >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float sc = dot * scale;
        if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
        s[h][r] = ok ? sc : PA_NEG_INF;
      }
    }
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      float mx = PA_NEG_INF;
#pragma unroll
      for (int r = 0; r < NR; ++r) mx = fmaxf(mx, s[h][r]);
      for (int off = lpr; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][c][e] *= alpha;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        // a masked token is exactly the sentinel: p = 0, also while the
        // warp has seen no token (m_new is then the sentinel too)
        const float p = s[h][r] == PA_NEG_INF ? 0.0f : expf(s[h][r] - m_new);
        l[h] += p;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h][c][e] = fmaf(p, to_f(vc[buf][r][c].x[e]), acc[h][c][e]);
      }
    }
  };

  int u = warp;
  if (u < n_steps) issue(u, 0);
  while (u < n_steps) {
    if (u + PA_WARPS < n_steps) issue(u + PA_WARPS, 1);
    compute(u, 0);
    u += PA_WARPS;
    if (u >= n_steps) break;
    if (u + PA_WARPS < n_steps) issue(u + PA_WARPS, 0);
    compute(u, 1);
    u += PA_WARPS;
  }

  // the warp's state: l and acc summed over its row groups (a butterfly,
  // so every lane holds the same bits), then parked in shared memory
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    for (int off = lpr; off < 32; off <<= 1) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[h][c][e] += __shfl_xor_sync(0xffffffffu, acc[h][c][e], off);
    }
    if (rg == 0) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int c0 = (lr + lpr * c) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (c0 + e < hd) sm_acc[warp][h][c0 + e] = acc[h][c][e];
      }
    }
    if (lane == 0) {
      sm_m[warp][h] = m[h];
      sm_l[warp][h] = l[h];
    }
  }
  __syncthreads();

  // fold the warps' states in warp order
  for (int idx = threadIdx.x; idx < gc * hd; idx += PA_THREADS) {
    const int h = idx / hd, c = idx % hd;
    float M = sm_m[0][h], L = sm_l[0][h], A = sm_acc[0][h][c];
    for (int w = 1; w < PA_WARPS; ++w) {
      const float mw = sm_m[w][h];
      const float m_new = fmaxf(M, mw);
      const float a = expf(M - m_new), aw = expf(mw - m_new);
      L = L * a + sm_l[w][h] * aw;
      A = A * a + sm_acc[w][h][c] * aw;
      M = m_new;
    }
    out[qbase + (size_t)h * hd + c] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int VEC, int NCH, int NR, int HDM>
static int launch_nr(const void* q, const void* kpool, const void* vpool,
                     const int* tbl, const int* positions, void* out, int B,
                     int nq, int nkv, int hd, int num_rows, int n_blk, int ps,
                     int lpr, int window, float softcap, float scale,
                     cudaStream_t stream) {
  const int G = nq / nkv;
  const int gm = G <= 1 ? 1 : G <= 2 ? 2 : PA_GM;
  dim3 grid(nkv, B, (G + gm - 1) / gm);
#define PA_LAUNCH(GMV)                                                       \
  paged_decode_kernel<T, VEC, NCH, NR, GMV, HDM>                            \
      <<<grid, PA_THREADS, 0, stream>>>(                                     \
      (const T*)q, (const T*)kpool, (const T*)vpool, tbl, positions,         \
      (T*)out, nq, nkv, hd, num_rows, n_blk, ps, lpr, window, softcap, scale)
  if (gm == 1)
    PA_LAUNCH(1);
  else if (gm == 2)
    PA_LAUNCH(2);
  else
    PA_LAUNCH(PA_GM);
#undef PA_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* kpool, const void* vpool,
                  const int* tbl, const int* positions, void* out, int B,
                  int nq, int nkv, int hd, int num_rows, int n_blk, int ps,
                  int window, float softcap, float scale,
                  cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);
  // 16-byte loads need hd a multiple of the vector and aligned operands
  const bool vec = hd % V16 == 0 &&
                   (((uintptr_t)q | (uintptr_t)kpool | (uintptr_t)vpool) &
                    15) == 0;
  int lpr = 1;                                   // lanes per row
  const int chunks = vec ? hd / V16 : hd;
  while (lpr < chunks && lpr < 32) lpr <<= 1;
  const int rpl = 32 / lpr;
  const int need = (ps + rpl - 1) / rpl;         // rows per lane per page
#define PA_ARGS                                                             \
  q, kpool, vpool, tbl, positions, out, B, nq, nkv, hd, num_rows, n_blk, ps, \
      lpr, window, softcap, scale, stream
  if (hd > 128) {    // hd <= 256: half the rows a step of hd <= 128's
    if (!vec) return launch_nr<T, 1, 8, 1, 256>(PA_ARGS);
    if constexpr (V16 == 8)                      // bf16: 32 lanes of 8
      return launch_nr<T, V16, 1, 2, 256>(PA_ARGS);
    else                                         // f32: 2 chunks a lane
      return launch_nr<T, V16, 2, 1, 256>(PA_ARGS);
  }
  if (!vec) return launch_nr<T, 1, 4, 4, 128>(PA_ARGS);   // hd <= 4 · 32
  if (need <= 2) return launch_nr<T, V16, 1, 2, 128>(PA_ARGS);
  return launch_nr<T, V16, 1, 4, 128>(PA_ARGS);
#undef PA_ARGS
}

// q, out: contiguous (B, nq, hd); k/v pool: contiguous (num_rows, nkv, hd);
// tbl: (B, n_blk) int32 pool pages; positions: (B,) int32.  One dtype for
// q, pools and out.  nq % nkv == 0, num_rows % page_size == 0, hd <= 256.
REPRO_EXPORT int paged_decode_attention(
    const void* q, const void* kpool, const void* vpool, const int* tbl,
    const int* positions, void* out, int B, int nq, int nkv, int hd,
    int num_rows, int n_blk, int page_size, int window, float softcap,
    float scale, int dtype, void* stream) {
  if (B <= 0 || nkv <= 0 || nq % nkv != 0 || hd <= 0 || hd > 256 ||
      page_size <= 0 || n_blk <= 0 || num_rows % page_size != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, kpool, vpool, tbl, positions, out, B, nq,
                                 nkv, hd, num_rows, n_blk, page_size, window,
                                 softcap, scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, kpool, vpool, tbl, positions, out, B, nq, nkv, hd,
                         num_rows, n_blk, page_size, window, softcap, scale,
                         s);
  return (int)cudaErrorInvalidValue;
}
