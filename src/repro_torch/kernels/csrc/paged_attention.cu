// Block-paged decode attention (one query token per sequence).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_kernel
// (launched by paged_decode_attention): decode attention read in place
// from the flat KV pool (num_rows, nkv, hd) through a page table
// block_tbl (B, max_kv / page_size), native GQA, softcap before the mask,
// optional sliding window, online softmax in f32.
//
// What bounds it on an H100: bytes.  Each sequence's live KV rows are read
// once and feed a handful of multiply-adds each, so the kernel is bound by
// the KV rows it reads (plus a launch's fixed cost at small batch).  The
// design reads only the live pages: no (B, max_kv, ...) gather copy is
// made, pages wholly past a sequence's position or before its window are
// never read, and the group of query heads that shares a KV head reads
// its rows once, from shared memory.
//
// Design:
// * one block per (sequence b, KV head g), 4 warps; the TPU grid's KV-page
//   axis becomes a loop over the sequence's pages in which the block reads
//   block_tbl[b, i] itself (the TPU kernel got it by scalar prefetch);
// * a page's K and V rows of head g are staged in shared memory; warp w
//   serves query heads w, w+4, ... of the group; a lane scores one token
//   of the page, the warp reduces max and sum with shuffles;
// * token t counts iff t <= positions[b] and, with a window,
//   t > positions[b] - window; masked tokens add exactly zero mass, so the
//   trash page 0 never contributes to a live sequence, and an idle slot
//   parked on it (all-zero table, position 0) reduces over row 0 alone,
//   as the plain version does.
#include "common.cuh"

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_MAXHC = 4;   // hd <= 128
constexpr float PA_NEG_INF = -1e30f;

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ tbl,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int nq, int nkv, int hd, int num_rows, int n_blk,
                        int ps, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int G = nq / nkv;
  float* qs = smem;                  // [G][hd]
  float* acc = qs + G * hd;          // [G][hd]
  float* kp = acc + G * hd;          // [ps][hd + 1]
  float* vp = kp + ps * (hd + 1);    // [ps][hd]
  float* pb = vp + ps * hd;          // [PA_WARPS][32]
  float* ms = pb + PA_WARPS * 32;    // [G]
  float* ls = ms + G;                // [G]

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[b];

  for (int i = tid; i < G * hd; i += PA_THREADS) {
    qs[i] = to_f(q[((size_t)b * nq + (size_t)g * G) * hd + i]);
    acc[i] = 0.0f;
  }
  for (int i = tid; i < G; i += PA_THREADS) {
    ms[i] = PA_NEG_INF;
    ls[i] = 0.0f;
  }

  const int i_hi = min(pos / ps, n_blk - 1);
  for (int i = 0; i <= i_hi; ++i) {
    const int t0 = i * ps;
    if (window > 0 && t0 + ps - 1 <= pos - window) continue;  // pre-window
    int page = tbl[(size_t)b * n_blk + i];
    // a page id outside the pool reads the trash page instead of memory
    // past the pool's end
    if (page < 0 || (size_t)(page + 1) * ps > (size_t)num_rows) page = 0;
    __syncthreads();   // the previous page's readers are done
    for (int e = tid; e < ps * hd; e += PA_THREADS) {
      const int j = e / hd, h = e % hd;
      const size_t off =
          (((size_t)page * ps + j) * nkv + g) * (size_t)hd + h;
      kp[j * (hd + 1) + h] = to_f(kpool[off]);
      vp[j * hd + h] = to_f(vpool[off]);
    }
    __syncthreads();

    for (int hq = warp; hq < G; hq += PA_WARPS) {
      for (int jc = 0; jc < ps; jc += 32) {
        const int j = jc + lane;
        const int t = t0 + j;
        const bool ok = j < ps && t <= pos && (window <= 0 || t > pos - window);
        float s = PA_NEG_INF;
        if (j < ps) {
          float dot = 0.0f;
          const float* qr = qs + hq * hd;
          const float* kr = kp + j * (hd + 1);
          for (int h = 0; h < hd; ++h) dot = fmaf(qr[h], kr[h], dot);
          s = dot * scale;
          if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
          if (!ok) s = PA_NEG_INF;
        }
        const float m_old = ms[hq];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.0f;
        const float psum = warp_sum(p);
        const float alpha = expf(m_old - m_new);
        pb[warp * 32 + lane] = p;
        __syncwarp();
        const int nj = min(32, ps - jc);
#pragma unroll
        for (int c = 0; c < PA_MAXHC; ++c) {
          const int h = lane + 32 * c;
          if (h < hd) {
            float a = acc[hq * hd + h] * alpha;
            for (int jj = 0; jj < nj; ++jj)
              a = fmaf(pb[warp * 32 + jj], vp[(jc + jj) * hd + h], a);
            acc[hq * hd + h] = a;
          }
        }
        __syncwarp();
        if (lane == 0) {
          ms[hq] = m_new;
          ls[hq] = ls[hq] * alpha + psum;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += PA_THREADS) {
    const int hq = i / hd;
    out[((size_t)b * nq + (size_t)g * G) * hd + i] =
        from_f<T>(acc[i] / fmaxf(ls[hq], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* kpool, const void* vpool,
                  const int* tbl, const int* positions, void* out, int B,
                  int nq, int nkv, int hd, int num_rows, int n_blk, int ps,
                  int window, float softcap, float scale,
                  cudaStream_t stream) {
  const int G = nq / nkv;
  auto kern = paged_decode_kernel<T>;
  const size_t smem = (size_t)(2 * G * hd + ps * (hd + 1) + ps * hd +
                               PA_WARPS * 32 + 2 * G) * sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nkv, B);
  kern<<<grid, PA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)kpool, (const T*)vpool, tbl, positions, (T*)out,
      nq, nkv, hd, num_rows, n_blk, ps, window, softcap, scale);
  return (int)cudaGetLastError();
}

// q, out: contiguous (B, nq, hd); k/v pool: contiguous (num_rows, nkv, hd);
// tbl: (B, n_blk) int32 pool pages; positions: (B,) int32.  One dtype for
// q, pools and out.  nq % nkv == 0, num_rows % page_size == 0, hd <= 128.
REPRO_EXPORT int paged_decode_attention(
    const void* q, const void* kpool, const void* vpool, const int* tbl,
    const int* positions, void* out, int B, int nq, int nkv, int hd,
    int num_rows, int n_blk, int page_size, int window, float softcap,
    float scale, int dtype, void* stream) {
  if (B <= 0 || nkv <= 0 || nq % nkv != 0 || hd <= 0 ||
      hd > 32 * PA_MAXHC || page_size <= 0 || n_blk <= 0 ||
      num_rows % page_size != 0)
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
