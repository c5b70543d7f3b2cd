// Flash attention, forward (prefill).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention): blockwise online-softmax attention over
// q/k/v in the (B, S, N, H) layout, equal heads (GQA is expanded by the
// caller), causal and/or sliding-window mask, f32 m/l/acc.
//
// What bounds it on an H100: the work is ~2·S²·H multiply-adds per head
// (half of it under a causal mask) against 4·S·H elements moved, so at the
// served prompt buckets (S = 32..512, H = 64) it is bound by operations
// run on the bf16 tensor cores, and below that by how many SMs the grid
// keeps busy and by the latency of each KV tile's load.  The first
// version of this kernel ran every multiply-add on the FMA units, one
// query row per warp at a time, on a grid of S/128 × N × B blocks (12 to
// 48 blocks for 132 SMs at batch 1), with synchronous element-wise tile
// loads; it took 0.35 ms at S = 512.
//
// Design of the bf16 kernel (the main path's dtype):
// * tensor cores: `mma.sync.m16n8k16` bf16 → f32, fragments loaded with
//   `ldmatrix` (`.trans` for V).  Each warp owns 16 query rows.  S = Q·Kᵀ
//   of a 64-key tile stays in register fragments, the online softmax runs
//   on them (row max and row sum by quad shuffles), and P is rounded to
//   bf16 in registers, the TPU kernel's rounding point
//   (flash_attention.py:64), where it is already the A operand of the P·V
//   `mma`: it never goes through shared memory;
// * a grid that fills the card: 64-row query tiles, so S = 512 gives
//   8 × N × B blocks; query rows past S are padded and never written, key
//   rows past S are zero-filled and masked;
// * a shorter serial chain: a block has 8 warps in two groups of 4 over
//   the same 64 query rows; group g takes the KV tiles g, g + 2, ... with
//   its own (m, l, acc), and the groups merge in group order at the end
//   (m = max, l and acc rescaled).  A causal block on the diagonal of
//   S = 512 walks 4 tiles in a row instead of 8, with twice the warps to
//   hide each other's latency;
// * copies that overlap compute: K and V tiles go through a shared-memory
//   ring of three steps (one tile per group each) filled by 16-byte
//   `cp.async`; two steps are in flight while one is computed, and the
//   first ones are issued before q is read, so the latency of the loads
//   is paid about once per block, not once per tile.  Rows are padded by
//   16 bytes, which puts the 8 rows of every `ldmatrix` in distinct
//   banks.  H is padded with zero columns up to 32, 64 or 128 (the
//   tiling's width);
// * tiles are skipped as on the TPU: the causal loop stops at the
//   diagonal, tiles wholly before the window are not read, and only tiles
//   that cross a mask edge evaluate the mask;
// * rounding follows the TPU kernel: q is scaled in its own dtype
//   (flash_attention.py:47, the scale rounded to bf16 as JAX rounds a
//   weak-typed scalar), scores sum in f32, l adds the unrounded p, and
//   m, l and acc are f32.
//
// float32 keeps the first version's loop on the FMA units (no TF32, which
// keeps ~3 digits where the f32 path is held to 2e-5).
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

// ----------------------------------------------------------------- bf16
constexpr int FB_ROW_WARPS = 4;                 // 16 query rows each
constexpr int FB_GROUPS = 2;                    // warp groups over KV tiles
constexpr int FB_WARPS = FB_ROW_WARPS * FB_GROUPS;
constexpr int FB_THREADS = FB_WARPS * 32;
constexpr int FB_GT = FB_ROW_WARPS * 32;        // threads of one group
constexpr int FB_BQ = 16 * FB_ROW_WARPS;        // query rows per block
constexpr int FB_BK = 64;                       // keys per KV tile
constexpr int FB_STAGES = 3;                    // steps in the ring
constexpr float FB_NEG_INF = -1e30f;

// HP: H padded to the tiling's width (32, 64 or 128); VEC: H % 8 == 0 and
// aligned rows, so rows load as 16-byte cp.async (else element by element)
template <int HP, bool VEC>
__global__ void __launch_bounds__(FB_THREADS)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int S, int N, int H,
                          int causal, int window, float scale) {
  constexpr int LD = HP + 8;           // smem row stride (elements)
  constexpr int KS = HP / 16;          // k-steps of Q·Kᵀ
  constexpr int NT = FB_BK / 8;        // key n-tiles of S
  constexpr int OT = HP / 8;           // column n-tiles of O
  constexpr int CPR = HP / 8;          // 16-byte chunks per padded row
  constexpr int TILE = FB_BK * LD;     // elements of one K (or V) tile
  extern __shared__ __align__(16) unsigned char fb_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fb_smem);
  // ring: [STAGES][GROUPS] K tiles, then as many V tiles
  __nv_bfloat16* ks = qs + FB_BQ * LD;
  __nv_bfloat16* vs = ks + FB_STAGES * FB_GROUPS * TILE;

  const int b = blockIdx.z, n = blockIdx.y;
  const int q_start = blockIdx.x * FB_BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % FB_ROW_WARPS;      // which 16 query rows
  const int grp = warp / FB_ROW_WARPS;     // which KV tiles
  const size_t rs = (size_t)N * H;                    // one s step
  const size_t base = (size_t)b * S * rs + (size_t)n * H;

  // the KV tiles this block reads: up to the diagonal, from the window on;
  // step i holds tiles kt_lo + GROUPS·i + g, tile g for warp group g
  const int nk = (S + FB_BK - 1) / FB_BK;
  int kt_hi = nk - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + FB_BQ - 1) / FB_BK);
  int kt_lo = 0;
  if (window > 0) {
    const int first = q_start - window + 1;   // row q_start's first key
    if (first > 0) kt_lo = first / FB_BK;
  }
  const int n_steps = (kt_hi - kt_lo + FB_GROUPS) / FB_GROUPS;

  auto load_tile = [&](int kt, __nv_bfloat16* kd, __nv_bfloat16* vd) {
    const int k0 = kt * FB_BK;
    if (VEC) {
      const int cpr = H / 8;
      for (int i = tid; i < FB_BK * CPR; i += FB_THREADS) {
        const int j = i / CPR, c = i % CPR;
        if (c >= cpr) continue;
        const bool in = k0 + j < S;
        const size_t off =
            base + (size_t)(in ? k0 + j : 0) * rs + (size_t)c * 8;
        cp_async16(kd + j * LD + c * 8, k + off, in);
        cp_async16(vd + j * LD + c * 8, v + off, in);
      }
    } else {
      for (int i = tid; i < FB_BK * H; i += FB_THREADS) {
        const int j = i / H, h = i % H;
        const bool in = k0 + j < S;
        const size_t off = base + (size_t)(k0 + j) * rs + h;
        kd[j * LD + h] = in ? k[off] : __float2bfloat16(0.0f);
        vd[j * LD + h] = in ? v[off] : __float2bfloat16(0.0f);
      }
    }
  };
  auto load_step = [&](int i) {      // every thread, one commit group
    const int slot = (i % FB_STAGES) * FB_GROUPS;
#pragma unroll
    for (int g = 0; g < FB_GROUPS; ++g) {
      const int kt = kt_lo + FB_GROUPS * i + g;
      if (kt <= kt_hi)
        load_tile(kt, ks + (slot + g) * TILE, vs + (slot + g) * TILE);
    }
  };

  // zero the padding columns of the ring once (the copies write cols < H)
  if (HP > H || !VEC) {
    for (int i = tid; i < 2 * FB_STAGES * FB_GROUPS * TILE; i += FB_THREADS)
      ks[i] = __float2bfloat16(0.0f);
    __syncthreads();
  }
  // the first KV steps start landing while q is read
#pragma unroll
  for (int st = 0; st < FB_STAGES - 1; ++st) {
    if (st < n_steps) load_step(st);
    cp_async_commit();
  }
  // q tile, scaled in bf16 (the scale itself rounded to bf16), zero-padded
  const float sc = __bfloat162float(__float2bfloat16(scale));
  for (int i = tid; i < FB_BQ * CPR; i += FB_THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool row_in = q_start + r < S;
    const __nv_bfloat16* src = q + base + (size_t)(q_start + r) * rs + c * 8;
    __align__(16) __nv_bfloat16 x[8];
    if (VEC) {
      if (row_in && c * 8 < H)
        *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(src);
      else
        *reinterpret_cast<uint4*>(x) = make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = row_in && c * 8 + e < H ? src[e] : __float2bfloat16(0.0f);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = __float2bfloat16(__bfloat162float(x[e]) * sc);
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) =
        *reinterpret_cast<const uint4*>(x);
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per k-step
  unsigned qf[KS][4];
  {
    const int mi = lane >> 3;
    const int r = rw * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qf[kk], qs + r * LD + kk * 16 + (mi >> 1) * 8);
  }

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // rows g and g + 8 of the warp's 16 (g = lane / 4); l is this thread's
  // share of the row sum (its 2 of every 8 columns), summed over the quad
  // at the end
  float m_r[2] = {FB_NEG_INF, FB_NEG_INF}, l_r[2] = {0.0f, 0.0f};
  const int g = lane >> 2, t4 = lane & 3;
  const int qrow0 = q_start + rw * 16 + g;

  for (int i = 0; i < n_steps; ++i) {
    if (i + FB_STAGES - 1 < n_steps) load_step(i + FB_STAGES - 1);
    cp_async_commit();
    cp_async_wait<FB_STAGES - 1>();    // step i has landed
    __syncthreads();
    const int kt = kt_lo + FB_GROUPS * i + grp;
    if (kt <= kt_hi) {
      const int slot = (i % FB_STAGES) * FB_GROUPS + grp;
      const __nv_bfloat16* kt_s = ks + slot * TILE;
      const __nv_bfloat16* vt_s = vs + slot * TILE;
      const int k0 = kt * FB_BK;

      // S = Q·Kᵀ (q pre-scaled), f32
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      {
        const int mi = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            unsigned bf[4];
            const int key = j * 8 + (mi >> 1) * 8 + (lane & 7);
            ldsm_x4(bf, kt_s + key * LD + kk * 16 + (mi & 1) * 8);
            mma_bf16(s[j], qf[kk], bf[0], bf[1]);
            mma_bf16(s[j + 1], qf[kk], bf[2], bf[3]);
          }
        }
      }

      // mask, only where the tile crosses an edge
      const bool edge = (causal && k0 + FB_BK - 1 > q_start) ||
                        (window > 0 && k0 <= q_start + FB_BQ - 1 - window) ||
                        (k0 + FB_BK > S);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + j * 8 + t4 * 2 + (e & 1);
            const int qp = qrow0 + (e >> 1) * 8;
            if (!(kp < S && (!causal || kp <= qp) &&
                  (window <= 0 || kp > qp - window)))
              s[j][e] = FB_NEG_INF;
          }
      }

      // online softmax on the fragments
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = FB_NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[r], mx);
        alpha[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            // a masked score is exactly the sentinel and gets p = 0, also
            // while the row has seen no key (m_new is then the sentinel)
            const float p =
                s[j][e] == FB_NEG_INF ? 0.0f : expf(s[j][e] - m_new);
            s[j][e] = p;
            sum += p;
          }
        l_r[r] = l_r[r] * alpha[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // acc += bf16(P) · V: the S fragments of key n-tiles 2kk, 2kk+1 are
      // the A fragment of k-step kk
      {
        const int mi = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < FB_BK / 16; ++kk) {
          unsigned pa[4];
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
          for (int j = 0; j < OT; j += 2) {
            unsigned bf[4];
            ldsm_x4_t(bf, vt_s + key * LD + j * 8 + (mi >> 1) * 8);
            mma_bf16(acc[j], pa, bf[0], bf[1]);
            mma_bf16(acc[j + 1], pa, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this step's tiles
  }

  // merge the groups' states in group order through the (now idle) ring:
  // groups 1.. park (m, l, acc) element-major, one column per thread;
  // group 0 folds them in (m = max, l and acc rescaled; a group that saw
  // no key has m = -1e30, l = 0, acc = 0 and changes nothing)
  constexpr int NE = 4 + 4 * OT;            // values per thread
  float* park = reinterpret_cast<float*>(ks);
  const int gt = tid % FB_GT;
  cp_async_wait<0>();
  if (grp > 0) {
    float* dst = park + (size_t)(grp - 1) * NE * FB_GT + gt;
    dst[0] = m_r[0];
    dst[FB_GT] = m_r[1];
    dst[2 * FB_GT] = l_r[0];
    dst[3 * FB_GT] = l_r[1];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(4 + 4 * j + e) * FB_GT] = acc[j][e];
  }
  __syncthreads();
  if (grp > 0) return;
  for (int gg = 1; gg < FB_GROUPS; ++gg) {
    const float* src = park + (size_t)(gg - 1) * NE * FB_GT + gt;
    float a[2], ag[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mg = src[r * FB_GT];
      const float m_new = fmaxf(m_r[r], mg);
      a[r] = expf(m_r[r] - m_new);
      ag[r] = expf(mg - m_new);
      l_r[r] = l_r[r] * a[r] + src[(2 + r) * FB_GT] * ag[r];
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * a[e >> 1] +
                    src[(4 + 4 * j + e) * FB_GT] * ag[e >> 1];
  }

  // o = acc / l, rows past S are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int qp = qrow0 + r * 8;
    if (qp >= S) continue;
    __nv_bfloat16* orow = o + base + (size_t)qp * rs;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int h = j * 8 + t4 * 2;
      const float x0 = acc[j][2 * r] * inv, x1 = acc[j][2 * r + 1] * inv;
      if (VEC && h + 1 < H) {
        *reinterpret_cast<__nv_bfloat162*>(orow + h) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (h < H) orow[h] = __float2bfloat16(x0);
        if (h + 1 < H) orow[h + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HP, bool VEC>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int N, int H, int causal, int window,
                       float scale, cudaStream_t stream) {
  auto kern = flash_fwd_bf16_kernel<HP, VEC>;
  const size_t smem =
      (size_t)(FB_BQ + 2 * FB_STAGES * FB_GROUPS * FB_BK) * (HP + 8) *
      sizeof(__nv_bfloat16);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + FB_BQ - 1) / FB_BQ, N, B);
  kern<<<grid, FB_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, N, H, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <int HP>
static int launch_bf16_h(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int N, int H, int causal,
                         int window, float scale, cudaStream_t stream) {
  // 16-byte copies need H % 8 == 0 and 16-byte aligned rows
  const bool vec = H % 8 == 0 &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)o) & 15) == 0;
  if (vec)
    return launch_bf16<HP, true>(q, k, v, o, B, S, N, H, causal, window,
                                 scale, stream);
  return launch_bf16<HP, false>(q, k, v, o, B, S, N, H, causal, window,
                                scale, stream);
}

// ------------------------------------------------------------------ f32
constexpr int FA_THREADS = 256;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_BK = 64;     // KV tile
constexpr int FA_MAXHC = 4;   // H <= 128: columns per lane
constexpr float FA_NEG_INF = -1e30f;

// one query row per warp at a time on the FMA units; m, l and the row's
// accumulator stay in shared memory.  TAIL: S is not a multiple of the
// query tile, and the last tile's rows past S are zero and never written
// (an instantiation of its own, so that the whole-tile one stays the
// first port's)
template <bool TAIL>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int N, int H, int bq, int causal, int window,
                         float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [bq][H] scaled q
  float* acc = qs + bq * H;            // [bq][H]
  float* ks = acc + bq * H;            // [FA_BK][H + 1]
  float* vs = ks + FA_BK * (H + 1);    // [FA_BK][H]
  float* ps = vs + FA_BK * H;          // [FA_WARPS][FA_BK]
  float* ms = ps + FA_WARPS * FA_BK;   // [bq]
  float* ls = ms + bq;                 // [bq]

  const int b = blockIdx.z, n = blockIdx.y;
  const int q_start = blockIdx.x * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row_stride = (size_t)N * H;            // one s step
  const size_t base = (size_t)b * S * row_stride + (size_t)n * H;

  const int rows = TAIL ? min(bq, S - q_start) : bq;
  for (int i = tid; i < bq * H; i += FA_THREADS) {
    const int r = i / H, h = i % H;
    qs[i] = !TAIL || r < rows
                ? q[base + (size_t)(q_start + r) * row_stride + h] * scale
                : 0.0f;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < bq; r += FA_THREADS) {
    ms[r] = FA_NEG_INF;
    ls[r] = 0.0f;
  }

  const int nk = (S + FA_BK - 1) / FA_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * FA_BK;
    const int k_last = min(k_start + FA_BK, S) - 1;
    if (causal && k_start > q_start + bq - 1) break;    // past the diagonal
    if (window > 0 && k_last <= q_start - window) continue;  // pre-window
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < FA_BK * H; i += FA_THREADS) {
      const int j = i / H, h = i % H;
      const bool in = k_start + j < S;
      const size_t off = base + (size_t)(k_start + j) * row_stride + h;
      ks[j * (H + 1) + h] = in ? k[off] : 0.0f;
      vs[j * H + h] = in ? v[off] : 0.0f;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += FA_WARPS) {
      const int qpos = q_start + r;
      if (causal && k_start > qpos) continue;
      if (window > 0 && k_last <= qpos - window) continue;
      float s[FA_BK / 32];
      bool ok[FA_BK / 32];
      float tmax = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < FA_BK / 32; ++c) {
        const int j = lane + 32 * c;
        const int kp = k_start + j;
        ok[c] = kp < S && (!causal || kp <= qpos) &&
                (window <= 0 || kp > qpos - window);
        float dot = 0.0f;
        const float* qr = qs + r * H;
        const float* kr = ks + j * (H + 1);
        for (int h = 0; h < H; ++h) dot = fmaf(qr[h], kr[h], dot);
        s[c] = ok[c] ? dot : FA_NEG_INF;
        tmax = fmaxf(tmax, s[c]);
      }
      tmax = warp_max(tmax);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < FA_BK / 32; ++c) {
        const float p = ok[c] ? expf(s[c] - m_new) : 0.0f;
        psum += p;
        ps[warp * FA_BK + lane + 32 * c] = p;
      }
      psum = warp_sum(psum);
      const float alpha = expf(m_old - m_new);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < FA_MAXHC; ++c) {
        const int h = lane + 32 * c;
        if (h < H) {
          float a = acc[r * H + h] * alpha;
          for (int j = 0; j < FA_BK; ++j)
            a = fmaf(ps[warp * FA_BK + j], vs[j * H + h], a);
          acc[r * H + h] = a;
        }
      }
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * H; i += FA_THREADS) {
    const int r = i / H, h = i % H;
    o[base + (size_t)(q_start + r) * row_stride + h] =
        acc[i] / fmaxf(ls[r], 1e-30f);
  }
}

template <bool TAIL>
static int launch_f32_t(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int N, int H, int bq, int causal,
                        int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<TAIL>;
  const size_t smem = (size_t)(2 * bq * H + FA_BK * (H + 1) + FA_BK * H +
                               FA_WARPS * FA_BK + 2 * bq) * sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + bq - 1) / bq, N, B);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, N, H,
      bq, causal, window, scale);
  return (int)cudaGetLastError();
}

static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int N, int H, int causal, int window,
                      float scale, cudaStream_t stream) {
  // 128-row query tiles (S rows when S < 128); the last tile of an S that
  // is not a multiple of 128 is cut short
  const int bq = S < 128 ? S : 128;
  if (S % bq != 0)
    return launch_f32_t<true>(q, k, v, o, B, S, N, H, bq, causal, window,
                              scale, stream);
  return launch_f32_t<false>(q, k, v, o, B, S, N, H, bq, causal, window,
                             scale, stream);
}

// q, k, v, o: contiguous (B, S, N, H), one dtype; any S >= 1; H <= 128.
// scale multiplies q (in q's dtype) before Q·Kᵀ.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int N, int H, int causal, int window,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0 || H > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16) {
    if (H <= 32)
      return launch_bf16_h<32>(q, k, v, o, B, S, N, H, causal, window, scale,
                               s);
    if (H <= 64)
      return launch_bf16_h<64>(q, k, v, o, B, S, N, H, causal, window, scale,
                               s);
    return launch_bf16_h<128>(q, k, v, o, B, S, N, H, causal, window, scale,
                              s);
  }
  if (dtype == DTYPE_F32)
    return launch_f32(q, k, v, o, B, S, N, H, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
