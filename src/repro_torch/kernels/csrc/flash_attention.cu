// Flash attention, forward (prefill).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention): blockwise online-softmax attention over
// q/k/v in the (B, S, N, H) layout, equal heads (GQA is expanded by the
// caller), causal and/or sliding-window mask, f32 m/l/acc.
//
// What bounds it on an H100: at the prefill shapes (S <= a few thousand,
// H = 64) the work is S²·H multiply-adds per head against S·H·3 elements
// read, so it is bound by operations; this first version runs them on the
// FMA units (no tensor cores), which puts it well below the card's bf16
// peak.  Its design keeps the S×S score matrix out of device memory:
// scores and probabilities live only in registers and shared memory.
//
// Design:
// * one block per (b, n, query tile of up to 128 rows), 8 warps; the TPU
//   grid's sequential KV axis becomes a loop over 64-row KV tiles staged
//   in shared memory (K padded by one column against bank conflicts);
// * each warp owns query rows r, r+8, ...; per KV tile a lane scores two
//   keys, the warp reduces max and sum with shuffles, and the row's
//   running max, sum and (row × H) accumulator stay in shared memory, f32;
// * tiles wholly outside the causal triangle or the window are skipped
//   (the causal loop stops at the diagonal), and so are the row-tile pairs
//   with no visible key;
// * rounding follows the TPU kernel: q is scaled in the input dtype
//   (flash_attention.py:47) and p is rounded to v's dtype before the
//   product with v (:64), while the running sum l adds the unrounded p.
#include "common.cuh"

constexpr int FA_THREADS = 256;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_BK = 64;     // KV tile
constexpr int FA_MAXHC = 4;   // H <= 128: columns per lane
constexpr float FA_NEG_INF = -1e30f;

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               int S, int N, int H, int bq, int causal,
                               int window, float scale) {
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

  for (int i = tid; i < bq * H; i += FA_THREADS) {
    const int r = i / H, h = i % H;
    qs[i] = round_to<T>(to_f(q[base + (size_t)(q_start + r) * row_stride + h])
                        * scale);
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
      ks[j * (H + 1) + h] = in ? to_f(k[off]) : 0.0f;
      vs[j * H + h] = in ? to_f(v[off]) : 0.0f;
    }
    __syncthreads();

    for (int r = warp; r < bq; r += FA_WARPS) {
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
        ps[warp * FA_BK + lane + 32 * c] = round_to<T>(p);
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
  for (int i = tid; i < bq * H; i += FA_THREADS) {
    const int r = i / H, h = i % H;
    o[base + (size_t)(q_start + r) * row_stride + h] =
        from_f<T>(acc[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int N, int H, int causal, int window,
                  float scale, cudaStream_t stream) {
  const int bq = S < 128 ? S : 128;
  if (S % bq != 0) return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_fwd_kernel<T>;
  const size_t smem = (size_t)(2 * bq * H + FA_BK * (H + 1) + FA_BK * H +
                               FA_WARPS * FA_BK + 2 * bq) * sizeof(float);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S / bq, N, B);
  kern<<<grid, FA_THREADS, smem, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)o, S, N, H, bq,
                                           causal, window, scale);
  return (int)cudaGetLastError();
}

// q, k, v, o: contiguous (B, S, N, H), one dtype; S < 128 or S % 128 == 0;
// H <= 128.  scale multiplies q (in q's dtype) before Q·Kᵀ.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int N, int H, int causal, int window,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0 || H > 32 * FA_MAXHC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, N, H, causal, window,
                                 scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, o, B, S, N, H, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
