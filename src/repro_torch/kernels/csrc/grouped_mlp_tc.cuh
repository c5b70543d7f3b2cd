// Tensor-core tile products of the bf16 grouped-MLP kernels: B1's training
// and inference forms (grouped_mlp.cu) and B2, dgrad (grouped_mlp_bwd.cu).
//
// Each of the three kernels is two products, each launched over the list of
// 64-row token tiles that hold a valid row (the wrapper builds it on the
// device), times the N tiles of its output:
//
//   TC_FWD_H  h1 = x@wi [, h2 = x@wg]: writes h1 [h2] (zero on invalid rows
//             of the tile) and h = bf16(act(h1) [⊙ h2]) into a compact
//             scratch, one 64-row block per listed tile;
//   TC_INF_H  the same product without the residuals: h alone;
//   TC_FWD_Y  y = h@wo from that scratch: writes y at valid rows;
//   TC_DG_DH  dh = g@woᵀ: the epilogue reads h1 [h2] at valid rows and
//             writes dh1, h [, dh2] there, and dh1 - bf16(dh1) [and the same
//             of dh2] as bf16 into a compact scratch;
//   TC_DG_DX  dx = (hi + lo)@wiᵀ [+ (hi2 + lo2)@wgᵀ]: hi is the dh1 output,
//             lo the scratch; writes dx at valid rows.
//
// The inference form's list has a length the host knows without reading
// the device: every tile of the call, the listed ones first and -1 after
// them.  A block whose entry is -1 computes nothing; it only writes its
// share of the zero rows.
//
// The outputs that the contract writes whole (y; dx, dh1, h, dh2) also
// need their invalid rows zeroed: 97% of the rows at training shapes, and
// most of the bytes of the call (1.6 GB of y, 7.8 GB of dx, dh1 and h).
// zero_rows_share writes them: for y, the h1 product's blocks take an equal
// share of the rows each after their tile, so this bandwidth-bound work
// runs beside the other blocks' compute-bound products; dgrad's, five times
// as many bytes, go in a pass of their own first (gm_zero_invalid_rows),
// which measured faster there.  Every output element is written by one
// block, with sums in one fixed order: no atomics, the same bits from run
// to run.
//
// The product: a block is 4 warps over a 64 × BN output tile (BN = 128, or
// 64 with a gate); each warp owns all 64 rows × BN/4 columns as 4 × BN/32
// m16n8 f32 accumulators.  A (64 × 32) and B (32 × BN) tiles come through a
// ring of 3–4 stages filled by 16-byte cp.async, one stage ahead per stage
// of the ring, with one barrier per stage.  Fragments come from ldmatrix:
// B stored (Kd, N), as wi for x@wi and wo for h@wo, through .trans; B
// stored (N, Kd), as wo for g@woᵀ and wi for dh1@wiᵀ, without, so no
// weight is ever copied or transposed.  Rows are padded by 16 bytes, which
// puts the 8 rows of every ldmatrix in distinct banks.  A row's product
// depends on that row of A alone, so A is not masked on input: the
// epilogues write invalid rows as zero or not at all.  VEC = false takes
// element-wise loads and stores instead (rows not 16-byte aligned, D or F
// not a multiple of 8), on the same tiles.
#pragma once

#include <stdint.h>

#include <initializer_list>

#include "grouped_mlp.cuh"
#include "tensor_core.cuh"

constexpr int TC_BM = 64;    // token rows of a tile: the tile list's height
constexpr int TC_BK = 32;    // reduction depth of one ring stage
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;

enum { TC_FWD_H = 0, TC_FWD_Y = 1, TC_DG_DH = 2, TC_DG_DX = 3, TC_INF_H = 4 };

// h = act(x@wi) [⊙ x@wg]: the training form (residuals too) or inference
__host__ __device__ constexpr bool tc_h(int epi) {
  return epi == TC_FWD_H || epi == TC_INF_H;
}

template <int EPI, bool GATE>
struct TcShape {
  // A operands: one, or for dx the (hi, lo) pairs of dh1 [and dh2]
  static constexpr int NA = EPI == TC_DG_DX ? (GATE ? 4 : 2) : 1;
  // B operands: wi [and wg]
  static constexpr int NB =
      GATE && (tc_h(EPI) || EPI == TC_DG_DX) ? 2 : 1;
  static constexpr int NACC = GATE && tc_h(EPI) ? 2 : 1;
  static constexpr bool B_KN = tc_h(EPI) || EPI == TC_FWD_Y;
  static constexpr int BN = NB == 2 ? 64 : 128;
  static constexpr int WN = BN / TC_WARPS;  // columns of one warp
  static constexpr int NT = WN / 8;         // its n8 tiles
  static constexpr int STAGES = NA == 1 ? 4 : 3;
  static constexpr int LDA = TC_BK + 8;     // smem row strides (elements)
  static constexpr int LDB = B_KN ? BN + 8 : TC_BK + 8;
  static constexpr int A_TILE = TC_BM * LDA;
  static constexpr int B_TILE = B_KN ? TC_BK * LDB : BN * LDB;
  static constexpr int STAGE = NA * A_TILE + NB * B_TILE;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * 2;
};

// A operand j of the product EPI: compact rows (the scratch, 64 per listed
// tile) or the tile's rows of a (K, T, Kd) tensor
__host__ __device__ constexpr bool tc_a_compact(int epi, int j) {
  return epi == TC_FWD_Y || (epi == TC_DG_DX && (j & 1));
}

// outputs whose invalid rows are written as zeros
struct ZeroRows {
  __nv_bfloat16* o[4];
  int width[4];
  int n;
};

// This block's share of the zero rows: of the (K, T) rows [first, last),
// an equal range per block; a warp takes 32 rows at a time, finds the
// invalid ones with one ballot over their mask entries and zeroes those
// rows of every output in z.  The products write the valid rows, so every
// row is written once.
template <bool VEC>
__device__ __forceinline__ void zero_rows_share(const int* __restrict__ mask,
                                                long long first,
                                                long long last,
                                                const ZeroRows& z) {
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  const long long per = (last - first + gridDim.x - 1) / gridDim.x;
  const long long start = first + per * blockIdx.x;
  const long long end = start + per < last ? start + per : last;
  for (long long g0 = start + 32LL * (threadIdx.x / 32); g0 < end;
       g0 += 32LL * warps) {
    unsigned bits = __ballot_sync(0xffffffffu,
                                  g0 + lane < end && mask[g0 + lane] <= 0);
    while (bits) {
      const long long row = g0 + __ffs(bits) - 1;
      bits &= bits - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // unrolled: z stays in registers
        if (j >= z.n) break;
        const int w = z.width[j];
        __nv_bfloat16* o = z.o[j] + row * w;
        if (VEC) {
          for (int c = lane; c < w / 8; c += 32)
            reinterpret_cast<uint4*>(o)[c] = make_uint4(0, 0, 0, 0);
        } else {
          for (int c = lane; c < w; c += 32) o[c] = __float2bfloat16(0.0f);
        }
      }
    }
  }
}

// the zero rows alone: dgrad's, and the forward's when no row is valid
template <bool VEC>
__global__ void gm_zero_invalid_rows(const int* __restrict__ mask,
                                     long long rows, ZeroRows z) {
  zero_rows_share<VEC>(mask, 0, rows, z);
}

struct TcParams {
  const __nv_bfloat16* a[4];  // A operands, see tc_a_compact
  const __nv_bfloat16* b[2];  // B operands at slot 0
  long long sb[2];            // their slot strides (elements)
  const int* mask;            // (K, T) validity
  const int* tiles;           // listed tiles: k * nt + tile, increasing;
                              // -1 past the end of a padded list
  const __nv_bfloat16* e[2];  // TC_DG_DH: h1, h2
  // TC_FWD_H: h1, h2, h scratch; TC_INF_H: -, -, h scratch; TC_FWD_Y: y;
  // TC_DG_DH: dh1, h, dh2,
  // lo scratch, lo2 scratch; TC_DG_DX: dx
  __nv_bfloat16* o[5];
  int T, nt, Kd, N;  // slot rows, tiles per slot, reduction, output width
  ZeroRows z;        // the zero rows this launch writes: rows [z_first,
  long long z_first, z_last;  // z_last) of the (K, T) rows of mask
};

template <bool VEC>
__device__ __forceinline__ void store2(__nv_bfloat16* p, size_t idx, int c,
                                       int n, float v0, float v1) {
  if (VEC) {  // n % 8 == 0, c even: both columns in or both out
    if (c < n)
      *reinterpret_cast<__nv_bfloat162*>(p + idx) =
          __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < n) p[idx] = __float2bfloat16(v0);
    if (c + 1 < n) p[idx + 1] = __float2bfloat16(v1);
  }
}

template <bool VEC>
__device__ __forceinline__ void load2(const __nv_bfloat16* p, size_t idx,
                                      int c, int n, float& v0, float& v1) {
  if (VEC) {  // as in store2
    const __nv_bfloat162 v =
        c < n ? *reinterpret_cast<const __nv_bfloat162*>(p + idx)
              : __floats2bfloat162_rn(0.0f, 0.0f);
    v0 = __low2float(v);
    v1 = __high2float(v);
  } else {
    v0 = c < n ? __bfloat162float(p[idx]) : 0.0f;
    v1 = c + 1 < n ? __bfloat162float(p[idx + 1]) : 0.0f;
  }
}

template <int EPI, bool GATE, int ACT, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 3)
    gm_tc_kernel(const TcParams p) {
  using S = TcShape<EPI, GATE>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __shared__ int rowv[TC_BM];

  const int nbn = (p.N + S::BN - 1) / S::BN;
  const int i = blockIdx.x / nbn;  // N tiles fastest: they share A
  const int n0 = (blockIdx.x % nbn) * S::BN;
  const int tile = p.tiles[i];
  if (tile < 0) {  // past the device count of a padded list
    if (p.z.n > 0) zero_rows_share<VEC>(p.mask, p.z_first, p.z_last, p.z);
    return;
  }
  const int k = tile / p.nt;
  const int t0 = (tile % p.nt) * TC_BM;
  const int nrows = min(TC_BM, p.T - t0);
  const size_t row0 = (size_t)k * p.T + t0;  // the tile's first (K, T) row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < TC_BM) rowv[tid] = tid < nrows && p.mask[row0 + tid] > 0;

  const __nv_bfloat16* a[S::NA];
  int arows[S::NA];
#pragma unroll
  for (int j = 0; j < S::NA; ++j) {
    const bool compact = tc_a_compact(EPI, j);
    a[j] = p.a[j] + (compact ? (size_t)i * TC_BM : row0) * p.Kd;
    arows[j] = compact ? TC_BM : nrows;
  }
  const __nv_bfloat16* b[S::NB];
#pragma unroll
  for (int j = 0; j < S::NB; ++j) b[j] = p.b[j] + (size_t)k * p.sb[j];
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  auto load_stage = [&](int slot, int kt) {
    __nv_bfloat16* st = sm + slot * S::STAGE;
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int j = 0; j < S::NA; ++j) {
      __nv_bfloat16* dst = st + j * S::A_TILE;
      if (VEC) {
        for (int c = tid; c < TC_BM * (TC_BK / 8); c += TC_THREADS) {
          const int r = c / (TC_BK / 8), kk = k0 + (c % (TC_BK / 8)) * 8;
          const bool in = r < arows[j] && kk < p.Kd;
          cp_async16(dst + r * S::LDA + kk - k0,
                     in ? a[j] + (size_t)r * p.Kd + kk : a[j], in);
        }
      } else {
        for (int e = tid; e < TC_BM * TC_BK; e += TC_THREADS) {
          const int r = e / TC_BK, q = e % TC_BK;
          dst[r * S::LDA + q] = r < arows[j] && k0 + q < p.Kd
                                    ? a[j][(size_t)r * p.Kd + k0 + q]
                                    : zero;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < S::NB; ++j) {
      __nv_bfloat16* dst = st + S::NA * S::A_TILE + j * S::B_TILE;
      // B_KN: rows are the reduction (k0 + r), columns the output (n0 + q);
      // else rows the output and columns the reduction
      constexpr int ROWS = S::B_KN ? TC_BK : S::BN;
      constexpr int COLS = S::B_KN ? S::BN : TC_BK;
      const int r_lim = S::B_KN ? p.Kd - k0 : p.N - n0;
      const int c_lim = S::B_KN ? p.N - n0 : p.Kd - k0;
      const size_t ld = S::B_KN ? p.N : p.Kd;
      const __nv_bfloat16* src =
          b[j] + (S::B_KN ? (size_t)k0 * ld + n0 : (size_t)n0 * ld + k0);
      if (VEC) {
        for (int c = tid; c < ROWS * (COLS / 8); c += TC_THREADS) {
          const int r = c / (COLS / 8), q = (c % (COLS / 8)) * 8;
          const bool in = r < r_lim && q < c_lim;
          cp_async16(dst + r * S::LDB + q, in ? src + r * ld + q : b[j], in);
        }
      } else {
        for (int e = tid; e < ROWS * COLS; e += TC_THREADS) {
          const int r = e / COLS, q = e % COLS;
          dst[r * S::LDB + q] =
              r < r_lim && q < c_lim ? src[r * ld + q] : zero;
        }
      }
    }
  };

  float acc[S::NACC][4][S::NT][4];
#pragma unroll
  for (int u = 0; u < S::NACC; ++u)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][mt][nt][e] = 0.0f;

  const int nk = (p.Kd + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  const int mi = lane >> 3;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::STAGES - 2>();  // stage kt has landed
    __syncthreads();                 // ... for every thread; kt - 1 is done
    if (kt + S::STAGES - 1 < nk)
      load_stage((kt + S::STAGES - 1) % S::STAGES, kt + S::STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* st = sm + (kt % S::STAGES) * S::STAGE;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      unsigned bfr[S::NB][S::NT][2];
#pragma unroll
      for (int j = 0; j < S::NB; ++j) {
        const __nv_bfloat16* bs = st + S::NA * S::A_TILE + j * S::B_TILE;
#pragma unroll
        for (int jp = 0; jp < S::NT / 2; ++jp) {
          unsigned r4[4];
          const int col = warp * S::WN + jp * 16;
          if (S::B_KN)
            ldsm_x4_t(r4, bs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * S::LDB +
                              col + (mi >> 1) * 8);
          else
            ldsm_x4(r4, bs + (col + (mi >> 1) * 8 + (lane & 7)) * S::LDB +
                            kk * 16 + (mi & 1) * 8);
          bfr[j][2 * jp][0] = r4[0];
          bfr[j][2 * jp][1] = r4[1];
          bfr[j][2 * jp + 1][0] = r4[2];
          bfr[j][2 * jp + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int ja = 0; ja < S::NA; ++ja) {
        const __nv_bfloat16* as = st + ja * S::A_TILE;
        unsigned af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(af[mt], as + (mt * 16 + (mi & 1) * 8 + (lane & 7)) * S::LDA +
                              kk * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt) {
            if constexpr (tc_h(EPI)) {  // x@wi [and x@wg]
#pragma unroll
              for (int j = 0; j < S::NB; ++j)
                mma_bf16(acc[j][mt][nt], af[mt], bfr[j][nt][0],
                         bfr[j][nt][1]);
            } else {  // dx: (hi, lo) of dh1 with wi [, of dh2 with wg]
              const int j = EPI == TC_DG_DX ? ja >> 1 : 0;
              mma_bf16(acc[0][mt][nt], af[mt], bfr[j][nt][0], bfr[j][nt][1]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: this thread's rows mt·16 + g (+ 8), columns 2·t4 (+ 1) of
  // each n8 tile
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + hf * 8;
      const bool ok = rowv[r] != 0;
      const size_t orow = (row0 + r) * p.N;             // (K, T, N) row
      const size_t crow = ((size_t)i * TC_BM + r) * p.N;  // scratch row
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const int c = n0 + warp * S::WN + nt * 8 + 2 * t4;
        float v[2] = {acc[0][mt][nt][2 * hf], acc[0][mt][nt][2 * hf + 1]};
        if (tc_h(EPI)) {
          float w[2] = {0.0f, 0.0f}, h[2];
          if (GATE) {
            w[0] = acc[S::NACC - 1][mt][nt][2 * hf];
            w[1] = acc[S::NACC - 1][mt][nt][2 * hf + 1];
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            h[u] = act_fn<ACT>(v[u]);
            if (GATE) h[u] *= w[u];
            if (!ok) v[u] = w[u] = h[u] = 0.0f;
          }
          if (EPI == TC_FWD_H && r < nrows) {  // the residuals
            store2<VEC>(p.o[0], orow + c, c, p.N, v[0], v[1]);
            if (GATE) store2<VEC>(p.o[1], orow + c, c, p.N, w[0], w[1]);
          }
          store2<VEC>(p.o[2], crow + c, c, p.N, h[0], h[1]);
        } else if (EPI == TC_DG_DH) {
          float d1[2] = {0.0f, 0.0f}, d2[2] = {0.0f, 0.0f};
          if (ok) {
            float x1[2], x2[2] = {0.0f, 0.0f}, h[2];
            load2<VEC>(p.e[0], orow + c, c, p.N, x1[0], x1[1]);
            if (GATE) load2<VEC>(p.e[1], orow + c, c, p.N, x2[0], x2[1]);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float av;
              const float da = act_and_grad<ACT>(x1[u], &av);
              if (GATE) {
                d1[u] = da * (v[u] * x2[u]);
                d2[u] = v[u] * av;
                h[u] = av * x2[u];
              } else {
                d1[u] = da * v[u];
                h[u] = av;
              }
            }
            store2<VEC>(p.o[0], orow + c, c, p.N, d1[0], d1[1]);
            store2<VEC>(p.o[1], orow + c, c, p.N, h[0], h[1]);
            if (GATE) store2<VEC>(p.o[2], orow + c, c, p.N, d2[0], d2[1]);
          }
          // lo = d - bf16(d): dx takes hi + lo, the f32 value to ~2^-16
          store2<VEC>(p.o[3], crow + c, c, p.N,
                      d1[0] - round_to<__nv_bfloat16>(d1[0]),
                      d1[1] - round_to<__nv_bfloat16>(d1[1]));
          if (GATE)
            store2<VEC>(p.o[4], crow + c, c, p.N,
                        d2[0] - round_to<__nv_bfloat16>(d2[0]),
                        d2[1] - round_to<__nv_bfloat16>(d2[1]));
        } else if (ok) {  // y or dx, valid rows
          store2<VEC>(p.o[0], orow + c, c, p.N, v[0], v[1]);
        }
      }
    }
  // then a share of the bandwidth-bound zero rows, which runs beside the
  // other blocks' products on the same SM
  if (p.z.n > 0) zero_rows_share<VEC>(p.mask, p.z_first, p.z_last, p.z);
}

static int launch_zero_rows(const int* mask, long long rows,
                            const ZeroRows& z, bool vec,
                            cudaStream_t stream) {
  const long long want = (rows + 127) / 128, cap = 132LL * 16;
  const int blocks = (int)(want < cap ? want : cap);
  if (vec)
    gm_zero_invalid_rows<true><<<blocks, TC_THREADS, 0, stream>>>(mask, rows,
                                                                  z);
  else
    gm_zero_invalid_rows<false><<<blocks, TC_THREADS, 0, stream>>>(mask, rows,
                                                                   z);
  return (int)cudaGetLastError();
}

template <int EPI, bool GATE, int ACT, bool VEC>
static int launch_tc(const TcParams& p, int n_tiles, cudaStream_t stream) {
  using S = TcShape<EPI, GATE>;
  auto kern = gm_tc_kernel<EPI, GATE, ACT, VEC>;
  cudaError_t e = allow_smem(kern, S::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)n_tiles * ((p.N + S::BN - 1) / S::BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, TC_THREADS, S::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// 16-byte copies need every row to start 16-byte aligned: aligned bases
// and row and slot strides that are multiples of 8 elements
static bool tc_vec(std::initializer_list<const void*> ptrs,
                   std::initializer_list<long long> strides) {
  for (const void* q : ptrs)
    if (((uintptr_t)q) & 15) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}
