// The FiLM-SIREN of the ray tile on the tensor cores, shared by the forward
// (ray_tile.cu) and the backward (ray_tile_bwd.cu).
//
// A block of kThreads = 512 threads (16 warps) works on chunks of kRows = 64
// points.  Every product of a chunk is one warp-level mma.sync tiling: warp
// w owns the 16-row m-tile w % 4 and the 8-column n-tiles w / 4 + 4 j
// (j < 4, so layer widths up to 128).  f32 products run as 3xTF32 with a
// fresh partial per k-step, added to the accumulator in f32 (the INR tile
// found that a dot kept in the MMA's C register drifts); bf16 products are
// m16n8k16 on the bf16-rounded values, f32 accumulation.  The epilogues
// (bias, FiLM gain and shift, sine, rounding to the mm type) run on the
// accumulator fragments in registers; only a layer's output goes to shared
// memory, because the next product reads it in the A-fragment layout, which
// is not the accumulator's.
//
// Weights live in shared memory as [K][N + pad] rows, the pad 16 bytes, so
// that the B-fragment loads hit distinct banks both as W and as W^T (the
// backward's d-input products).  w_0 gets 16 rows, the 13 past its 3 input
// channels zero, so that the first layer is one k16 step on a zero-padded
// input.
#pragma once

#include "common.cuh"
#include "fast_sin.cuh"

namespace cips_mlp {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;                    // points per chunk
constexpr int kMT = kRows / 16;              // m-tiles
constexpr int kNG = kWarps / kMT;            // n-tile groups
constexpr int kMaxNT = 128 / 8 / kNG;        // n-tiles per warp at width 128
constexpr int kK0 = 16;                      // the first layer's padded depth
constexpr int kXLd = kK0 + 4;                // row stride of the input buffer (floats)

// Row stride of a shared weight matrix with N columns.
template <typename T>
__host__ __device__ constexpr int wld(int N) {
  return N + 16 / (int)sizeof(T);
}

// Element offsets of the shared weight matrices; `total` elements in all.
struct WLayout {
  int w0, wl, wc, wr, ws, total;
  template <typename T>
  __host__ __device__ static WLayout make(int L, int H, int C, int R) {
    WLayout w;
    w.w0 = 0;
    w.wl = kK0 * wld<T>(H);                      // w_l at wl + (l - 1) H wld(H)
    w.wc = w.wl + (L - 1) * H * wld<T>(H);
    w.wr = w.wc + H * wld<T>(C);
    w.ws = w.wr + C * wld<T>(R);
    w.total = w.ws + H;
    return w;
  }
};

// Copy the flat weights (w_0 (3,H), w_1.. (H,H), wc (H,C), wr (C,R), ws (H))
// into the padded shared layout, zeros in the pads.  Block-cooperative.
template <typename T>
__device__ void load_weights(T* dst, const T* src, const WLayout& lay, int L, int H, int C,
                             int R) {
  auto mat = [&](int d, int s, int K, int Kpad, int N) {
    const int ld = wld<T>(N);
    for (int i = threadIdx.x; i < Kpad * ld; i += blockDim.x) {
      const int k = i / ld, c = i % ld;
      dst[d + i] = k < K && c < N ? src[s + k * N + c] : cips::from_f<T>(0.f);
    }
  };
  int s = 0;
  mat(lay.w0, s, 3, kK0, H);
  s += 3 * H;
  for (int l = 1; l < L; ++l, s += H * H) mat(lay.wl + (l - 1) * H * wld<T>(H), s, H, H, H);
  mat(lay.wc, s, H, H, C);
  s += H * C;
  mat(lay.wr, s, C, C, R);
  s += C * R;
  for (int i = threadIdx.x; i < H; i += blockDim.x) dst[lay.ws + i] = src[s + i];
}

// Fragment coordinates of this thread (PTX ISA mma.m16n8k8 / m16n8k16):
// element e of n-tile slot j sits at row frag_row(e), column frag_col(j, e).
struct Frag {
  int mt, ng, g, t;
  __device__ Frag() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    mt = warp % kMT;
    ng = warp / kMT;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ int nt(int j) const { return ng + kNG * j; }
  __device__ int row(int e) const { return 16 * mt + g + 8 * (e >> 1); }
  __device__ int col(int j, int e) const { return 8 * nt(j) + 2 * t + (e & 1); }
};

template <typename T, bool kTrans>
__device__ __forceinline__ T wat(const T* W, int ld, int k, int n) {
  return kTrans ? W[n * ld + k] : W[k * ld + n];
}

__device__ __forceinline__ void zero(float acc[kMaxNT][4]) {
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc = A[rows of the warp's m-tile][0, K) . B[0, K)[columns of its n-tiles]
// for n-tiles below NT.  A: f32 rows of stride lda (values already rounded to
// the mm type).  B(k, n) = W[k ld + n], or W[n ld + k] with kTrans (the
// product with W^T).  K: a multiple of 16.
template <bool kTrans>
__device__ void warp_mm(float acc[kMaxNT][4], const float* A, int lda, int K, const float* W,
                        int ldw, int NT) {
  const Frag f;
  const float* r0 = A + (16 * f.mt + f.g) * lda;
  const float* r1 = r0 + 8 * lda;
  zero(acc);
  for (int k = 0; k < K; k += 8) {
    uint32_t ahi[4], alo[4];
    cips::split_tf32(r0[k + f.t], ahi[0], alo[0]);
    cips::split_tf32(r1[k + f.t], ahi[1], alo[1]);
    cips::split_tf32(r0[k + f.t + 4], ahi[2], alo[2]);
    cips::split_tf32(r1[k + f.t + 4], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (f.nt(j) >= NT) continue;
      const int n = 8 * f.nt(j) + f.g;
      uint32_t bhi[2], blo[2];
      cips::split_tf32(wat<float, kTrans>(W, ldw, k + f.t, n), bhi[0], blo[0]);
      cips::split_tf32(wat<float, kTrans>(W, ldw, k + f.t + 4, n), bhi[1], blo[1]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      cips::mma_3xtf32(part, ahi, alo, bhi, blo);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

template <bool kTrans>
__device__ void warp_mm(float acc[kMaxNT][4], const float* A, int lda, int K,
                        const __nv_bfloat16* W, int ldw, int NT) {
  const Frag f;
  const float* r0 = A + (16 * f.mt + f.g) * lda;
  const float* r1 = r0 + 8 * lda;
  zero(acc);
  for (int k = 0; k < K; k += 16) {
    const int kk = k + 2 * f.t;
    const uint32_t a[4] = {cips::pack_bf16(r0[kk], r0[kk + 1]), cips::pack_bf16(r1[kk], r1[kk + 1]),
                           cips::pack_bf16(r0[kk + 8], r0[kk + 9]),
                           cips::pack_bf16(r1[kk + 8], r1[kk + 9])};
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (f.nt(j) >= NT) continue;
      const int n = 8 * f.nt(j) + f.g;
      uint32_t b[2];
      if (kTrans) {   // W[n][kk], W[n][kk + 1] are neighbours
        b[0] = *reinterpret_cast<const uint32_t*>(W + n * ldw + kk);
        b[1] = *reinterpret_cast<const uint32_t*>(W + n * ldw + kk + 8);
      } else {
        b[0] = cips::pack_bits(W[kk * ldw + n], W[(kk + 1) * ldw + n]);
        b[1] = cips::pack_bits(W[(kk + 8) * ldw + n], W[(kk + 9) * ldw + n]);
      }
      cips::mma_bf16(acc[j], a, b);
    }
  }
}

// The sigma head of one point, by one warp: sum_k h[k] ws[k] + bs, lane k
// taking k = lane + 32 i, then a butterfly sum.  The forward and the
// backward both call this (on the same rounded h), so the coarse densities,
// and with them the fine depths, agree bit for bit.
template <typename U, typename T>
__device__ __forceinline__ float sigma_head(const U* h, const T* ws, int H, float bs) {
  float v = 0.f;
  for (int k = threadIdx.x & 31; k < H; k += 32) v = fmaf(cips::to_f(h[k]), cips::to_f(ws[k]), v);
  return cips::warp_sum(v) + bs;
}

__device__ __forceinline__ float film_sin(float arg, int fast_sin) {
  return fast_sin ? cips_fast_sinf(arg) : sinf(arg);
}

// Per-chunk inputs of `chunk_mlp`.
template <typename T>
struct Mlp {
  const T* w;             // shared weights (WLayout)
  WLayout lay;
  const float* bias;      // b_0.. (H), bc (C), br (R), bs (1)
  const float* film;      // g_0, f_0, g_1, f_1, .. (H each), gc, fc (C each)
  int L, H, C, R, fast_sin;
};

// The FiLM-SIREN of one chunk.  xb: kRows x kXLd, the rounded, warped
// points in columns 0..2 and zeros to kK0; hb: kRows rows of stride ldh.
// Writes each row's raw sigma to sig[row] and hands each rgb element to
// store_rgb(row, col, value).  With kRes, rows below nres also store their
// residuals at rows res0 + row: ra/rh (row stride L H) and rac/rhc (C).
// The caller synchronises before (xb written) and after (hb, sig read).
template <typename T, bool kRes, typename StoreRgb>
__device__ void chunk_mlp(const Mlp<T>& m, const float* xb, float* hb, int ldh, float* sig,
                          StoreRgb store_rgb, int nres = 0, long long res0 = 0,
                          float* ra = nullptr, T* rh = nullptr, float* rac = nullptr,
                          T* rhc = nullptr) {
  const Frag f;
  const int H = m.H, C = m.C, R = m.R, L = m.L, LH = L * H;
  float acc[kMaxNT][4];
  // a = in W + b; h = round(sin(g a + f)) to hb (and the residuals)
  auto film_epilogue = [&](const float* b, const float* g, const float* s, int N, float* res_a,
                           T* res_h, int res_ld) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (8 * f.nt(j) >= N) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = f.row(e), col = f.col(j, e);
        const float a = acc[j][e] + b[col];
        const float h = cips::round_mm<T>(film_sin(g[col] * a + s[col], m.fast_sin));
        hb[row * ldh + col] = h;
        if (kRes && row < nres) {
          const long long o = (res0 + row) * res_ld + col;
          res_a[o] = a;
          res_h[o] = cips::from_f<T>(h);
        }
      }
    }
  };
  for (int l = 0; l < L; ++l) {
    const T* W = m.w + (l == 0 ? m.lay.w0 : m.lay.wl + (l - 1) * H * wld<T>(H));
    if (l == 0)
      warp_mm<false>(acc, xb, kXLd, kK0, W, wld<T>(H), H / 8);
    else
      warp_mm<false>(acc, hb, ldh, H, W, wld<T>(H), H / 8);
    __syncthreads();   // every warp is done reading hb
    film_epilogue(m.bias + l * H, m.film + 2 * l * H, m.film + 2 * l * H + H, H,
                  kRes ? ra + l * H : nullptr, kRes ? rh + l * H : nullptr, LH);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  for (int row = warp; row < kRows; row += kWarps) {
    const float v = sigma_head(hb + row * ldh, m.w + m.lay.ws, H, m.bias[LH + C + R]);
    if ((threadIdx.x & 31) == 0) sig[row] = v;
  }
  warp_mm<false>(acc, hb, ldh, H, m.w + m.lay.wc, wld<T>(C), C / 8);   // colour FiLM
  __syncthreads();
  film_epilogue(m.bias + LH, m.film + 2 * LH, m.film + 2 * LH + C, C, rac, rhc, C);
  __syncthreads();
  warp_mm<false>(acc, hb, ldh, C, m.w + m.lay.wr, wld<T>(R), R / 8);   // rgb head
  const float* br = m.bias + LH + C;
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    if (8 * f.nt(j) >= R) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) store_rgb(f.row(e), f.col(j, e), acc[j][e] + br[f.col(j, e)]);
  }
}

}  // namespace cips_mlp
