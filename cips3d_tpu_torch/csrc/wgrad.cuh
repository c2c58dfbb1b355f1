// The weight grads of the ray-tile backward, dW = X^T dA over the points of
// one split, shared by ray_tile_bwd.cu's weight-grad kernel (the resident
// path) and ray_tile_streamed.cu's (the streamed path, which takes the
// matrices past 128 in 128 x 128 tiles).  Tensor-core products over 32-point
// stages through a cp.async double buffer; each k-step's products in a fresh
// partial added in f32 (a deep sum in the MMA's C register would drift).
#pragma once

#include "common.cuh"

namespace cips_wgrad {

constexpr int kWThreads = 256;   // 8 warps
constexpr int kWRows = 32;       // points per pipeline stage
constexpr int kWMaxNT = 16;      // n-tiles per warp (one m-tile, width 128)
constexpr int kWMaxWidth = 128;  // kin and nout of one product

// dW[k][c] = sum_p X[p][xcol + k] dq[p][dcol + c] for k < kin, c < nout,
// added at out + k ldo + c of the partial row.  x: 0 the point scratch,
// 1 rh, 2 rhc.
struct GemmJob {
  int x, xld, xcol, kin, dcol, nout, out;
};

__host__ __device__ inline int wg_ldx(int kin) { return 16 * ((kin + 15) / 16) + 8; }
__host__ __device__ inline int wg_ldd(int nout) { return 16 * ((nout + 15) / 16) + 8; }
template <typename T>
__host__ __device__ inline size_t wg_smem(int kin, int nout) {
  return 2 * sizeof(T) * kWRows * (size_t)(wg_ldx(kin) + wg_ldd(nout));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ uint32_t frag_tf32(float v, uint32_t& lo) {
  uint32_t hi;
  cips::split_tf32(v, hi, lo);
  return hi;
}

// one k-step of 8 points (tf32) for the tile (mt, nt): part = X^T dq
__device__ __forceinline__ void wg_step(float part[4], const float* xs, int ldx, const float* ds,
                                        int ldd, int m, int nn, int t) {
  uint32_t ahi[4], alo[4], bhi[2], blo[2];
  ahi[0] = frag_tf32(xs[t * ldx + m], alo[0]);
  ahi[1] = frag_tf32(xs[t * ldx + m + 8], alo[1]);
  ahi[2] = frag_tf32(xs[(t + 4) * ldx + m], alo[2]);
  ahi[3] = frag_tf32(xs[(t + 4) * ldx + m + 8], alo[3]);
  bhi[0] = frag_tf32(ds[t * ldd + nn], blo[0]);
  bhi[1] = frag_tf32(ds[(t + 4) * ldd + nn], blo[1]);
  cips::mma_3xtf32(part, ahi, alo, bhi, blo);
}

// one k-step of 16 points (bf16)
__device__ __forceinline__ void wg_step(float part[4], const __nv_bfloat16* xs, int ldx,
                                        const __nv_bfloat16* ds, int ldd, int m, int nn, int t) {
  const int p = 2 * t;
  const uint32_t av[4] = {cips::pack_bits(xs[p * ldx + m], xs[(p + 1) * ldx + m]),
                          cips::pack_bits(xs[p * ldx + m + 8], xs[(p + 1) * ldx + m + 8]),
                          cips::pack_bits(xs[(p + 8) * ldx + m], xs[(p + 9) * ldx + m]),
                          cips::pack_bits(xs[(p + 8) * ldx + m + 8], xs[(p + 9) * ldx + m + 8])};
  const uint32_t bv[2] = {cips::pack_bits(ds[p * ldd + nn], ds[(p + 1) * ldd + nn]),
                          cips::pack_bits(ds[(p + 8) * ldd + nn], ds[(p + 9) * ldd + nn])};
  cips::mma_bf16(part, av, bv);
}

// The product of one job (kin, nout <= 128) over the points [r0, r1) of a
// block of kWThreads threads: X rows of stride jb.xld, dq rows of stride dld;
// dW[k][c] lands at out[k ldo + c].  smem: wg_smem<T>(jb.kin, jb.nout) bytes.
template <typename T>
__device__ __forceinline__ void wgrad_body(const T* X, const T* Dq, int dld, const GemmJob& jb,
                                           long long r0, long long r1, float* out, int ldo,
                                           unsigned char* smem) {
  const int ldx = wg_ldx(jb.kin), ldd = wg_ldd(jb.nout);
  T* xbuf[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + kWRows * (ldx + ldd)};
  T* dbuf[2] = {xbuf[0] + kWRows * ldx, xbuf[1] + kWRows * ldx};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int V = 16 / sizeof(T);                  // elements per 16-byte copy
  const int xv = (jb.kin + V - 1) / V, dv = (jb.nout + V - 1) / V;

  for (int i = tid; i < 2 * kWRows * (ldx + ldd); i += kWThreads) xbuf[0][i] = cips::from_f<T>(0.f);
  __syncthreads();   // the columns past kin / nout stay zero
  auto issue = [&](int buf, long long p0) {
    for (int i = tid; i < kWRows * (xv + dv); i += kWThreads) {
      const bool isx = i < kWRows * xv;
      const int k = isx ? i : i - kWRows * xv, w = isx ? xv : dv;
      const int row = k / w, v = k % w;
      const long long p = p0 + row;
      const bool ok = p < r1;
      const T* src = isx ? X + (ok ? p * jb.xld + jb.xcol + v * V : 0)
                         : Dq + (ok ? p * dld + jb.dcol + v * V : 0);
      T* dst = isx ? xbuf[buf] + row * ldx + v * V : dbuf[buf] + row * ldd + v * V;
      cp_async16(dst, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int MT = (jb.kin + 15) / 16, NT = (jb.nout + 7) / 8;
  const int ng = kWThreads / 32 / MT;   // n-tile groups (MT <= 8: widths up to 128)
  const bool active = warp < MT * ng;
  const int mt = warp % MT, nt0 = warp / MT;
  float acc[kWMaxNT][4];
#pragma unroll
  for (int j = 0; j < kWMaxNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  constexpr int kStep = sizeof(T) == 4 ? 8 : 16;   // points per MMA k-step
  issue(0, r0);
  int buf = 0;
  for (long long p0 = r0; p0 < r1; p0 += kWRows) {
    if (p0 + kWRows < r1) {
      issue(buf ^ 1, p0 + kWRows);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < kWRows; kk += kStep) {
        const T* xs = xbuf[buf] + kk * ldx;
        const T* ds = dbuf[buf] + kk * ldd;
#pragma unroll
        for (int j = 0; j < kWMaxNT; ++j) {
          const int nt = nt0 + ng * j;
          if (nt >= NT) continue;
          float part[4] = {0.f, 0.f, 0.f, 0.f};   // a fresh partial per k-step, added in f32
          wg_step(part, xs, ldx, ds, ldd, 16 * mt + g, 8 * nt + g, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
        }
      }
    }
    __syncthreads();   // every warp is done with `buf` before it is refilled
    buf ^= 1;
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < kWMaxNT; ++j) {
    const int nt = nt0 + ng * j;
    if (nt >= NT) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * mt + g + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1);
      if (k < jb.kin && c < jb.nout) out[k * ldo + c] = acc[j][e];
    }
  }
}

}  // namespace cips_wgrad
