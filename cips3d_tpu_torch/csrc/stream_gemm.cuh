// The product of the streamed paths (ray_tile_streamed.cu, inr_tile_streamed.cu):
// one layer of a point MLP over rows held in device memory,
//
//     out[row, col] = epilogue(sum_k A[row, k] B[k, col]),
//
// for any depth K and width N, with shared memory that does not grow with
// either.  A block of 512 threads (16 warps) takes 64 rows and a slab of 128
// output columns (grid: row chunks, column slabs, batch rows z); A and B come
// in 32-deep k-panels through a two-stage cp.async ring.  The warp tiling,
// the per-k-step arithmetic and the epilogues are those of the resident
// kernels (ray_mlp.cuh, inr_tile.cu): f32 products as 3xTF32 with a fresh
// partial per 8-deep k-step added in f32, bf16 products as m16n8k16 with f32
// accumulation, in the same k order, so every output is the same sum (but
// the INR layers' bf16 products, which take a fresh partial per k-step too).
//   B = W (K x N, kTrans false) or W^T (W is N x K, kTrans true: the
//   backward's d-input products); rows of W past `wvalid` read as zeros.
// Every row-indexed operand is a Mat: row r of batch row z at
// p + (z * zstride + row0 + r) * ld + col.
#pragma once

#include "common.cuh"
#include "fast_sin.cuh"

namespace cips_stream {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;              // rows per block: four 16-row MMA tiles
constexpr int kMT = kRows / 16;
constexpr int kNG = kWarps / kMT;      // n-tile groups
constexpr int kSlab = 128;             // output columns per block
constexpr int kNT = kSlab / 8 / kNG;   // n-tiles per warp
constexpr int kKP = 32;                // k rows per panel

// Epilogues.
enum Mode {
  kFilm = 0,     // h = round(sin(g (acc + b) + f)) to out (mm type), acc + b to out_a (f32)
  kLinear = 1,   // out = acc + b (f32)
  kFilmBwd = 2,  // d arg = (acc + dsig ws) sin'(g a + f): round(d arg g) to out, FiLM sums
  kDx = 3,       // out[row, col < 3] = acc * warp_scale (f32, d pts)
  kInr = 4,      // A scaled by s[k]; out = lrelu_0.2(acc demod) (+ resid), f32
};

struct Mat {
  void* p;
  long long zstride, row0;
  int ld, col;
  template <typename U>
  __device__ __forceinline__ U* at(int z, int r) const {
    return static_cast<U*>(p) + ((long long)z * zstride + row0 + r) * ld + col;
  }
};

struct Vec {   // one row of floats per batch row z: p + z * zstride
  const float* p;
  int zstride;
  __device__ __forceinline__ const float* at(int z) const { return p + (long long)z * zstride; }
};

struct GemmArgs {
  Mat a;             // A (K columns, the first `akvalid` read, the rest zero)
  int akvalid;
  const void* w;     // W, row stride ldw, rows past wvalid zero
  int ldw, wvalid;
  int nrows, K, N;   // rows per batch row, depth (a multiple of 16), width (of 16)
  Mat out, out_a;    // out_a.p null: no pre-activations
  Mat ares;          // kFilmBwd: the layer's pre-activations (f32)
  Mat dsig;          // kFilmBwd: d sigma (mm type, column 0), or p null
  const void* ws;    // kFilmBwd: the sigma head (N), with dsig
  Mat part;          // kFilmBwd: f32 sums, row = chunk, [d g | d f | d b] of N each
  Vec bias, gain, shift, scale, demod;
  Mat resid;         // kInr: added after the activation (p null: none)
  float warp_scale;
  int fast_sin;
};

__host__ __device__ constexpr size_t al16(size_t bytes) { return (bytes + 15) & ~size_t(15); }
template <typename U> __host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(U); }
template <typename TA> __host__ __device__ constexpr int a_ld() { return kKP + vec_elems<TA>(); }
template <typename T, bool kTrans> __host__ __device__ constexpr int b_ld() {
  return kTrans ? kKP + vec_elems<T>() : kSlab + 8;
}
template <typename T, bool kTrans> __host__ __device__ constexpr int b_rows() {
  return kTrans ? kSlab : kKP;
}

// Shared bytes: two A panels, two B panels, the FiLM sums of kFilmBwd.
template <typename T, typename TA, bool kTrans, int kMode>
__host__ __device__ constexpr size_t gemm_smem() {
  return al16(sizeof(TA) * 2 * kRows * a_ld<TA>()) +
         al16(sizeof(T) * 2 * b_rows<T, kTrans>() * b_ld<T, kTrans>()) +
         (kMode == kFilmBwd ? sizeof(float) * kMT * 3 * kSlab : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ float film_sin(float arg, int fast_sin) {
  return fast_sin ? cips_fast_sinf(arg) : sinf(arg);
}

__device__ __forceinline__ float sin_grad(float x, int fast_sin) {
  return fast_sin ? cips_fast_sin_gradf(x) : cosf(x);
}

// Warp w: rows 16 (w % 4) + [0, 16), n-tiles w / 4 + 4 j of the slab.
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
__device__ __forceinline__ float bat(const T* B, int k, int n) {
  return cips::to_f(kTrans ? B[n * b_ld<T, kTrans>() + k] : B[k * b_ld<T, kTrans>() + n]);
}

// acc += the panel's product for k < kend; s: the A scale at the panel's k0 (kInr) or null.
// f32: always a fresh partial per k-step (kFresh is for the bf16 overload below).
template <bool kTrans, bool kFresh, typename TA>
__device__ __forceinline__ void panel_mma(float acc[kNT][4], const TA* Ap, const float* Bp,
                                          int kend, int ntv, const float* s, const Frag& f) {
  const TA* r0 = Ap + (16 * f.mt + f.g) * a_ld<TA>();
  const TA* r1 = r0 + 8 * a_ld<TA>();
  for (int k = 0; k < kend; k += 8) {
    float x[4] = {cips::to_f(r0[k + f.t]), cips::to_f(r1[k + f.t]), cips::to_f(r0[k + f.t + 4]),
                  cips::to_f(r1[k + f.t + 4])};
    if (s) {
      const float s0 = __ldg(s + k + f.t), s1 = __ldg(s + k + f.t + 4);
      x[0] *= s0; x[1] *= s0; x[2] *= s1; x[3] *= s1;
    }
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cips::split_tf32(x[i], ahi[i], alo[i]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (f.nt(j) >= ntv) continue;
      const int n = 8 * f.nt(j) + f.g;
      uint32_t bhi[2], blo[2];
      cips::split_tf32(bat<float, kTrans>(Bp, k + f.t, n), bhi[0], blo[0]);
      cips::split_tf32(bat<float, kTrans>(Bp, k + f.t + 4, n), bhi[1], blo[1]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};   // a fresh partial per k-step, added in f32
      cips::mma_3xtf32(part, ahi, alo, bhi, blo);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

template <typename TA>
__device__ __forceinline__ uint32_t a_pair(const TA* r, int k, const float* s) {
  float lo = cips::to_f(r[k]), hi = cips::to_f(r[k + 1]);
  if (s) {
    lo *= __ldg(s + k);
    hi *= __ldg(s + k + 1);
  }
  return cips::pack_bf16(lo, hi);
}

// bf16: m16n8k16 into the accumulator, or (kFresh) into a fresh partial per
// 16-deep k-step added in f32, as the f32 products do: the INR tile's dots
// past 512 deep drift in the MMA's register as the f32 ones did.
template <bool kTrans, bool kFresh, typename TA>
__device__ __forceinline__ void panel_mma(float acc[kNT][4], const TA* Ap,
                                          const __nv_bfloat16* Bp, int kend, int ntv,
                                          const float* s, const Frag& f) {
  using T = __nv_bfloat16;
  constexpr int LB = b_ld<T, kTrans>();
  const TA* r0 = Ap + (16 * f.mt + f.g) * a_ld<TA>();
  const TA* r1 = r0 + 8 * a_ld<TA>();
  for (int k = 0; k < kend; k += 16) {
    const int kk = k + 2 * f.t;
    const uint32_t a[4] = {a_pair(r0, kk, s), a_pair(r1, kk, s), a_pair(r0, kk + 8, s),
                           a_pair(r1, kk + 8, s)};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (f.nt(j) >= ntv) continue;
      const int n = 8 * f.nt(j) + f.g;
      uint32_t b[2];
      if (kTrans) {   // W[n][kk], W[n][kk + 1] are neighbours
        b[0] = *reinterpret_cast<const uint32_t*>(Bp + n * LB + kk);
        b[1] = *reinterpret_cast<const uint32_t*>(Bp + n * LB + kk + 8);
      } else {
        b[0] = cips::pack_bits(Bp[kk * LB + n], Bp[(kk + 1) * LB + n]);
        b[1] = cips::pack_bits(Bp[(kk + 8) * LB + n], Bp[(kk + 9) * LB + n]);
      }
      if (kFresh) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        cips::mma_bf16(part, a, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      } else {
        cips::mma_bf16(acc[j], a, b);
      }
    }
  }
}

__device__ __forceinline__ float col_sum16(float top, float bottom) {
  // the 16 rows of an m-tile: rows g and g + 8 of this lane, then over g
  float x = top + bottom;
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

// T: the weights' (and the products') type; TA: A's element type (T, or
// float for kInr, whose A is x * s).
template <typename T, typename TA, bool kTrans, int kMode>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LA = a_ld<TA>(), LB = b_ld<T, kTrans>(), BR = b_rows<T, kTrans>();
  constexpr int VA = vec_elems<TA>(), VB = vec_elems<T>();
  TA* As = reinterpret_cast<TA*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + al16(sizeof(TA) * 2 * kRows * LA));
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Bs) +
                                        al16(sizeof(T) * 2 * BR * LB));
  const int tid = threadIdx.x, z = blockIdx.z;
  const int r0 = blockIdx.x * kRows, n0 = blockIdx.y * kSlab;
  const int nrow = min(kRows, a.nrows - r0), ncol = min(kSlab, a.N - n0);
  const int K = a.K, akv = min(K, a.akvalid);
  const TA* A0 = a.a.at<TA>(z, r0);
  const T* W = static_cast<const T*>(a.w);
  const Frag f;

  auto issue = [&](int buf, int k0) {
    TA* dA = As + buf * kRows * LA;
    for (int i = tid; i < kRows * (kKP / VA); i += kThreads) {
      const int row = i / (kKP / VA), c = (i % (kKP / VA)) * VA;
      const bool ok = row < nrow && k0 + c < akv;
      cp_async16(dA + row * LA + c, ok ? A0 + (long long)row * a.a.ld + k0 + c : A0, ok);
    }
    T* dB = Bs + buf * BR * LB;
    if (kTrans) {   // rows n of W, k0.. of each
      for (int i = tid; i < kSlab * (kKP / VB); i += kThreads) {
        const int nr = i / (kKP / VB), c = (i % (kKP / VB)) * VB, n = n0 + nr, k = k0 + c;
        const bool ok = n < a.wvalid && n < a.N && k < K;
        cp_async16(dB + nr * LB + c, ok ? W + (long long)n * a.ldw + k : W, ok);
      }
    } else {        // rows k0.. of W, the slab's columns
      for (int i = tid; i < kKP * (kSlab / VB); i += kThreads) {
        const int kr = i / (kSlab / VB), c = (i % (kSlab / VB)) * VB, k = k0 + kr, n = n0 + c;
        const bool ok = k < a.wvalid && k < K && n < a.N;
        cp_async16(dB + kr * LB + c, ok ? W + (long long)k * a.ldw + n : W, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float* scale = kMode == kInr ? a.scale.at(z) : nullptr;
  const int npanel = (K + kKP - 1) / kKP;
  issue(0, 0);
  for (int p = 0; p < npanel; ++p) {
    if (p + 1 < npanel) {
      issue((p + 1) & 1, (p + 1) * kKP);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    panel_mma<kTrans, kMode == kInr>(acc, As + (p & 1) * kRows * LA, Bs + (p & 1) * BR * LB,
                      min(kKP, K - p * kKP), ncol / 8, scale ? scale + p * kKP : nullptr, f);
    __syncthreads();   // every warp is done with the panel before it is refilled
  }

  if constexpr (kMode == kFilmBwd) {
    const float* g = a.gain.at(z);
    const float* sh = a.shift.at(z);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (8 * f.nt(j) >= ncol) continue;   // warp-uniform: the sums below shuffle
      float v[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = f.row(e), col = n0 + f.col(j, e);
        const bool ok = row < nrow;
        float x = acc[j][e];
        if (a.dsig.p && ok)
          x += cips::to_f(*a.dsig.at<T>(z, r0 + row)) * cips::to_f(static_cast<const T*>(a.ws)[col]);
        const float av = ok ? a.ares.at<float>(z, r0 + row)[col] : 0.f;
        const float gv = g[col];
        const float darg = ok ? x * sin_grad(gv * av + sh[col], a.fast_sin) : 0.f;
        const float da = darg * gv;
        v[0][e] = darg * av;
        v[1][e] = darg;
        v[2][e] = da;
        if (ok) a.out.at<T>(z, r0 + row)[col] = cips::from_f<T>(cips::round_mm<T>(da));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float s = col_sum16(v[k][p], v[k][p + 2]);
          if (f.g == 0) red[(f.mt * 3 + k) * kSlab + f.col(j, p)] = s;
        }
    }
    __syncthreads();
    float* part = a.part.at<float>(z, blockIdx.x);
    for (int i = tid; i < 3 * ncol; i += kThreads) {
      const int k = i / ncol, c = i % ncol;
      float s = 0.f;
      for (int mt = 0; mt < kMT; ++mt) s += red[(mt * 3 + k) * kSlab + c];
      part[k * a.N + n0 + c] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (8 * f.nt(j) >= ncol) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = f.row(e), col = n0 + f.col(j, e);
        if (row >= nrow) continue;
        const int r = r0 + row;
        if constexpr (kMode == kFilm) {
          const float av = acc[j][e] + a.bias.p[col];
          const float h = cips::round_mm<T>(
              film_sin(a.gain.at(z)[col] * av + a.shift.at(z)[col], a.fast_sin));
          a.out.at<T>(z, r)[col] = cips::from_f<T>(h);
          if (a.out_a.p) a.out_a.at<float>(z, r)[col] = av;
        } else if constexpr (kMode == kLinear) {
          a.out.at<float>(z, r)[col] = acc[j][e] + a.bias.p[col];
        } else if constexpr (kMode == kDx) {
          if (col < 3) a.out.at<float>(z, r)[col] = acc[j][e] * a.warp_scale;
        } else {   // kInr
          const float v = acc[j][e] * a.demod.at(z)[col];
          float o = v > 0.f ? v : 0.2f * v;
          if (a.resid.p) o += a.resid.at<float>(z, r)[col];
          a.out.at<float>(z, r)[col] = o;
        }
      }
    }
  }
}

#define CIPS_TRY(x)                          \
  do {                                       \
    const cudaError_t e_ = (x);              \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// One launch over a.nrows rows of each of nz batch rows.
template <typename T, typename TA, bool kTrans, int kMode>
cudaError_t gemm(const GemmArgs& a, int nz, cudaStream_t stream) {
  constexpr size_t sm = gemm_smem<T, TA, kTrans, kMode>();
  cudaError_t err = cips::raise_smem(gemm_kernel<T, TA, kTrans, kMode>, sm);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nrows + kRows - 1) / kRows, (a.N + kSlab - 1) / kSlab, nz);
  gemm_kernel<T, TA, kTrans, kMode><<<grid, kThreads, sm, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace cips_stream
