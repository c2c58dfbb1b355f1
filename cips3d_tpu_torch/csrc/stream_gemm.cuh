// The tensor-core product of the streamed paths (ray_tile_streamed.cu,
// inr_tile_streamed.cu): one layer of a point MLP over rows held in device
// memory,
//
//     out[row, col] = epilogue(sum_k A[row, k] B[k, col]),
//
// for any depth K and width N, with shared memory that does not grow with
// either.  Replaces, with them, cips3d_tpu/ops/pallas/ray_tile.py::
// _ray_tile_kernel and _ray_tile_bwd_kernel and inr_tile.py::
// _inr_tile_kernel at the shapes the resident kernels do not take (NeRF
// depth 3 at width 128 in f32, widths past 128 / 512, S past 64).
//
// What bounds it on an H100: f32 products run as 3xTF32 on mma.sync (three
// m16n8k8 products a k-step), so a layer of 128 x 128 at r128 x 24 (12.9
// GFLOP) or 1024 x 1024 over 4096 pixels (8.6 GFLOP) is bound by the tensor
// cores' issue and the splits feeding them and, at K = 128, by each tile's
// epilogue (the NeRF layers' sine and the 200 MB of h they write), not by
// the bytes.  The first version (16 warps over 64 rows x 128 columns, one
// 16-row tile a warp) fed each B fragment to one MMA, split every A and B
// value to hi/lo TF32 again in every warp that read it, read fragments
// element by element, read the weight slab again from L2 for every 64
// rows, and chose the sine per element (so sinf's range reduction ran
// beside the polynomial).  This design:
//   * block tiles of 128 rows (kRows) x BN columns, BN = 128, 64 or 32 as
//     the layer is wide (the colour FiLM's C = 64, the rgb head's R = 32 and
//     the d pts product keep every warp busy); 8 warps, each 16 x (4 m-tiles
//     at BN = 128, 2 at 64, 1 at 32) rows x 32 columns, so each B fragment
//     feeds up to four MMAs and each A fragment four, the tiles' 3xTF32
//     chains interleaved;
//   * panels (16 deep in f32, 32 in bf16) land by cp.async in a ring of two
//     raw stages, and once there are split by the whole block, a fragment a
//     thread, into hi/lo TF32 (f32) or bf16 pairs (bf16, with the kInr scale
//     applied and rounded) in fragment order, into one of two split buffers:
//     each value is converted once a block, and a warp reads a fragment
//     with one 16-byte load a lane, conflict free;
//   * kInr's weights, read by every row tile of a 1024-wide layer, are split
//     once a layer (presplit_w, about 6 us at D = 1024) and land split, in a
//     ring of three panels;
//   * one barrier a panel: wait for the next raw panel, barrier, issue the
//     panel after it, split the next, multiply this one;
//   * the epilogue reads each column's operands once, through the
//     read-only cache, and each row's two neighbouring outputs with one
//     access; the sine (and its derivative) is chosen at compile time;
//   * two blocks of 8 warps a SM (under 113 KB of shared memory each in f32,
//     128 registers a thread), one tile a block.  A persistent grid that
//     streamed a block's tiles through one ring ran slower (its cursors
//     spilled registers), and a resident K x 128 weight slab, split, would
//     not leave room for two blocks a SM.
// Measured on an H100 (tools/stream_split.py): the K = 128 NeRF layers
// 670 -> 395 us, the D = 1024 INR layers 352 -> 197 us.
// The arithmetic is the first version's: f32 products as 3xTF32 with a
// fresh partial per 8-deep k-step added in f32, bf16 products as m16n8k16
// with f32 accumulation (kInr: a fresh partial per 16-deep k-step, since a
// 1024-deep dot kept in the MMA's register drifts), in the same k order, so
// every product sum is the same bits.  The streamed backward's FiLM sums
// take 128-row chunks (cips_stream_tile reports the row tile to the
// wrappers).  The weight grads (wgrad_kernel) run the same core with A =
// X^T read from a transposed raw panel (kAT) and the points as the depth,
// every matrix of one tile width in one launch.
//   B = W (K x N, kTrans false) or W^T (W is N x K, kTrans true: the
//   backward's d-input products); rows of W past `wvalid` read as zeros.
// Every row-indexed operand is a Mat: row r of batch row z at
// p + (z * zstride + row0 + r) * ld + col.
#pragma once

#include "common.cuh"
#include "fast_sin.cuh"

namespace cips_stream {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 128;             // rows per block tile: eight 16-row MMA tiles
constexpr int kMTiles = kRows / 16;
constexpr int kSlab = 128;             // the widest block tile (columns)

// Epilogues.
enum Mode {
  kFilm = 0,     // h = round(sin(g (acc + b) + f)) to out (mm type), acc + b to out_a (f32)
  kLinear = 1,   // out = acc + b (f32)
  kFilmBwd = 2,  // x = acc + dsig ws to out_a (f32): the FiLM backward follows in its own launch
  kDx = 3,       // out[row, col < 3] = acc * warp_scale (f32, d pts)
  kInr = 4,      // A scaled by s[k]; out = lrelu_0.2(acc demod) (+ resid), f32; ToRGB sums
  kFilmA = 6,    // acc + b to out_a (f32) alone: the exact sine follows in its own launch
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
  Mat out, out_a;    // out_a.p null: no pre-activations; kInr: out.p null writes no plane
  Mat dsig;          // kFilmBwd: d sigma (mm type, column 0), or p null
  const void* ws;    // kFilmBwd: the sigma head (N), with dsig
  Vec bias, gain, shift, scale, demod;
  Mat resid;         // kInr: added after the activation (p null: none)
  const void* wr;    // kInr: ToRGB weights (N x 3, mm type), or null: no ToRGB sums
  float* rgbp;       // kInr with wr: (nz, nrows, nslab, 3) f32 slab sums of round(out) . wr
  float warp_scale;
  int fast_sin;
};

__host__ __device__ constexpr size_t al16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

template <typename T> struct Step;
template <> struct Step<float> {           // 3xTF32 m16n8k8
  static constexpr int kStep = 8, kPanel = 16;
};
template <> struct Step<__nv_bfloat16> {   // m16n8k16
  static constexpr int kStep = 16, kPanel = 32;
};

// The shapes of one block tile: T the products' type, TA A's element type
// (T, or float for kInr, whose A is x * s), BN the tile's columns; kPreB:
// B comes split already (presplit_w), in a ring of three panels, and has no
// raw stage; kAT: A is the transpose of a matrix in device memory (the
// weight grads' X^T), its raw panel KP rows (k) of kRows columns (m).
template <typename T, typename TA, bool kTrans, int BN, bool kPreB = false, bool kAT = false>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int KP = Step<T>::kPanel, KST = Step<T>::kStep, KS = KP / KST;
  static constexpr int kWN = BN / 32;        // warps along the columns
  static constexpr int kWM = kWarps / kWN;   // ... along the rows
  static constexpr int kMT = kMTiles / kWM;  // 16-row tiles a warp
  static constexpr int kNT = 4;              // 8-column tiles a warp
  static constexpr int VA = 16 / (int)sizeof(TA), VB = 16 / (int)sizeof(T);
  // raw row strides (elements), padded so that the split pass hits distinct banks
  static constexpr int LA = KP + (sizeof(TA) == 4 && !kF32 ? 8 : VA);
  static constexpr int LB = kTrans ? KP + VB : BN + 8;
  static constexpr int LAT = kRows + 8;          // kAT: raw row stride, conflict-free splits
  static constexpr int BR = kTrans ? BN : KP;   // raw B rows
  static constexpr size_t kRawA = kAT ? al16(sizeof(TA) * KP * LAT) : al16(sizeof(TA) * kRows * LA);
  static constexpr size_t kRawB = kPreB ? 0 : al16(sizeof(T) * BR * LB);
  // split panels in fragment order, 16 bytes a lane: A (hi, lo) or packed
  // bf16 per m-tile and k-step; B (hi0, hi1, lo0, lo1) per n-tile and k-step,
  // or both k-steps' packed pairs per n-tile
  static constexpr size_t kSplitA = (size_t)kMTiles * KS * (kF32 ? 2 : 1) * 32 * 16;
  static constexpr size_t kSplitB = (size_t)(BN / 8) * (kF32 ? KS : 1) * 32 * 16;
  static constexpr int kBSlots = kPreB ? 3 : 2;
  static constexpr size_t kRing = 2 * (kRawA + kRawB);
  static constexpr size_t kBytes = kRing + 2 * kSplitA + kBSlots * kSplitB;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// The sine and its derivative, chosen at compile time: chosen per element,
// the compiler evaluates sinf's range reduction beside the polynomial.
template <bool kFast>
__device__ __forceinline__ float film_sin(float arg) {
  if constexpr (kFast) return cips_fast_sinf(arg);
  else return sinf(arg);
}

template <bool kFast>
__device__ __forceinline__ float sin_grad(float x) {
  if constexpr (kFast) return cips_fast_sin_gradf(x);
  else return cosf(x);
}

// Warp w: m-tiles (w / kWN) kMT + [0, kMT), n-tiles (w % kWN) 4 + [0, 4).
template <class C>
struct Frag {
  int wm, wn, g, t, lane;
  __device__ Frag() {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    wm = warp / C::kWN;
    wn = warp % C::kWN;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ int mt(int i) const { return wm * C::kMT + i; }
  __device__ int nt(int j) const { return wn * C::kNT + j; }
  __device__ int row(int i, int e) const { return 16 * mt(i) + g + 8 * (e >> 1); }
  __device__ int col(int j, int e) const { return 8 * nt(j) + 2 * t + (e & 1); }
};

template <class C>
using Acc = float[C::kMT][C::kNT][4];

template <class C>
__device__ __forceinline__ void zero(Acc<C>& acc) {
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// ---- the split pass: a raw panel into fragment order ----------------------

// A: one fragment (m-tile m, k-step s, lane) a task, rows 16 m + g (+ 8),
// columns KST s + (t | 2t) (+ 4 | + 8); s: the kInr scale at the panel's k0
// (columns past `kv` are zero and read no scale), or null.
template <class C, typename TA>
__device__ __forceinline__ void split_a(uint4* dst, const TA* raw, int lda, const float* s, int kv) {
  constexpr int tasks = kMTiles * C::KS * 32;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int lane = task & 31, ms = task >> 5, m = ms / C::KS, st = ms % C::KS;
    const int g = lane >> 2, t = lane & 3;
    const TA* r0 = raw + (16 * m + g) * lda;
    const TA* r1 = r0 + 8 * lda;
    if constexpr (C::kF32) {
      const int k = 8 * st + t;
      float x[4] = {cips::to_f(r0[k]), cips::to_f(r1[k]), cips::to_f(r0[k + 4]),
                    cips::to_f(r1[k + 4])};
      if (s) {
        const float s0 = k < kv ? __ldg(s + k) : 0.f, s1 = k + 4 < kv ? __ldg(s + k + 4) : 0.f;
        x[0] *= s0; x[1] *= s0; x[2] *= s1; x[3] *= s1;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cips::split_tf32(x[i], hi[i], lo[i]);
      dst[(ms * 2 + 0) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst[(ms * 2 + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      const int k = 16 * st + 2 * t;
      uint32_t a[4];
      if constexpr (sizeof(TA) == 2) {   // bf16 pairs as they lie
        a[0] = *reinterpret_cast<const uint32_t*>(r0 + k);
        a[1] = *reinterpret_cast<const uint32_t*>(r1 + k);
        a[2] = *reinterpret_cast<const uint32_t*>(r0 + k + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(r1 + k + 8);
      } else {                           // kInr: x * s rounded to bf16
        auto sc = [&](int kk) { return s ? (kk < kv ? __ldg(s + kk) : 0.f) : 1.f; };
        const float s0 = sc(k), s1 = sc(k + 1), s8 = sc(k + 8), s9 = sc(k + 9);
        const float2 p0 = *reinterpret_cast<const float2*>(r0 + k);
        const float2 p1 = *reinterpret_cast<const float2*>(r1 + k);
        const float2 p2 = *reinterpret_cast<const float2*>(r0 + k + 8);
        const float2 p3 = *reinterpret_cast<const float2*>(r1 + k + 8);
        a[0] = cips::pack_bf16(p0.x * s0, p0.y * s1);
        a[1] = cips::pack_bf16(p1.x * s0, p1.y * s1);
        a[2] = cips::pack_bf16(p2.x * s8, p2.y * s9);
        a[3] = cips::pack_bf16(p3.x * s8, p3.y * s9);
      }
      dst[ms * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
    }
  }
}

// A from a transposed raw panel (kAT: A[m][k] at raw[k LAT + m]), in the
// fragment order of split_a.
template <class C, typename TA>
__device__ __forceinline__ void split_at(uint4* dst, const TA* raw) {
  constexpr int tasks = kMTiles * C::KS * 32, L = C::LAT;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int lane = task & 31, ms = task >> 5, m = ms / C::KS, st = ms % C::KS;
    const TA* c0 = raw + 16 * m + (lane >> 2);   // column (A row) 16 m + g; + 8: row g + 8
    const int t = lane & 3;
    if constexpr (C::kF32) {
      const int k = 8 * st + t;
      const float x[4] = {cips::to_f(c0[k * L]), cips::to_f(c0[k * L + 8]),
                          cips::to_f(c0[(k + 4) * L]), cips::to_f(c0[(k + 4) * L + 8])};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cips::split_tf32(x[i], hi[i], lo[i]);
      dst[(ms * 2 + 0) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst[(ms * 2 + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      const int k = 16 * st + 2 * t;
      dst[ms * 32 + lane] = make_uint4(cips::pack_bits(c0[k * L], c0[(k + 1) * L]),
                                       cips::pack_bits(c0[k * L + 8], c0[(k + 1) * L + 8]),
                                       cips::pack_bits(c0[(k + 8) * L], c0[(k + 9) * L]),
                                       cips::pack_bits(c0[(k + 8) * L + 8], c0[(k + 9) * L + 8]));
    }
  }
}

// B value (k, n) of a raw panel
template <class C, bool kTrans, typename T>
__device__ __forceinline__ T braw(const T* B, int k, int n) {
  return kTrans ? B[n * C::LB + k] : B[k * C::LB + n];
}

// One B panel (BN columns, KP deep) in fragment order, `get(k, n)` its
// values (panel-relative): dst[task] for task = threadIdx.x + i * nthreads.
template <class C, typename T, int BN, class Get>
__device__ __forceinline__ void split_b_from(uint4* dst, int task0, int nthreads, const Get& get) {
  if constexpr (C::kF32) {   // one (n-tile, k-step, lane) a task
    constexpr int tasks = (BN / 8) * C::KS * 32;
    for (int task = task0; task < tasks; task += nthreads) {
      const int lane = task & 31, ns = task >> 5, nt = ns / C::KS, st = ns % C::KS;
      const int n = 8 * nt + (lane >> 2), k = 8 * st + (lane & 3);
      uint32_t h0, l0, h1, l1;
      cips::split_tf32(cips::to_f(get(k, n)), h0, l0);
      cips::split_tf32(cips::to_f(get(k + 4, n)), h1, l1);
      dst[ns * 32 + lane] = make_uint4(h0, h1, l0, l1);
    }
  } else {                   // one (n-tile, lane) a task, both k-steps
    constexpr int tasks = (BN / 8) * 32;
    for (int task = task0; task < tasks; task += nthreads) {
      const int lane = task & 31, nt = task >> 5;
      const int n = 8 * nt + (lane >> 2), k = 2 * (lane & 3);
      uint32_t b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // k-step q / 2, register q % 2
        const int kk = 16 * (q >> 1) + 8 * (q & 1) + k;
        b[q] = cips::pack_bits(get(kk, n), get(kk + 1, n));
      }
      dst[task] = make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
}

template <class C, bool kTrans, typename T, int BN>
__device__ __forceinline__ void split_b(uint4* dst, const T* raw) {
  if constexpr (!C::kF32 && kTrans) {   // W[n][kk], W[n][kk + 1] are neighbours
    constexpr int tasks = (BN / 8) * 32;
    for (int task = threadIdx.x; task < tasks; task += kThreads) {
      const int lane = task & 31, n = 8 * (task >> 5) + (lane >> 2), k = 2 * (lane & 3);
      uint32_t b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const uint32_t*>(raw + n * C::LB + 16 * (q >> 1) + 8 * (q & 1) + k);
      dst[task] = make_uint4(b[0], b[1], b[2], b[3]);
    }
  } else {
    split_b_from<C, T, BN>(dst, threadIdx.x, kThreads,
                           [&](int k, int n) { return braw<C, kTrans>(raw, k, n); });
  }
}

// W (K x N, row stride ldw, rows past wvalid zero) split once, for products
// that read it from every row tile (kPreB): panel p of column tile ct at
// out + (ct * ceil(K / KP) + p) * Tile::kSplitB bytes.  Grid: panels,
// column tiles.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) presplit_w(const T* W, int ldw, int wvalid, int K,
                                                      int N, uint4* out) {
  using C = Tile<T, float, false, BN, true>;
  const int p = blockIdx.x, ct = blockIdx.y, np = gridDim.x;
  const int k0 = p * C::KP, n0 = ct * BN;
  uint4* dst = out + ((size_t)ct * np + p) * (C::kSplitB / 16);
  split_b_from<C, T, BN>(dst, threadIdx.x, kThreads, [&](int k, int n) {
    const int kk = k0 + k, nn = n0 + n;
    return kk < wvalid && kk < K && nn < N ? W[(long long)kk * ldw + nn] : cips::from_f<T>(0.f);
  });
}

// acc += k-step st of a split panel; ntv: valid n-tiles.
template <class C, bool kFresh>
__device__ __forceinline__ void mma_step(Acc<C>& acc, const uint4* As, const uint4* Bs, int st,
                                         int ntv, const Frag<C>& f) {
  uint4 bq[C::kNT];
#pragma unroll
  for (int j = 0; j < C::kNT; ++j)
    if (f.nt(j) < ntv)
      bq[j] = C::kF32 ? Bs[(f.nt(j) * C::KS + st) * 32 + f.lane] : Bs[f.nt(j) * 32 + f.lane];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i) {
    if constexpr (C::kF32) {
      const uint4 h = As[((f.mt(i) * C::KS + st) * 2 + 0) * 32 + f.lane];
      const uint4 l = As[((f.mt(i) * C::KS + st) * 2 + 1) * 32 + f.lane];
      const uint32_t ahi[4] = {h.x, h.y, h.z, h.w}, alo[4] = {l.x, l.y, l.z, l.w};
      // a fresh partial per tile and k-step, added in f32: each tile's three
      // products in mma_3xtf32's order, the four tiles' chains interleaved
      float part[C::kNT][4];
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
        const uint32_t b[2] = {bq[j].x, bq[j].y};
        if (f.nt(j) < ntv) cips::mma_tf32(part[j], alo, b);
      }
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        const uint32_t b[2] = {bq[j].z, bq[j].w};
        if (f.nt(j) < ntv) cips::mma_tf32(part[j], ahi, b);
      }
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        const uint32_t b[2] = {bq[j].x, bq[j].y};
        if (f.nt(j) < ntv) cips::mma_tf32(part[j], ahi, b);
      }
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (f.nt(j) < ntv) acc[i][j][e] += part[j][e];
    } else {
      const uint4 q = As[(f.mt(i) * C::KS + st) * 32 + f.lane];
      const uint32_t a[4] = {q.x, q.y, q.z, q.w};
      float part[C::kNT][4];   // kFresh: a fresh partial per tile and k-step
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        if (f.nt(j) >= ntv) continue;
        const uint32_t b[2] = {st ? bq[j].z : bq[j].x, st ? bq[j].w : bq[j].y};
        if (kFresh) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
          cips::mma_bf16(part[j], a, b);
        } else {
          cips::mma_bf16(acc[i][j], a, b);
        }
      }
      if (kFresh)
#pragma unroll
        for (int j = 0; j < C::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (f.nt(j) < ntv) acc[i][j][e] += part[j][e];
    }
  }
}

// acc += the panel's product for k-steps below kend.
template <class C, bool kFresh>
__device__ __forceinline__ void panel_mma(Acc<C>& acc, const uint4* As, const uint4* Bs, int kend,
                                          int ntv, const Frag<C>& f) {
#pragma unroll
  for (int st = 0; st < C::KS; ++st)
    if (st * C::KST < kend) mma_step<C, kFresh>(acc, As, Bs, st, ntv, f);
}

// Where a block's product reads A: device memory through the raw ring
// (`g`, row `r0` of batch row z; kAT: g at A's row 0, k 0 of X^T, so
// X row k, column m at g + k ld + m), or a matrix already in shared memory
// (`sh`, row stride `ld`; panel p at column p KP).
template <typename TA>
struct ASrc {
  const TA* g;
  int ld;
  int nrow, akv;   // rows and columns to read (the rest zero)
  const TA* sh;
};

// acc += A[tile rows, k < K] B[k < K, n0 + tile columns] over the block's
// tile, through the ring; ends in a barrier, so the caller may reuse the
// shared memory.  `smem`: Tile::kBytes; scale: kInr's s (k = 0 at s) or null.
// kPreB: W is presplit_w's output (its column tile n0 / BN), not W.  kAT:
// A is X^T (ASrc above).
template <typename T, typename TA, bool kTrans, int BN, bool kFresh, bool kPreB = false,
          bool kAT = false>
__device__ void tile_product(Acc<Tile<T, TA, kTrans, BN, kPreB, kAT>>& acc, unsigned char* smem,
                             const ASrc<TA>& A, const T* W, int ldw, int wvalid, int K, int N,
                             int n0, const float* scale) {
  using C = Tile<T, TA, kTrans, BN, kPreB, kAT>;
  constexpr int KP = C::KP, VA = C::VA, VB = C::VB;
  const Frag<C> f;
  const int tid = threadIdx.x;
  auto rawA = [&](int slot) { return reinterpret_cast<TA*>(smem + slot * (C::kRawA + C::kRawB)); };
  auto rawB = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * (C::kRawA + C::kRawB) + C::kRawA);
  };
  auto splitA = [&](int buf) { return reinterpret_cast<uint4*>(smem + C::kRing + buf * C::kSplitA); };
  auto splitB = [&](int slot) {
    return reinterpret_cast<uint4*>(smem + C::kRing + 2 * C::kSplitA + slot * C::kSplitB);
  };
  auto bslot = [&](int p) { return kPreB ? p % 3 : p & 1; };
  const int ntv = min(BN, N - n0) / 8;
  const int np = (K + KP - 1) / KP;

  auto issue = [&](int p) {   // panel p into raw slot p % 2 (B split: into its slot)
    const int k0 = p * KP, slot = p & 1;
    if constexpr (kAT) {   // KP rows k of X, the tile's kRows columns m each
      TA* dA = rawA(slot);
      for (int i = tid; i < KP * (kRows / VA); i += kThreads) {
        const int kr = i / (kRows / VA), c = (i % (kRows / VA)) * VA;
        const bool ok = k0 + kr < A.akv && c < A.nrow;
        cp_async16(dA + kr * C::LAT + c, ok ? A.g + (long long)(k0 + kr) * A.ld + c : A.g, ok);
      }
    } else if (!A.sh) {
      TA* dA = rawA(slot);
      for (int i = tid; i < kRows * (KP / VA); i += kThreads) {
        const int row = i / (KP / VA), c = (i % (KP / VA)) * VA;
        const bool ok = row < A.nrow && k0 + c < A.akv;
        cp_async16(dA + row * C::LA + c, ok ? A.g + (long long)row * A.ld + k0 + c : A.g, ok);
      }
    }
    if constexpr (kPreB) {
      const uint4* src = reinterpret_cast<const uint4*>(W) +
                         ((size_t)(n0 / BN) * np + p) * (C::kSplitB / 16);
      uint4* dst = splitB(bslot(p));
      for (int i = tid; i < (int)(C::kSplitB / 16); i += kThreads) cp_async16(dst + i, src + i, true);
    } else {
      T* dB = rawB(slot);
      if (kTrans) {   // rows n of W, k0.. of each
        for (int i = tid; i < BN * (KP / VB); i += kThreads) {
          const int nr = i / (KP / VB), c = (i % (KP / VB)) * VB, n = n0 + nr, k = k0 + c;
          const bool ok = n < wvalid && n < N && k < K;
          cp_async16(dB + nr * C::LB + c, ok ? W + (long long)n * ldw + k : W, ok);
        }
      } else {        // rows k0.. of W, the tile's columns
        for (int i = tid; i < KP * (BN / VB); i += kThreads) {
          const int kr = i / (BN / VB), c = (i % (BN / VB)) * VB, k = k0 + kr, n = n0 + c;
          const bool ok = k < wvalid && k < K && n < N;
          cp_async16(dB + kr * C::LB + c, ok ? W + (long long)k * ldw + n : W, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto split = [&](int p) {   // panel p from raw slot p % 2 into split buffer p % 2
    const int k0 = p * KP, buf = p & 1;
    if constexpr (kAT)
      split_at<C>(splitA(buf), rawA(buf));
    else if (A.sh)
      split_a<C>(splitA(buf), A.sh + k0, A.ld, nullptr, 0);
    else
      split_a<C>(splitA(buf), rawA(buf), C::LA, scale ? scale + k0 : nullptr, K - k0);
    if constexpr (!kPreB) split_b<C, kTrans, T, BN>(splitB(buf), rawB(buf));
  };

  issue(0);
  if (np > 1) {
    issue(1);
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();
  split(0);
  for (int p = 0; p < np; ++p) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // split p and raw p + 1 complete; split and raw p - 1 free
    if (p + 2 < np) issue(p + 2);
    if (p + 1 < np) split(p + 1);
    panel_mma<C, kFresh>(acc, splitA(p & 1), splitB(bslot(p)), K - p * KP, ntv, f);
  }
  __syncthreads();
}

// Two neighbouring outputs of a row (an even column): one 8- or 4-byte store.
template <typename U>
__device__ __forceinline__ void store2(U* p, float v0, float v1) {
  if constexpr (sizeof(U) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<uint32_t*>(p) = cips::pack_bf16(v0, v1);
  }
}

template <typename T, typename TA, bool kTrans, int BN, int kMode>
__host__ __device__ constexpr size_t extra_smem() {
  using C = Tile<T, TA, kTrans, BN>;
  return kMode == kInr ? sizeof(float) * C::kWN * kRows * 3 : 0;
}

template <typename T, typename TA, bool kTrans, int BN, int kMode>
__host__ __device__ constexpr size_t gemm_smem() {
  return Tile<T, TA, kTrans, BN, kMode == kInr>::kBytes + extra_smem<T, TA, kTrans, BN, kMode>();
}

// A read-only operand through the non-coherent cache.
template <typename U>
__device__ __forceinline__ float ldf(const U* p) {
  return cips::to_f(__ldg(p));
}

// The epilogue of tile (z, row tile rt, column tile ct) on its sums; kFast:
// the polynomial sine (kFilm).  Each thread holds two neighbouring
// columns of four n-tiles for all its rows: their per-column operands are
// read once, before the rows, and each row's pair is read and written with
// one 8- (f32) or 4-byte (bf16) access.
template <typename T, typename TA, bool kTrans, int BN, int kMode, bool kFast>
__device__ __forceinline__ void epilogue(const GemmArgs& a, const Acc<Tile<T, TA, kTrans, BN>>& acc,
                                         float* red, int z, int rt, int ct) {
  using C = Tile<T, TA, kTrans, BN>;
  const int tid = threadIdx.x;
  const int r0 = rt * kRows, n0 = ct * BN;
  const int nrow = min(kRows, a.nrows - r0), ncol = min(BN, a.N - n0);
  const Frag<C> f;
  // per-column operands of this thread's columns n0 + f.col(j, c)
  float p0[C::kNT][2], p1[C::kNT][2], p2[C::kNT][2];
#pragma unroll
  for (int j = 0; j < C::kNT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + f.col(j, c);
      const bool ok = 8 * f.nt(j) < ncol;
      p0[j][c] = p1[j][c] = p2[j][c] = 0.f;
      if (!ok) continue;
      if constexpr (kMode == kFilm) {
        p0[j][c] = __ldg(a.bias.p + col);
        p1[j][c] = __ldg(a.gain.at(z) + col);
        p2[j][c] = __ldg(a.shift.at(z) + col);
      } else if constexpr (kMode == kLinear || kMode == kFilmA) {
        p0[j][c] = __ldg(a.bias.p + col);
      } else if constexpr (kMode == kFilmBwd) {
        if (a.dsig.p) p0[j][c] = ldf(static_cast<const T*>(a.ws) + col);
      } else if constexpr (kMode == kInr) {
        p0[j][c] = __ldg(a.demod.at(z) + col);
      }
    }
  // kInr with ToRGB: this thread's share of round(out) . wr, a row at a time
  constexpr bool kRgb = kMode == kInr;
  float rgb[C::kMT][2][3];
  if constexpr (kRgb) {
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) rgb[i][h][0] = rgb[i][h][1] = rgb[i][h][2] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j) {
      if (8 * f.nt(j) >= ncol) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows g and g + 8: two neighbouring columns each
        const int row = f.row(i, 2 * h), col = n0 + f.col(j, 0);
        if (row >= nrow) continue;
        const int r = r0 + row;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (kMode == kFilm) {
          const float a0 = v0 + p0[j][0], a1 = v1 + p0[j][1];
          const float h0 = cips::round_mm<T>(film_sin<kFast>(p1[j][0] * a0 + p2[j][0]));
          const float h1 = cips::round_mm<T>(film_sin<kFast>(p1[j][1] * a1 + p2[j][1]));
          store2<T>(a.out.at<T>(z, r) + col, h0, h1);
          if (a.out_a.p) store2<float>(a.out_a.at<float>(z, r) + col, a0, a1);
        } else if constexpr (kMode == kLinear) {
          store2<float>(a.out.at<float>(z, r) + col, v0 + p0[j][0], v1 + p0[j][1]);
        } else if constexpr (kMode == kFilmA) {   // the sine follows in its own launch
          store2<float>(a.out_a.at<float>(z, r) + col, v0 + p0[j][0], v1 + p0[j][1]);
        } else if constexpr (kMode == kFilmBwd) {   // d h (+ d sigma ws)
          float x0 = v0, x1 = v1;
          if (a.dsig.p) {
            const float ds = ldf(a.dsig.at<T>(z, r));
            x0 += ds * p0[j][0];
            x1 += ds * p0[j][1];
          }
          store2<float>(a.out_a.at<float>(z, r) + col, x0, x1);
        } else if constexpr (kMode == kDx) {
          float* o = a.out.at<float>(z, r);
          if (col < 3) o[col] = v0 * a.warp_scale;
          if (col + 1 < 3) o[col + 1] = v1 * a.warp_scale;
        } else {   // kInr
          const float u0 = v0 * p0[j][0], u1 = v1 * p0[j][1];
          float o0 = u0 > 0.f ? u0 : 0.2f * u0, o1 = u1 > 0.f ? u1 : 0.2f * u1;
          if (a.resid.p) {
            const float2 q = *reinterpret_cast<const float2*>(a.resid.at<float>(z, r) + col);
            o0 += q.x;
            o1 += q.y;
          }
          if (a.out.p) store2<float>(a.out.at<float>(z, r) + col, o0, o1);
          if (a.wr) {
            const T* wr = static_cast<const T*>(a.wr) + col * 3;
            const float x0 = cips::round_mm<T>(o0), x1 = cips::round_mm<T>(o1);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              rgb[i][h][ch] = fmaf(x0, ldf(wr + ch), rgb[i][h][ch]);
              rgb[i][h][ch] = fmaf(x1, ldf(wr + 3 + ch), rgb[i][h][ch]);
            }
          }
        }
      }
    }
  if constexpr (kRgb) {
    if (a.wr) {   // over the 4 lanes of a row, then the kWN warps of the tile in order
#pragma unroll
      for (int i = 0; i < C::kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float v = rgb[i][h][ch];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (f.t == 0) red[(f.wn * kRows + 16 * f.mt(i) + f.g + 8 * h) * 3 + ch] = v;
          }
      __syncthreads();
      const int nslab = (a.N + BN - 1) / BN;
      for (int i = tid; i < nrow * 3; i += kThreads) {
        const int row = i / 3, ch = i % 3;
        float s = 0.f;
        for (int wn = 0; wn < C::kWN; ++wn) s += red[(wn * kRows + row) * 3 + ch];
        a.rgbp[(((long long)z * a.nrows + r0 + row) * nslab + ct) * 3 + ch] = s;
      }
    }
  }
}

// T: the weights' (and the products') type; TA: A's element type (T, or
// float for kInr, whose A is x * s).  Grid: row tiles, column tiles, batch rows.
template <typename T, typename TA, bool kTrans, int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Tile<T, TA, kTrans, BN, kMode == kInr>;
  const int z = blockIdx.z, rt = blockIdx.x, ct = blockIdx.y, r0 = rt * kRows;
  Acc<C> acc;
  zero<C>(acc);
  const ASrc<TA> A{a.a.at<TA>(z, r0), a.a.ld, min(kRows, a.nrows - r0), min(a.K, a.akvalid),
                   nullptr};
  tile_product<T, TA, kTrans, BN, kMode == kInr, kMode == kInr>(
      acc, smem, A, static_cast<const T*>(a.w), a.ldw, a.wvalid, a.K, a.N, ct * BN,
      kMode == kInr ? a.scale.at(z) : nullptr);
  float* red = reinterpret_cast<float*>(smem + C::kBytes);
  if (kMode != kFilm)
    epilogue<T, TA, kTrans, BN, kMode, false>(a, acc, red, z, rt, ct);
  else if (a.fast_sin)
    epilogue<T, TA, kTrans, BN, kMode, true>(a, acc, red, z, rt, ct);
  else
    epilogue<T, TA, kTrans, BN, kMode, false>(a, acc, red, z, rt, ct);
}

// ---- the weight grads: dW = X^T dQ, the points as the depth -----------------

constexpr int kMaxJobs = 12;

// One matrix's product: A = X^T (X: points x ldx, A row m = X column m),
// B = dQ (points x ldb); column c < wn of row m of a split's product lands
// at out + (trans ? c ld + m : m ld + c), each split's row wstride floats on.
struct WJob {
  const void *x, *b;
  int ldx, ldb, M, N;
  float* out;
  int ld, wn, trans;
  int tile0;   // the job's first tile (grid x)
};

struct WgradArgs {
  WJob job[kMaxJobs];
  int njobs, split_rows;
  long long npoints, wstride;
};

// The job of tile y (WgradArgs' tiles in job order), chosen with loads at
// fixed offsets rather than by indexing the parameter array at run time.
__device__ __forceinline__ WJob wgrad_job_of(const WgradArgs& w, int y) {
  WJob jb = w.job[0];
#pragma unroll
  for (int q = 1; q < kMaxJobs; ++q)
    if (q < w.njobs && y >= w.job[q].tile0) jb = w.job[q];
  return jb;
}

// blockIdx.x read afresh: a value the compiler cannot reuse from before a loop.
__device__ __forceinline__ int ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// Every job's tiles (kRows x BN) over every split of split_rows points in
// one launch: grid (tiles, splits), so that the blocks of all the matrices
// of one width fill the card together and a split's tiles, side by side,
// share its panels in L2.  Each
// block: the streamed core's product with X^T as A (each staged value split
// to hi/lo TF32 or packed once a block, in fragment order; warp tiles of
// several m-tiles x 4 n-tiles; the raw ring issuing two panels ahead of the
// product), 3xTF32 with a fresh partial per 8-point k-step added in f32
// (bf16: f32 accumulation in the MMA's registers, as the row products; a
// fresh partial there costs the 16 registers that keep the kernel from
// spilling), the points in order; then the split's partial rows, no
// atomics.  128-column tiles spill at two blocks a SM, so the widest is 64.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2) wgrad_kernel(WgradArgs w) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Tile<T, T, false, BN, false, true>;
  const int y = blockIdx.x, z = blockIdx.y;
  const long long p0 = (long long)z * w.split_rows;
  const int kv = (int)min((long long)w.split_rows, w.npoints - p0);
  Acc<C> acc;
  zero<C>(acc);
  {
    const WJob jb = wgrad_job_of(w, y);
    const int t = y - jb.tile0, ntn = (jb.N + BN - 1) / BN;
    const int r0 = (t / ntn) * kRows, n0 = (t % ntn) * BN;
    const ASrc<T> A{static_cast<const T*>(jb.x) + p0 * jb.ldx + r0, jb.ldx, min(kRows, jb.M - r0),
                    kv, nullptr};
    tile_product<T, T, false, BN, false, false, true>(
        acc, smem, A, static_cast<const T*>(jb.b) + p0 * jb.ldb, jb.ldb, kv,
        (kv + C::KP - 1) / C::KP * C::KP, jb.N, n0, nullptr);
  }
  // the split's partial rows; the job's fields read again here (from a fresh
  // blockIdx.y), so that none of them lives across the product in a register
  const int y2 = ctaid_x();
  const WJob jb = wgrad_job_of(w, y2);
  const int t = y2 - jb.tile0, ntn = (jb.N + BN - 1) / BN;
  const int r0 = (t / ntn) * kRows, n0 = (t % ntn) * BN;
  const Frag<C> f;
  const int nrow = min(kRows, jb.M - r0), ncol = min(BN, jb.N - n0);
  float* o = jb.out + z * w.wstride;
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int q = 0; q < C::kNT; ++q) {
      if (8 * f.nt(q) >= ncol) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = f.row(i, e), col = n0 + f.col(q, e);
        if (row >= nrow) continue;
        const int m = r0 + row;
        if (col < jb.wn)
          o[jb.trans ? (long long)col * jb.ld + m : (long long)m * jb.ld + col] = acc[i][q][e];
      }
    }
}

#define CIPS_TRY(x)                          \
  do {                                       \
    const cudaError_t e_ = (x);              \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// The tile width for a layer N wide: every warp busy down to N = 32.
__host__ __device__ constexpr int tile_cols(int N) { return N > 64 ? 128 : N > 32 ? 64 : 32; }

// raise_smem, and the largest shared-memory carveout, so that two blocks of
// up to 113 KB share an SM; set once per (device, kernel): later launches
// make no CUDA call besides themselves.
template <typename K>
cudaError_t prep_kernel(K kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, bool> set;
  cudaError_t err = cips::raise_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<int, const void*> key(dev, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> hold(mu);
  if (set.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) set[key] = true;
  return err;
}

template <typename T, typename TA, bool kTrans, int BN, int kMode>
cudaError_t gemm_bn(const GemmArgs& a, int nz, cudaStream_t stream) {
  constexpr size_t sm = gemm_smem<T, TA, kTrans, BN, kMode>();
  cudaError_t err = prep_kernel(gemm_kernel<T, TA, kTrans, BN, kMode>, sm);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nrows + kRows - 1) / kRows, (a.N + BN - 1) / BN, nz);
  gemm_kernel<T, TA, kTrans, BN, kMode><<<grid, kThreads, sm, stream>>>(a);
  return cudaGetLastError();
}

// One launch over a.nrows rows of each of nz batch rows.  kInr takes the
// widest tile at every N (its ToRGB slab sums are per 128 columns), kDx
// (N = 16) the narrowest.
template <typename T, typename TA, bool kTrans, int kMode>
cudaError_t gemm(const GemmArgs& a, int nz, cudaStream_t stream) {
  if constexpr (kMode == kInr) {
    return gemm_bn<T, TA, kTrans, kSlab, kMode>(a, nz, stream);
  } else if constexpr (kMode == kDx) {   // N = 16: d pts
    return gemm_bn<T, TA, kTrans, 32, kMode>(a, nz, stream);
  } else {
    switch (tile_cols(a.N)) {
      case 128: return gemm_bn<T, TA, kTrans, 128, kMode>(a, nz, stream);
      case 64: return gemm_bn<T, TA, kTrans, 64, kMode>(a, nz, stream);
      default: return gemm_bn<T, TA, kTrans, 32, kMode>(a, nz, stream);
    }
  }
}

// The largest dynamic shared memory of any tile width of one product kind.
template <typename T, typename TA, bool kTrans, int kMode>
constexpr size_t gemm_smem_max() {
  return gemm_smem<T, TA, kTrans, 128, kMode>() > gemm_smem<T, TA, kTrans, 64, kMode>()
             ? gemm_smem<T, TA, kTrans, 128, kMode>()
             : gemm_smem<T, TA, kTrans, 64, kMode>();
}

// The weight grads' launch of one width: grid (every job's tiles, splits).
template <typename T, int BN>
cudaError_t wgrad(const WgradArgs& w, int nsplit, cudaStream_t stream) {
  constexpr size_t sm = Tile<T, T, false, BN, false, true>::kBytes;
  cudaError_t err = prep_kernel(wgrad_kernel<T, BN>, sm);
  if (err != cudaSuccess) return err;
  const WJob& last = w.job[w.njobs - 1];
  const int tiles = last.tile0 + ((last.M + kRows - 1) / kRows) * ((last.N + BN - 1) / BN);
  if (nsplit > 65535) return cudaErrorInvalidValue;
  wgrad_kernel<T, BN><<<dim3(tiles, nsplit), kThreads, sm, stream>>>(w);
  return cudaGetLastError();
}

}  // namespace cips_stream
