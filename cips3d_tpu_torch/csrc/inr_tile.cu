// Fused CIPS-INR decoder: the forward of CIPSNet for pre_rgb_dim = 3.
//
// Replaces: cips3d_tpu/ops/pallas/inr_tile.py::_inr_tile_kernel (entry
// fused_inr_decode).  Per pixel, n_blocks SinBlocks of two modulated FCs
//     x = lrelu_0.2(demod * ((x * s) @ W))
// with s and demod per (batch, layer) vectors computed outside, a residual
// from the block input for blocks >= 4, ToRGB accumulation (with bias) from
// block 3, then tanh.  Matmul inputs are rounded to the mm type (f32 or
// bf16) where the Pallas kernel casts them; accumulation and everything
// between products is f32.
//
// What bounds it on an H100: the chain is 18 matmuls of D x D (D = 512), so
// 2 * 18 * 512^2 = 9.4 MFLOP per pixel and ~150 GFLOP for a 128x128 frame:
// far too much for the f32 FMA units (67 TFLOP/s; an FMA version of this
// kernel ran at a quarter of that), so the products run on the tensor
// cores with warp-level mma.sync:
//   * bf16 inputs: m16n8k16 on exactly the bf16-rounded values the Pallas
//     kernel multiplies, f32 accumulation;
//   * f32 inputs: 3xTF32, m16n8k8 on each operand split into a TF32 high
//     part and a TF32 remainder (hi*hi + hi*lo + lo*hi).  The tensor core
//     does not round its additions as IEEE f32 does, so a 512-deep dot kept
//     in the MMA's own C register drifts: on the D phase's noisy features
//     (r64, b = 4, H100) that version was 10.9x further from a float64
//     decode than the f32 plain version.  So each k-step's three products
//     go into a fresh zero partial, added to the accumulator with an
//     ordinary f32 add: 0.4x, about 8 % slower (chip_smoke.py, phases 5-6).
// The Pallas kernel keeps all 18 weight matrices in VMEM; here they do not
// fit in the 227 KB of shared memory (18.9 MB in f32), so each block
// streams every layer's weights from L2, which holds all of them (50 MB),
// as one stream of 16-row tiles double-buffered with cp.async: the next tile
// (of this layer or the next) loads while the current one is multiplied.
// A tile of 32 pixels (two 16-row MMA tiles) keeps its activations in
// shared memory through the whole chain, f32, in two buffers: block input
// (which is also the residual) and the first stage's output; the second
// stage writes back over the block input, each thread reading its own
// residual elements first.  Each of the 8 warps owns 64 output channels.
// Rows of both buffers are padded so fragment loads hit distinct banks.
// The first layer reads its true input channels (32), unpadded.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 32;               // pixels per block: two 16-row MMA tiles
constexpr int kMT = kPix / 16;
constexpr int kColsPerWarp = 64;       // warp w owns channels 64w..64w+63
constexpr int kNT = kColsPerWarp / 8;  // eight 8-wide MMA tiles
constexpr int kKTile = 16;             // weight rows per shared-memory tile
constexpr int kActPad = 4;             // activation row padding (floats)
constexpr int kWPad = 8;               // weight row padding (elements)
constexpr int kFirstRgb = 3;
constexpr int kFirstSkip = 4;

struct InrArgs {
  const float* x;      // (b, n, in0)
  const float* s;      // (b, 2 * n_blocks, D), layer 0 uses its first in0 entries
  const float* d;      // (b, 2 * n_blocks, D)
  const void* w0;      // (in0, D) mm type
  const void* wrest;   // (2 * n_blocks - 1, D, D) mm type
  const void* wr;      // (n_blocks - 3, D, 3) mm type
  const float* br;     // (n_blocks - 3, 3)
  float* out;          // (b, n, 3)
  int b, n, in0, D, n_blocks;
};

struct InrLayout {
  size_t xa, xb, wt0, wt1, sv, dv, rgb, total;
  int lda, ldw;   // row strides of the activation and weight-tile buffers
  __host__ __device__ InrLayout(int D, size_t tsize) {
    lda = D + kActPad;
    ldw = D + kWPad;
    size_t off = 0;
    xa = take(off, sizeof(float) * kPix * lda);      // [pixel][channel]
    xb = take(off, sizeof(float) * kPix * lda);
    wt0 = take(off, tsize * kKTile * ldw);           // [k][channel]
    wt1 = take(off, tsize * kKTile * ldw);
    sv = take(off, sizeof(float) * D);
    dv = take(off, sizeof(float) * D);
    rgb = take(off, sizeof(float) * kPix * 4);
    total = off;
  }
  __host__ __device__ static size_t take(size_t& off, size_t bytes) {
    const size_t o = off;
    off += cips::align16(bytes);
    return o;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// acc[mt][nt] += (x * s)[rows of mt, k-step] @ W[k-step, 8 columns of nt]
// for the k-step(s) of one 16-row weight tile; g = lane / 4, t = lane % 4
// index the fragments (common.cuh).
__device__ __forceinline__ void tile_mma(float acc[kMT][kNT][4], const float* x, int lda,
                                         const float* s, int k0, const float* w, int ldw,
                                         int c0, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < kKTile; kb += 8) {
    const int k = k0 + kb;
    uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* r0 = x + (16 * mt + g) * lda + k;
      const float* r1 = r0 + 8 * lda;
      cips::split_tf32(r0[t] * s[k + t], ahi[mt][0], alo[mt][0]);
      cips::split_tf32(r1[t] * s[k + t], ahi[mt][1], alo[mt][1]);
      cips::split_tf32(r0[t + 4] * s[k + t + 4], ahi[mt][2], alo[mt][2]);
      cips::split_tf32(r1[t + 4] * s[k + t + 4], ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* wc = w + kb * ldw + c0 + 8 * nt + g;
      uint32_t bhi[2], blo[2];
      cips::split_tf32(wc[t * ldw], bhi[0], blo[0]);
      cips::split_tf32(wc[(t + 4) * ldw], bhi[1], blo[1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // a fresh partial per k-step, added to the accumulator in f32 (see the header)
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        cips::mma_3xtf32(part, ahi[mt], alo[mt], bhi, blo);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[j];
      }
    }
  }
}

__device__ __forceinline__ void tile_mma(float acc[kMT][kNT][4], const float* x, int lda,
                                         const float* s, int k0, const __nv_bfloat16* w, int ldw,
                                         int c0, int g, int t) {
  static_assert(kKTile == 16, "one m16n8k16 k-step per tile");
  const int k = k0 + 2 * t;
  uint32_t a[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const float* r0 = x + (16 * mt + g) * lda + k;
    const float* r1 = r0 + 8 * lda;
    a[mt][0] = cips::pack_bf16(r0[0] * s[k], r0[1] * s[k + 1]);
    a[mt][1] = cips::pack_bf16(r1[0] * s[k], r1[1] * s[k + 1]);
    a[mt][2] = cips::pack_bf16(r0[8] * s[k + 8], r0[9] * s[k + 9]);
    a[mt][3] = cips::pack_bf16(r1[8] * s[k + 8], r1[9] * s[k + 9]);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const __nv_bfloat16* wc = w + 2 * t * ldw + c0 + 8 * nt + g;
    const uint32_t b[2] = {cips::pack_bits(wc[0], wc[ldw]), cips::pack_bits(wc[8 * ldw], wc[9 * ldw])};
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) cips::mma_bf16(acc[mt][nt], a[mt], b);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) inr_tile_kernel(InrArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const InrLayout lay(a.D, sizeof(T));
  float* xa = reinterpret_cast<float*>(smem + lay.xa);
  float* xb = reinterpret_cast<float*>(smem + lay.xb);
  T* const tiles[2] = {reinterpret_cast<T*>(smem + lay.wt0), reinterpret_cast<T*>(smem + lay.wt1)};
  float* sv = reinterpret_cast<float*>(smem + lay.sv);
  float* dv = reinterpret_cast<float*>(smem + lay.dv);
  float* rgb = reinterpret_cast<float*>(smem + lay.rgb);

  const int D = a.D, in0 = a.in0, n = a.n, L = 2 * a.n_blocks;
  const int lda = lay.lda, ldw = lay.ldw;
  const int bi = blockIdx.y, p0 = blockIdx.x * kPix;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * kColsPerWarp;
  const bool active = c0 < D;   // D < 512 leaves the last warps without channels
  const T* w0 = static_cast<const T*>(a.w0);
  const T* wrest = static_cast<const T*>(a.wrest);

  // One stream of weight tiles over all layers: (layer, k0) -> padded shared rows.
  auto layer_k = [&](int layer) { return layer == 0 ? in0 : D; };
  auto issue = [&](int layer, int k0, T* dst) {
    const T* W = (layer == 0 ? w0 : wrest + (size_t)(layer - 1) * D * D) + (size_t)k0 * D;
    const int per_row = D * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < kKTile * per_row; i += kThreads) {
      const int r = i / per_row, cc = i % per_row;
      cp_async16(reinterpret_cast<char*>(dst + r * ldw) + 16 * cc,
                 reinterpret_cast<const char*>(W + (size_t)r * D) + 16 * cc);
    }
    cp_async_commit();
  };
  issue(0, 0, tiles[0]);
  int next_layer = 0, next_k0 = 0, buf = 0;

  for (int i = threadIdx.x; i < kPix * in0; i += kThreads) {
    const int row = i / in0, c = i % in0, p = p0 + row;
    xa[row * lda + c] = p < n ? a.x[((size_t)bi * n + p) * in0 + c] : 0.f;
  }
  for (int i = threadIdx.x; i < kPix * 4; i += kThreads) rgb[i] = 0.f;

  for (int layer = 0; layer < L; ++layer) {
    const int blk = layer / 2, stage = layer % 2;
    const int K = layer_k(layer);
    const float* in = stage == 0 ? xa : xb;
    float* out = stage == 0 ? xb : xa;
    __syncthreads();   // the previous layer's epilogue and ToRGB are done with sv, dv
    for (int i = threadIdx.x; i < D; i += kThreads) {
      sv[i] = i < K ? a.s[((size_t)bi * L + layer) * D + i] : 0.f;
      dv[i] = a.d[((size_t)bi * L + layer) * D + i];
    }

    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kKTile) {
      next_k0 += kKTile;   // prefetch the stream's next tile into the other buffer
      if (next_k0 >= layer_k(next_layer)) { ++next_layer; next_k0 = 0; }
      if (next_layer < L) {
        issue(next_layer, next_k0, tiles[buf ^ 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // tile `buf`, sv and dv visible to every thread
      if (active) tile_mma(acc, in, lda, sv, k0, tiles[buf], ldw, c0, g, t);
      __syncthreads();   // every warp is done with tile `buf` before it is refilled
      buf ^= 1;
    }

    if (active) {
      const bool residual = stage == 1 && blk >= kFirstSkip;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = 16 * mt + g + 8 * (j >> 1);
            const int col = c0 + 8 * nt + 2 * t + (j & 1);
            const float v = acc[mt][nt][j] * dv[col];
            float* o = out + row * lda + col;
            const float lv = v > 0.f ? v : 0.2f * v;
            *o = residual ? lv + *o : lv;   // the block input, read by its only writer
          }
    }

    if (stage == 1 && blk >= kFirstRgb) {   // ToRGB skip accumulation on the block output (xa)
      __syncthreads();
      const int r = blk - kFirstRgb;
      const T* wr = static_cast<const T*>(a.wr) + (size_t)r * D * 3;
      for (int i = 0; i < kPix / kWarps; ++i) {
        const int row = warp * (kPix / kWarps) + i;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < D; c += 32) {
          const float xv = cips::round_mm<T>(xa[row * lda + c]);
          s0 = fmaf(xv, cips::to_f(wr[c * 3 + 0]), s0);
          s1 = fmaf(xv, cips::to_f(wr[c * 3 + 1]), s1);
          s2 = fmaf(xv, cips::to_f(wr[c * 3 + 2]), s2);
        }
        s0 = cips::warp_sum(s0);
        s1 = cips::warp_sum(s1);
        s2 = cips::warp_sum(s2);
        if (lane == 0) {
          rgb[row * 4 + 0] += s0 + a.br[r * 3 + 0];
          rgb[row * 4 + 1] += s1 + a.br[r * 3 + 1];
          rgb[row * 4 + 2] += s2 + a.br[r * 3 + 2];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPix * 3; i += kThreads) {
    const int row = i / 3, ch = i % 3, p = p0 + row;
    if (p < n) a.out[((size_t)bi * n + p) * 3 + ch] = tanhf(rgb[row * 4 + ch]);
  }
}

template <typename T>
int launch(const InrArgs& a, cudaStream_t stream) {
  const InrLayout lay(a.D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(inr_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kPix - 1) / kPix, a.b);
  inr_tile_kernel<T><<<grid, kThreads, lay.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes as in InrArgs; mm_bf16 selects the matmul-input type of w0, wrest
// and wr.  The wrapper checks D % 64 == 0, D <= 512, in0 % 16 == 0 and
// in0 <= D.  Returns the CUDA error of the launch (0 on success).
extern "C" int cips_inr_tile_forward(
    const void* x, const void* s, const void* d, const void* w0, const void* wrest,
    const void* wr, const void* br, void* out,
    int b, int n, int in0, int D, int n_blocks, int mm_bf16, void* stream) {
  InrArgs a;
  a.x = static_cast<const float*>(x);
  a.s = static_cast<const float*>(s);
  a.d = static_cast<const float*>(d);
  a.w0 = w0;
  a.wrest = wrest;
  a.wr = wr;
  a.br = static_cast<const float*>(br);
  a.out = static_cast<float*>(out);
  a.b = b; a.n = n; a.in0 = in0; a.D = D; a.n_blocks = n_blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mm_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
