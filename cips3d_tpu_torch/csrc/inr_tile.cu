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
//     ordinary f32 add: 0.4x, about 8 % more time (chip_smoke.py, phases 5-6).
// The Pallas kernel keeps all 18 weight matrices in VMEM; here they do not
// fit in the 227 KB of shared memory (18.9 MB in f32), so every block
// streams every layer's weights from L2, which holds all of them (50 MB),
// as one stream of 16-row stages through a cp.async ring.  The first
// version (32-pixel blocks of 8 warps, two activation buffers, two barriers
// per stage) took 5.3 ms at r128 in f32.  In this one the products set the
// pace: skipping them leaves 1.4 of 3.4-3.6 ms (weight feed, A splits,
// barriers, epilogues), skipping the weight feed 2.8 ms (H100,
// cips3d_tpu_torch/bench/inr_tile_variants.py).  Each k-step of 3xTF32 is
// three m16n8k8 products, a fresh partial and four adds a fragment, and its
// B operand split into two TF32 parts.  This design:
//   * 64 pixels (four 16-row MMA tiles) per tile: each weight stage feeds
//     twice the rows, so L2 -> shared traffic and barriers per pixel halve;
//   * one f32 activation buffer, updated in place: the layer's sums stay in
//     registers through the k-loop, then a barrier, then the epilogue writes
//     over the buffer.  A thread owns the same (row, column) fragments in
//     every layer, so the residual of blocks >= 4 goes through a per-block
//     scratch slot in device memory (it stays in L2): before the block's
//     first k-loop each thread saves the block input it owns, after the
//     second epilogue it adds it back;
//   * 16 warps (4 per scheduler), each owning all 64 rows and 32 channels:
//     a B fragment is split once and feeds four row tiles.  The A operand
//     (x * s, rounded or split as the products take it) is made once a
//     block per stage, one or two fragment registers a thread, into a double
//     buffer in shared memory, instead of by every warp; the next stage's is
//     made while this one is multiplied;
//   * a ring of 2 (f32) or 4 (bf16) weight stages with one barrier per
//     stage: wait for the stage, barrier, refill the slot the previous
//     stage used, multiply.  The ring runs across layers and tiles, so the
//     next layer's first stage loads under this one's last.  A layer adds a
//     barrier before its epilogue and one after it;
//   * a persistent grid: min(SMs, tiles) blocks, each walking 64-pixel
//     tiles of every batch row (tile = blockIdx.x + i * gridDim.x).
// The numerics are the first version's: the same k order, fresh partials,
// roundings, epilogue and ToRGB sums, so its f32 results are the same bits.
// Buffers use the strides of D = 512 at every width, padded so that
// fragment loads hit distinct banks.  The first layer reads its true input
// channels (32), unpadded.

#include "common.cuh"

namespace {

constexpr int kPix = 64;               // pixels per tile: four 16-row MMA tiles
constexpr int kWarps = 16;             // warp w: all 64 rows, channels 32w..32w+31
constexpr int kThreads = 32 * kWarps;  // 512
constexpr int kMT = kPix / 16;         // 16-row MMA tiles per warp: the whole tile
constexpr int kColsPerWarp = 512 / kWarps;
constexpr int kNT = kColsPerWarp / 8;  // 8-wide MMA tiles per warp
constexpr int kKTile = 16;             // weight rows per ring stage
constexpr int kMaxD = kWarps * kColsPerWarp;
constexpr int kLda = kMaxD + 4;        // activation row stride (floats), padded off the banks
constexpr int kLdw = kMaxD + 8;        // ring row stride (elements), padded likewise
constexpr int kFirstRgb = 3;
constexpr int kFirstSkip = 4;

// Ring stages: what the shared memory beside the activations holds.
template <typename T> __host__ __device__ constexpr int ring_stages() {
  return sizeof(T) == 4 ? 2 : 4;
}
// A operand of one stage, split once a block: [k-step][row tile][lane][register] words,
// for f32 a TF32 high plane and then a remainder plane.
template <typename T> __host__ __device__ constexpr int a_plane() {
  return (sizeof(T) == 4 ? kKTile / 8 : 1) * kMT * 32 * 4;
}
template <typename T> __host__ __device__ constexpr int a_words() {
  return (sizeof(T) == 4 ? 2 : 1) * a_plane<T>();
}

struct InrArgs {
  const float* x;      // (b, n, in0)
  const float* s;      // (b, 2 * n_blocks, D), layer 0 uses its first in0 entries
  const float* d;      // (b, 2 * n_blocks, D)
  const void* w0;      // (in0, D) mm type
  const void* wrest;   // (2 * n_blocks - 1, D, D) mm type
  const void* wr;      // (n_blocks - 3, D, 3) mm type
  const float* br;     // (n_blocks - 3, 3)
  float* out;          // (b, n, 3)
  float* scratch;      // (gridDim.x, kPix, D): each block's residual slot
  int b, n, in0, D, L;   // L = 2 * n_blocks layers
  int row_tiles, tiles;  // 64-pixel tiles of a batch row, of the call
};

// Shared memory at every width (strides of the widest, D = 512).
struct InrLayout {
  size_t x, ring, afr, sv, dv, rgb, total;
  __host__ __device__ InrLayout(size_t tsize, int stages, int awords) {
    size_t off = 0;
    x = cips::take(off, sizeof(float) * kPix * kLda);            // [pixel][channel]
    ring = cips::take(off, tsize * stages * kKTile * kLdw);      // [stage][k][channel]
    afr = cips::take(off, sizeof(uint32_t) * 2 * awords);        // [stage parity][a_words]
    sv = cips::take(off, sizeof(float) * 2 * kMaxD);             // [layer parity][channel]
    dv = cips::take(off, sizeof(float) * kMaxD);
    rgb = cips::take(off, sizeof(float) * kPix * 4);
    total = off;
  }
  template <typename T> __host__ __device__ static InrLayout make() {
    return InrLayout(sizeof(T), ring_stages<T>(), a_words<T>());
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The A operand of the stage at k0 of this layer, (x * s) rounded as the
// products take it, once a block into `dst` (a_words): 512 jobs over the
// threads, each two of the 1024 f32 fragment registers (a TF32 high part and
// remainder each) or one of the 512 bf16 ones; fragment layouts as in
// common.cuh, g = lane / 4 and t = lane % 4.
constexpr int kAJobs = 512;
__device__ __forceinline__ void split_a(uint32_t* dst, const float* x, const float* s, int k0,
                                        float) {
  static_assert(kAJobs == (kKTile / 8) * kMT * 32 * 2, "two f32 registers a job");
  for (int i = threadIdx.x; i < kAJobs; i += kThreads) {
    const int q = i & 1, lane = (i >> 1) & 31, m = (i >> 6) & (kMT - 1), ks = i >> 8;
    const int g = lane >> 2, t = lane & 3;
    const int k = k0 + 8 * ks + t + 4 * q;   // registers 2q (row g) and 2q + 1 (row g + 8)
    const float* r = x + (16 * m + g) * kLda + k;
    uint32_t hi0, lo0, hi1, lo1;
    cips::split_tf32(r[0] * s[k], hi0, lo0);
    cips::split_tf32(r[8 * kLda] * s[k], hi1, lo1);
    uint32_t* o = dst + ((ks * kMT + m) * 32 + lane) * 4 + 2 * q;
    *reinterpret_cast<uint2*>(o) = make_uint2(hi0, hi1);
    *reinterpret_cast<uint2*>(o + a_plane<float>()) = make_uint2(lo0, lo1);
  }
}

__device__ __forceinline__ void split_a(uint32_t* dst, const float* x, const float* s, int k0,
                                        __nv_bfloat16) {
  static_assert(kAJobs == kMT * 32 * 4, "one bf16 register a job");
  for (int i = threadIdx.x; i < kAJobs; i += kThreads) {
    const int reg = i & 3, lane = (i >> 2) & 31, m = i >> 7;
    const int g = lane >> 2, t = lane & 3;
    const int k = k0 + 2 * t + 8 * (reg >> 1);
    const float* r = x + (16 * m + g + 8 * (reg & 1)) * kLda + k;
    dst[(m * 32 + lane) * 4 + reg] = cips::pack_bf16(r[0] * s[k], r[1] * s[k + 1]);
  }
}

// acc[mt][nt] += A[rows of mt, k-steps of the stage] @ W[stage, 8 columns of nt];
// a: the stage's split A, w: the stage's ring slot at the warp's first
// column, lane's row t.  Each B fragment is split once and feeds the four
// row tiles; A is read per row tile.
__device__ __forceinline__ void tile_mma(float acc[kMT][kNT][4], const uint32_t* a,
                                         const float* w, int lane) {
#pragma unroll
  for (int ks = 0; ks < kKTile / 8; ++ks) {
    uint32_t bhi[kNT][2], blo[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* wc = w + 8 * ks * kLdw + 8 * nt;
      cips::split_tf32(wc[0], bhi[nt][0], blo[nt][0]);
      cips::split_tf32(wc[4 * kLdw], bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const uint32_t* p = a + ((ks * kMT + mt) * 32 + lane) * 4;
      const uint4 h = *reinterpret_cast<const uint4*>(p);
      const uint4 l = *reinterpret_cast<const uint4*>(p + a_plane<float>());
      const uint32_t ahi[4] = {h.x, h.y, h.z, h.w}, alo[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // a fresh partial per k-step, added to the accumulator in f32 (see the header)
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        cips::mma_3xtf32(part, ahi, alo, bhi[nt], blo[nt]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[j];
      }
    }
  }
}

// w: the ring slot at the warp's first column, lane's rows 2t.
__device__ __forceinline__ void tile_mma(float acc[kMT][kNT][4], const uint32_t* a,
                                         const __nv_bfloat16* w, int lane) {
  static_assert(kKTile == 16, "one m16n8k16 k-step per stage");
  uint32_t b[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const __nv_bfloat16* wc = w + 8 * nt;
    b[nt][0] = cips::pack_bits(wc[0], wc[kLdw]);
    b[nt][1] = cips::pack_bits(wc[8 * kLdw], wc[9 * kLdw]);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + (mt * 32 + lane) * 4);
    const uint32_t af[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) cips::mma_bf16(acc[mt][nt], af, b[nt]);
  }
}

// f(row, column) for the first of each pair of accumulator elements a
// thread owns: rows 16 mt + g (+ 8), columns c0 + 8 nt + 2t (+ 1).
template <typename F>
__device__ __forceinline__ void own_fragments(int c0, int g, int t, F f) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) f(16 * mt + g + 8 * h, c0 + 8 * nt + 2 * t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) inr_tile_kernel(InrArgs a) {
  constexpr int kStages = ring_stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const InrLayout lay = InrLayout::make<T>();
  float* x = reinterpret_cast<float*>(smem + lay.x);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  uint32_t* afr = reinterpret_cast<uint32_t*>(smem + lay.afr);
  float* sv = reinterpret_cast<float*>(smem + lay.sv);
  float* dv = reinterpret_cast<float*>(smem + lay.dv);
  float* rgb = reinterpret_cast<float*>(smem + lay.rgb);

  // the arguments stay in the constant bank, not in registers, as far as may be
  const int D = a.D, in0 = a.in0, n = a.n, L = a.L, row_tiles = a.row_tiles, tiles = a.tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * kColsPerWarp;   // the warp's channels, in every layer
  const bool active = c0 < D;           // D < 512 leaves some warps without channels
  auto layer_k = [&](int layer) { return layer == 0 ? in0 : D; };
  // the block inputs of this block's tile, each element saved and read back by its
  // only writer: the thread that owns its (row, column) fragment in every layer
  float* slot = a.scratch + (size_t)blockIdx.x * kPix * D;

  // The ring: one stream of 16-row weight stages over every layer of every
  // tile this block walks.  issue() loads the stage `ahead` stages after
  // (tile, layer, k0) into ring slot `slot`, or nothing past the stream's
  // end; it always commits a group, so the wait below counts alike at every
  // stage.
  auto issue = [&](int tile, int layer, int k0, int ahead, int slot) {
    k0 += ahead * kKTile;
    while (k0 >= layer_k(layer)) {
      k0 -= layer_k(layer);
      if (++layer == L) { layer = 0; tile += gridDim.x; }
    }
    if (tile < tiles) {
      const T* W = (layer == 0 ? static_cast<const T*>(a.w0)
                               : static_cast<const T*>(a.wrest) + (size_t)(layer - 1) * D * D) +
                   (size_t)k0 * D;
      T* dst = ring + (size_t)slot * kKTile * kLdw;
      const int per_row = D * (int)sizeof(T) / 16;
      for (int i = threadIdx.x; i < kKTile * per_row; i += kThreads) {
        const int r = i / per_row, cc = i % per_row;
        cp_async16(reinterpret_cast<char*>(dst + r * kLdw) + 16 * cc,
                   reinterpret_cast<const char*>(W + (size_t)r * D) + 16 * cc);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(blockIdx.x, 0, 0, i, i);
  unsigned j = 0;   // ring stages consumed by this block

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bi = tile / row_tiles, p0 = (tile % row_tiles) * kPix;
    __syncthreads();   // the previous tile's ToRGB and output are done with x and rgb
    for (int i = threadIdx.x; i < kPix * in0; i += kThreads) {
      const int row = i / in0, c = i % in0, p = p0 + row;
      x[row * kLda + c] = p < n ? a.x[((size_t)bi * n + p) * in0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < in0; i += kThreads) sv[i] = a.s[(size_t)bi * L * D + i];
    for (int i = threadIdx.x; i < kPix * 4; i += kThreads) rgb[i] = 0.f;
    __syncthreads();
    split_a(afr, x, sv, 0, T());

    for (int layer = 0; layer < L; ++layer) {
      const int blk = layer / 2, stage = layer % 2;
      const int K = layer_k(layer);
      const float* s_l = sv + (layer & 1) * kMaxD;
      // this layer's demod, and the next layer's s for its first split after this epilogue
      for (int i = threadIdx.x; i < D; i += kThreads) {
        dv[i] = a.d[((size_t)bi * L + layer) * D + i];
        if (layer + 1 < L) sv[((layer + 1) & 1) * kMaxD + i] = a.s[((size_t)bi * L + layer + 1) * D + i];
      }

      if (active && stage == 0 && blk >= kFirstSkip)   // the block input, for its residual
        own_fragments(c0, g, t, [&](int row, int col) {
          const float* o = x + row * kLda + col;
          *reinterpret_cast<float2*>(slot + (size_t)row * D + col) = make_float2(o[0], o[1]);
        });

      float acc[kMT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

      for (int k0 = 0; k0 < K; k0 += kKTile, ++j) {
        cp_async_wait<kStages - 2>();
        // stage j and its split A visible to every thread; every warp is past stage j - 1
        __syncthreads();
        issue(tile, layer, k0, kStages - 1, (j + kStages - 1) % kStages);   // into j - 1's slot
        const int kk = k0 / kKTile;
        if (k0 + kKTile < K) split_a(afr + ((kk + 1) & 1) * a_words<T>(), x, s_l, k0 + kKTile, T());
        const T* w = ring + (j % kStages) * kKTile * kLdw + t * (sizeof(T) == 4 ? 1 : 2) * kLdw + c0 + g;
        if (active) tile_mma(acc, afr + (kk & 1) * a_words<T>(), w, lane);
      }
      __syncthreads();   // every warp is done reading x before the epilogue writes over it

      if (active) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = c0 + 8 * nt + 2 * t;
              float* o = x + (16 * mt + g + 8 * h) * kLda + col;
              const float v0 = acc[mt][nt][2 * h] * dv[col];
              const float v1 = acc[mt][nt][2 * h + 1] * dv[col + 1];
              o[0] = v0 > 0.f ? v0 : 0.2f * v0;
              o[1] = v1 > 0.f ? v1 : 0.2f * v1;
            }
        if (stage == 1 && blk >= kFirstSkip) {
          // the fence keeps the residual's loads out of the epilogue, where the
          // sums still hold their registers
          __syncwarp();
          own_fragments(c0, g, t, [&](int row, int col) {
            float* o = x + row * kLda + col;
            const float2 in = *reinterpret_cast<const float2*>(slot + (size_t)row * D + col);
            o[0] += in.x;
            o[1] += in.y;
          });
        }
      }
      __syncthreads();   // the layer's output visible to ToRGB and the next split

      if (stage == 1 && blk >= kFirstRgb) {   // ToRGB skip accumulation on the block output
        const int r = blk - kFirstRgb;
        const T* wr = static_cast<const T*>(a.wr) + (size_t)r * D * 3;
        for (int i = 0; i < kPix / kWarps; ++i) {
          const int row = warp * (kPix / kWarps) + i;
          float s0 = 0.f, s1 = 0.f, s2 = 0.f;
          for (int c = lane; c < D; c += 32) {
            const float xv = cips::round_mm<T>(x[row * kLda + c]);
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
      if (layer + 1 < L) split_a(afr, x, sv + ((layer + 1) & 1) * kMaxD, 0, T());
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPix * 3; i += kThreads) {
      const int row = i / 3, ch = i % 3, p = p0 + row;
      if (p < n) a.out[((size_t)bi * n + p) * 3 + ch] = tanhf(rgb[row * 4 + ch]);
    }
  }
  cp_async_wait<0>();   // only empty groups are left
}

template <typename T>
int launch(const InrArgs& a, int grid, cudaStream_t stream) {
  const InrLayout lay = InrLayout::make<T>();
  const cudaError_t err = cips::raise_smem(inr_tile_kernel<T>, lay.total);
  if (err != cudaSuccess) return (int)err;
  inr_tile_kernel<T><<<grid, kThreads, lay.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes as in InrArgs; mm_bf16 selects the matmul-input type of w0, wrest
// and wr; grid blocks (at most the tiles) walk the 64-pixel tiles, and
// scratch holds grid * 64 * D floats.  The wrapper zero-pads D to a
// multiple of 64 (D <= 512) and in0 to a multiple of 16 (in0 <= D).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int cips_inr_tile_forward(
    const void* x, const void* s, const void* d, const void* w0, const void* wrest,
    const void* wr, const void* br, void* out, void* scratch,
    int b, int n, int in0, int D, int n_blocks, int mm_bf16, int grid, void* stream) {
  InrArgs a;
  a.x = static_cast<const float*>(x);
  a.s = static_cast<const float*>(s);
  a.d = static_cast<const float*>(d);
  a.w0 = w0;
  a.wrest = wrest;
  a.wr = wr;
  a.br = static_cast<const float*>(br);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.b = b; a.n = n; a.in0 = in0; a.D = D; a.L = 2 * n_blocks;
  a.row_tiles = (n + kPix - 1) / kPix;
  a.tiles = b * a.row_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mm_bf16 ? launch<__nv_bfloat16>(a, grid, st) : launch<float>(a, grid, st);
}

// Pixels per tile (the wrapper's TILE_PIXELS).
extern "C" int cips_inr_tile_pixels() { return kPix; }

// Resident warps per SM, dynamic shared memory and threads of the kernel at
// width D (out[0..2]).
extern "C" int cips_inr_tile_occupancy(int D, int mm_bf16, int* out) {
  return mm_bf16 ? cips::occupancy(inr_tile_kernel<__nv_bfloat16>, kThreads,
                                   InrLayout::make<__nv_bfloat16>().total, out)
                 : cips::occupancy(inr_tile_kernel<float>, kThreads,
                                   InrLayout::make<float>().total, out);
}

// Dynamic shared memory (bytes) of the resident kernel, the same at every D
// up to 512.
extern "C" long long cips_inr_tile_smem(int mm_bf16) {
  return (long long)(mm_bf16 ? InrLayout::make<__nv_bfloat16>().total
                             : InrLayout::make<float>().total);
}
