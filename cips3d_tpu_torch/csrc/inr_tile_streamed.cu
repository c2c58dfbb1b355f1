// The streamed path of the INR tile (#1): every width the Pallas kernel
// takes, where the resident kernel (inr_tile.cu, activations of 64 pixels x
// D in shared memory, 16 warps x 32 channels) stops at D = 512.
//
// Replaces, for D past 512: cips3d_tpu/ops/pallas/inr_tile.py::
// _inr_tile_kernel (entry fused_inr_decode).  The activations live in device
// memory, two (b, n, D) f32 planes: each of the 2 n_blocks modulated FCs is
// one tensor-core product (stream_gemm.cuh, kInr: 128 pixels x 128 channels
// a tile, A = x * s split or rounded once a block as the products take it,
// W split once a layer by presplit_w into a scratch every tile reads), its
// epilogue lrelu_0.2(acc * demod) plus, for blocks >= 4, the block input
// (the plane it overwrites, read by the thread that writes it).
//
// What bounds it on an H100: the 18 products (2 x 18 x D^2 FLOP a pixel,
// 146.9 GFLOP at D = 1024 over 4096 pixels) on the tensor cores, as 3xTF32
// in f32; the planes (16 MB each at D = 1024, r64) stay in L2.  The first
// version ran each product at a quarter of the resident kernel's rate (one
// 16-row tile a warp) and read the D-wide plane once more for each ToRGB (a
// warp a pixel); stream_gemm.cuh's notes say what its product does now.
// The ToRGB of blocks >= 3 is folded into the second product's epilogue of
// its block: each thread dots its rounded outputs with the ToRGB weights,
// the sums reduce over the lanes of a row and the warps of the tile in a
// fixed order into one partial a 128-column slab (no atomics), and one
// last kernel (rgb_out) adds the slabs in order, each ToRGB's bias and the
// running rgb in block order, then the tanh; the last plane is not written.
// The products, roundings and epilogues are the resident kernel's in the
// same k order, but that the bf16 products too go into a fresh partial per
// k-step (a 1024-deep dot kept in the MMA's register drifts, as the f32 ones
// did in the resident kernel's first version); the ToRGB dots sum in
// another order (within the f32 tolerance).  Shared memory is the same at
// every D.
#include "stream_gemm.cuh"

namespace {

using cips_stream::GemmArgs;
using cips_stream::Mat;
using cips_stream::Vec;

constexpr int kFirstRgb = 3;
constexpr int kFirstSkip = 4;

// out = tanh of the ToRGB sums: for each ToRGB in order, its slab sums in
// order plus its bias, added to the running rgb (the first to 0).  A thread
// a pixel and channel.
__global__ void rgb_out(const float* rgbp, const float* br, float* out, long long pixels,
                        int nslab, int nrgb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pixels * 3) return;
  const long long p = i / 3;
  const int ch = (int)(i % 3);
  float v = 0.f;
  for (int r = 0; r < nrgb; ++r) {
    const float* q = rgbp + ((long long)r * pixels + p) * nslab * 3 + ch;
    float s = 0.f;
    for (int sl = 0; sl < nslab; ++sl) s += q[sl * 3];
    v = v + (s + br[r * 3 + ch]);
  }
  out[i] = tanhf(v);
}

// The bytes of presplit_w's output for a K x N layer (the widest tile).
template <typename T>
size_t wsplit_bytes(int K, int N) {
  using C = cips_stream::Tile<T, float, false, cips_stream::kSlab, true>;
  return (size_t)((K + C::KP - 1) / C::KP) * ((N + cips_stream::kSlab - 1) / cips_stream::kSlab) *
         C::kSplitB;
}

template <typename T>
int stream_decode(const float* x, const float* s, const float* d, const T* w0, const T* wrest,
                  const T* wr, const float* br, float* out, float* x0, float* x1, float* rgbp,
                  void* wsplit, int b, int n, int in0, int D, int n_blocks, cudaStream_t st) {
  using namespace cips_stream;
  const int L = 2 * n_blocks, nslab = (D + kSlab - 1) / kSlab, nrgb = n_blocks - kFirstRgb;
  const long long pixels = (long long)b * n;
  for (int layer = 0; layer < L; ++layer) {
    const int blk = layer / 2, stage = layer % 2;
    GemmArgs g = {};
    // stage 0 reads the block input (x for block 0) into x1; stage 1 reads x1 into x0
    const float* in = stage ? x1 : layer == 0 ? x : x0;
    const int K = layer == 0 ? in0 : D;
    g.a = Mat{const_cast<float*>(in), n, 0, K, 0};
    g.akvalid = K;
    // the layer's weights split once into wsplit, which its product reads from every row tile
    const T* w = layer == 0 ? w0 : wrest + (long long)(layer - 1) * D * D;
    constexpr int KP = Tile<T, float, false, kSlab, true>::KP;
    presplit_w<T, kSlab><<<dim3((K + KP - 1) / KP, (D + kSlab - 1) / kSlab), kThreads, 0, st>>>(
        w, D, K, K, D, static_cast<uint4*>(wsplit));
    CIPS_TRY(cudaGetLastError());
    g.w = wsplit;
    g.ldw = D;
    g.wvalid = K;
    g.nrows = n;
    g.K = K;
    g.N = D;
    g.out = Mat{stage ? x0 : x1, n, 0, D, 0};
    if (stage == 1 && blk >= kFirstSkip) g.resid = g.out;   // the block input, read, then written
    if (stage == 1 && blk >= kFirstRgb) {   // ToRGB in the epilogue
      const int r = blk - kFirstRgb;
      g.wr = wr + (long long)r * D * 3;
      g.rgbp = rgbp + (long long)r * pixels * nslab * 3;
      if (blk == n_blocks - 1) g.out.p = nullptr;   // nothing reads the last plane
    }
    g.scale = Vec{s + (long long)layer * D, L * D};
    g.demod = Vec{d + (long long)layer * D, L * D};
    CIPS_TRY((gemm<T, float, false, kInr>(g, b, st)));
  }
  rgb_out<<<(unsigned)((pixels * 3 + 255) / 256), 256, 0, st>>>(rgbp, br, out, pixels, nslab, nrgb);
  return (int)cudaGetLastError();
}

}  // namespace

// The streamed decode: shapes as cips_inr_tile_forward's, any D (a multiple
// of 16) and in0 <= D (a multiple of 16); x0, x1 (b, n, D) and rgb
// (n_blocks - 3, b, n, nslab, 3) f32 scratch, nslab = ceil(D / cips_stream_tile(1));
// wsplit: cips_inr_tile_streamed_wsplit(D, mm_bf16) bytes of scratch for a
// layer's split weights.  Returns the CUDA error of the launches (0 on success).
extern "C" int cips_inr_tile_forward_streamed(
    const void* x, const void* s, const void* d, const void* w0, const void* wrest,
    const void* wr, const void* br, void* out, void* x0, void* x1, void* rgb, void* wsplit,
    int b, int n, int in0, int D, int n_blocks, int mm_bf16, void* stream) {
  if (n_blocks <= kFirstRgb || in0 > D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [&](auto t) {
    using T = decltype(t);
    return stream_decode<T>(static_cast<const float*>(x), static_cast<const float*>(s),
                            static_cast<const float*>(d), static_cast<const T*>(w0),
                            static_cast<const T*>(wrest), static_cast<const T*>(wr),
                            static_cast<const float*>(br), static_cast<float*>(out),
                            static_cast<float*>(x0), static_cast<float*>(x1),
                            static_cast<float*>(rgb), wsplit, b, n, in0, D, n_blocks, st);
  };
  return mm_bf16 ? f(__nv_bfloat16()) : f(0.f);
}

// The dynamic shared memory of the streamed decode's product (bytes), the
// same at every D.
extern "C" int cips_inr_tile_streamed_smem(int mm_bf16) {
  using namespace cips_stream;
  return mm_bf16 ? (int)gemm_smem<__nv_bfloat16, float, false, kSlab, kInr>()
                 : (int)gemm_smem<float, float, false, kSlab, kInr>();
}

// The bytes of the streamed decode's split-weight scratch at width D (one
// D x D layer, split as its products read it).
extern "C" long long cips_inr_tile_streamed_wsplit(int D, int mm_bf16) {
  return (long long)(mm_bf16 ? wsplit_bytes<__nv_bfloat16>(D, D) : wsplit_bytes<float>(D, D));
}
