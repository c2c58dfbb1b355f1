// The streamed path of the INR tile (#1): every width the Pallas kernel
// takes, where the resident kernel (inr_tile.cu, activations of 64 pixels x
// D in shared memory, 16 warps x 32 channels) stops at D = 512.
//
// Replaces, for D past 512: cips3d_tpu/ops/pallas/inr_tile.py::
// _inr_tile_kernel (entry fused_inr_decode).  The activations live in device
// memory, two (b, n, D) f32 planes: each of the 2 n_blocks modulated FCs is
// one tensor-core product (stream_gemm.cuh, kInr: 64 pixels x 128 channels a
// block, W in 32-deep k-panels through a cp.async ring, A = x * s rounded as
// the products take it), its epilogue lrelu_0.2(acc * demod) plus, for
// blocks >= 4, the block input (the plane it overwrites, read by the thread
// that writes it); then the ToRGB of blocks >= 3 a warp a pixel, the last
// one with the tanh.  The products, roundings, epilogues and ToRGB sums are
// the resident kernel's, in the same order, but that the bf16 products too
// go into a fresh partial per k-step (a 1024-deep dot kept in the MMA's
// register drifts, as the f32 ones did in the resident kernel's first
// version).  Shared memory is the same at every D.
#include "stream_gemm.cuh"

namespace {

using cips_stream::GemmArgs;
using cips_stream::Mat;
using cips_stream::Vec;

constexpr int kFirstRgb = 3;
constexpr int kFirstSkip = 4;
constexpr int kRgbWarps = 8;

// rgb[p] += round(x[p]) . wr + br (the first ToRGB starts from 0); the last
// writes tanh(rgb) to out.  A warp a pixel, lane c taking c, c + 32, ...
template <typename T>
__global__ void __launch_bounds__(32 * kRgbWarps) to_rgb(const float* x, const T* wr,
                                                         const float* br, float* rgb, float* out,
                                                         long long pixels, int D, int first,
                                                         int last) {
  const long long p = (long long)blockIdx.x * kRgbWarps + (threadIdx.x >> 5);
  if (p >= pixels) return;
  const int lane = threadIdx.x & 31;
  const float* xr = x + p * D;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float xv = cips::round_mm<T>(xr[c]);
    s0 = fmaf(xv, cips::to_f(wr[c * 3 + 0]), s0);
    s1 = fmaf(xv, cips::to_f(wr[c * 3 + 1]), s1);
    s2 = fmaf(xv, cips::to_f(wr[c * 3 + 2]), s2);
  }
  s0 = cips::warp_sum(s0);
  s1 = cips::warp_sum(s1);
  s2 = cips::warp_sum(s2);
  if (lane == 0) {
    const float s[3] = {s0, s1, s2};
    for (int ch = 0; ch < 3; ++ch) {
      const float v = (first ? 0.f : rgb[p * 3 + ch]) + (s[ch] + br[ch]);
      if (last)
        out[p * 3 + ch] = tanhf(v);
      else
        rgb[p * 3 + ch] = v;
    }
  }
}

template <typename T>
int stream_decode(const float* x, const float* s, const float* d, const T* w0, const T* wrest,
                  const T* wr, const float* br, float* out, float* x0, float* x1, float* rgb,
                  int b, int n, int in0, int D, int n_blocks, cudaStream_t st) {
  using namespace cips_stream;
  const int L = 2 * n_blocks;
  const long long pixels = (long long)b * n;
  for (int layer = 0; layer < L; ++layer) {
    const int blk = layer / 2, stage = layer % 2;
    GemmArgs g = {};
    // stage 0 reads the block input (x for block 0) into x1; stage 1 reads x1 into x0
    const float* in = stage ? x1 : layer == 0 ? x : x0;
    const int K = layer == 0 ? in0 : D;
    g.a = Mat{const_cast<float*>(in), n, 0, K, 0};
    g.akvalid = K;
    g.w = layer == 0 ? w0 : wrest + (long long)(layer - 1) * D * D;
    g.ldw = D;
    g.wvalid = K;
    g.nrows = n;
    g.K = K;
    g.N = D;
    g.out = Mat{stage ? x0 : x1, n, 0, D, 0};
    if (stage == 1 && blk >= kFirstSkip) g.resid = g.out;   // the block input, read, then written
    g.scale = Vec{s + (long long)layer * D, L * D};
    g.demod = Vec{d + (long long)layer * D, L * D};
    CIPS_TRY((gemm<T, float, false, kInr>(g, b, st)));
    if (stage == 1 && blk >= kFirstRgb) {
      const int r = blk - kFirstRgb;
      to_rgb<T><<<(unsigned)((pixels + kRgbWarps - 1) / kRgbWarps), 32 * kRgbWarps, 0, st>>>(
          x0, wr + (long long)r * D * 3, br + r * 3, rgb, out, pixels, D, blk == kFirstRgb,
          blk == n_blocks - 1);
      CIPS_TRY(cudaGetLastError());
    }
  }
  return (int)cudaSuccess;
}

}  // namespace

// The streamed decode: shapes as cips_inr_tile_forward's, any D (a multiple
// of 16) and in0 <= D (a multiple of 16); x0, x1 (b, n, D) and rgb (b, n, 3)
// f32 scratch.  Returns the CUDA error of the launches (0 on success).
extern "C" int cips_inr_tile_forward_streamed(
    const void* x, const void* s, const void* d, const void* w0, const void* wrest,
    const void* wr, const void* br, void* out, void* x0, void* x1, void* rgb, int b, int n,
    int in0, int D, int n_blocks, int mm_bf16, void* stream) {
  if (n_blocks <= kFirstRgb || in0 > D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [&](auto t) {
    using T = decltype(t);
    return stream_decode<T>(static_cast<const float*>(x), static_cast<const float*>(s),
                            static_cast<const float*>(d), static_cast<const T*>(w0),
                            static_cast<const T*>(wrest), static_cast<const T*>(wr),
                            static_cast<const float*>(br), static_cast<float*>(out),
                            static_cast<float*>(x0), static_cast<float*>(x1),
                            static_cast<float*>(rgb), b, n, in0, D, n_blocks, st);
  };
  return mm_bf16 ? f(__nv_bfloat16()) : f(0.f);
}

// The dynamic shared memory of the streamed decode's product (bytes), the
// same at every D.
extern "C" int cips_inr_tile_streamed_smem(int mm_bf16) {
  using namespace cips_stream;
  return mm_bf16 ? (int)gemm_smem<__nv_bfloat16, float, false, kInr>()
                 : (int)gemm_smem<float, float, false, kInr>();
}
