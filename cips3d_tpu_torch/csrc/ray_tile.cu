// Fused ray-tile renderer: the hierarchical NeRF stage of
// GeneratorNerfINR.points_forward, forward.
//
// Replaces: cips3d_tpu/ops/pallas/ray_tile.py::_ray_tile_kernel (entry
// fused_ray_render via _pallas_forward), with and without the residual
// outputs (`with_residuals`, ray_tile.py:207-214).  Per block of rays:
//   coarse FiLM-SIREN -> compositing weights -> inverse-CDF importance
//   sample -> fine FiLM-SIREN -> sort-free compositing of the 2S samples in
//   [fine, coarse] arrival order -> (feature, depth).
// Options as in the Pallas kernel: relu/softplus density, density noise
// (draws made outside), white_back, last_back, fast_sin, bf16 matmul inputs.
// With residuals (the training forward of the residual-mode backward,
// ray_tile_bwd.cu, which also runs this kernel for its recompute mode) it
// also writes, per pass and point, every hidden layer's pre-activation a
// (f32) and output h (mm type), and the colour FiLM's ac and hc: rh/ra
// (b, 2, n, S, L*H), rhc/rac (b, 2, n, S, C), pass 0 coarse, 1 fine, points
// ray-major: 2560 B a point in f32 at the flagship widths.  The stores go
// from the accumulator fragments: each warp store fills whole 32-byte
// sectors of 8 rows (f32).
//
// What bounds it on an H100: the point MLP.  Per sample point it costs
// 2 * (3H + (L-1)H^2 + HC + CR + H) = 54 kFLOP and L*H + C sines at the
// flagship widths (H=128, L=2, C=64, R=32); a 128x128 frame at S=24 is
// 0.79 M points and 43 GFLOP, 0.64 ms at the 67 TFLOP/s f32 FMA rate, and a
// tenth of that on the tensor cores.  An earlier version ran the products on
// the FMA units with 4 warps per SM and spent 89 % of its time in the
// per-element epilogues between barriers.  This design:
//   * 16 warps share one copy of the weights (one block of 512 threads per
//     SM, 16 rays a block: one warp per ray in the per-ray stages);
//   * a persistent grid (about one block per SM) walks the ray blocks of all
//     batch rows, so the weights (121 KB in f32, rows padded) are loaded
//     once per SM rather than once per 4 rays;
//   * the products run on the tensor cores (ray_mlp.cuh: 3xTF32 with a fresh
//     partial per k-step in f32, bf16 m16n8k16), and the bias + FiLM + sine
//     + rounding epilogues work on the accumulator fragments in registers;
//   * the per-sample rgb of a ray block (16 x 2S x R floats, 48 KB at S = 24,
//     R = 32) goes to a per-block scratch slot in device memory, which
//     stays in L2, since it does not fit beside the weights.
// The per-ray stages are those of ray_tile.cuh (the backward runs the same
// code, so it reproduces the fine depths bit for bit).  The Pallas kernel's
// floors and guards are kept exactly: max(1 - alpha, 1e-10), never + eps;
// the `cdf < u` count with the denom < 1e-5 -> 1 guard; the successor delta
// and the 1e10 last delta.

#include "ray_mlp.cuh"
#include "ray_tile.cuh"

namespace {

using cips_mlp::kRows;
using cips_mlp::kThreads;
using cips_mlp::kXLd;
constexpr int kRays = cips_mlp::kWarps;   // rays per block: one warp per ray

struct RayArgs {
  const float* pts;    // (b, n, S, 3) coarse points
  const float* org;    // (b, n, 3)
  const float* dir;    // (b, n, 3)
  const float* z;      // (b, n, S) coarse depths, sorted along S
  const float* u;      // (b, n, S) importance-sample uniforms
  const float* nc;     // (b, n, S) resample density noise
  const float* nf;     // (b, n, 2S) compositing density noise
  const void* wbuf;    // mm type: w_0 (3,H), w_1.. (H,H), wc (H,C), wr (C,R), ws (H)
  const float* pbuf;   // b_0.. (H), bc (C), br (R), bs (1); padded
  const float* films;  // (b, nfilm): g_0, f_0, g_1, f_1, .. (H each), gc, fc (C each); padded
  void* fea;           // (b, n, R) out type
  float* depth;        // (b, n)
  void* rh;            // residuals, or null: (b, 2, n, S, L*H) mm type
  float* ra;           // (b, 2, n, S, L*H)
  void* rhc;           // (b, 2, n, S, C) mm type
  float* rac;          // (b, 2, n, S, C)
  float* rgb;          // scratch (grid, kRays, 2S, R)
  int b, n, S, L, H, C, R, grid;
  int np, nfilm;       // padded element counts of pbuf and one films row
  float noise_std, warp_scale;
  int softplus, white_back, last_back, use_noise, fast_sin, out_bf16;
};

struct RayLayout {
  size_t w, p, f, xb, hb, sig, zall, sall, nfv, t1, t2, rank, uv, ncv, od, total;
  int ldh;   // row stride of the hidden-state buffer
  template <typename T>
  __host__ __device__ static RayLayout make(const RayArgs& a) {
    RayLayout y;
    const int M = 2 * a.S;
    const cips_mlp::WLayout wl = cips_mlp::WLayout::make<T>(a.L, a.H, a.C, a.R);
    y.ldh = (a.H > a.C ? a.H : a.C) + 4;
    size_t off = 0;
    y.w = cips::take(off, sizeof(T) * wl.total);
    y.p = cips::take(off, sizeof(float) * a.np);
    y.f = cips::take(off, sizeof(float) * a.nfilm);
    y.xb = cips::take(off, sizeof(float) * kRows * kXLd);
    y.hb = cips::take(off, sizeof(float) * kRows * y.ldh);
    y.sig = cips::take(off, sizeof(float) * kRows);
    y.zall = cips::take(off, sizeof(float) * kRays * M);
    y.sall = cips::take(off, sizeof(float) * kRays * M);
    y.nfv = cips::take(off, sizeof(float) * kRays * M);
    y.t1 = cips::take(off, sizeof(float) * kRays * M);
    y.t2 = cips::take(off, sizeof(float) * kRays * M);
    y.rank = cips::take(off, sizeof(int) * kRays * M);
    y.uv = cips::take(off, sizeof(float) * kRays * a.S);
    y.ncv = cips::take(off, sizeof(float) * kRays * a.S);
    y.od = cips::take(off, sizeof(float) * kRays * 8);
    y.total = off;
    return y;
  }
};

template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads, 1) ray_tile_kernel(RayArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RayLayout lay = RayLayout::make<T>(a);
  const cips_mlp::WLayout wl = cips_mlp::WLayout::make<T>(a.L, a.H, a.C, a.R);
  T* wsm = reinterpret_cast<T*>(smem + lay.w);
  float* psm = reinterpret_cast<float*>(smem + lay.p);
  float* fsm = reinterpret_cast<float*>(smem + lay.f);
  float* xb = reinterpret_cast<float*>(smem + lay.xb);
  float* hb = reinterpret_cast<float*>(smem + lay.hb);
  float* sig = reinterpret_cast<float*>(smem + lay.sig);
  float* zall = reinterpret_cast<float*>(smem + lay.zall);   // [ray][fine 0..S-1, coarse S..2S-1]
  float* sall = reinterpret_cast<float*>(smem + lay.sall);
  float* nfv = reinterpret_cast<float*>(smem + lay.nfv);
  float* t1 = reinterpret_cast<float*>(smem + lay.t1);
  float* t2 = reinterpret_cast<float*>(smem + lay.t2);
  int* rank = reinterpret_cast<int*>(smem + lay.rank);
  float* uv = reinterpret_cast<float*>(smem + lay.uv);
  float* ncv = reinterpret_cast<float*>(smem + lay.ncv);
  float* od = reinterpret_cast<float*>(smem + lay.od);       // [ray][org xyz, pad, dir xyz, pad]
  T* rh = static_cast<T*>(a.rh);
  T* rhc = static_cast<T*>(a.rhc);

  const int S = a.S, M = 2 * S, R = a.R, n = a.n, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nrb = (n + kRays - 1) / kRays;
  float* rgbs = a.rgb + (size_t)blockIdx.x * kRays * M * R;   // this block's slot

  cips_mlp::load_weights<T>(wsm, static_cast<const T*>(a.wbuf), wl, a.L, a.H, a.C, R);
  for (int i = tid; i < a.np; i += kThreads) psm[i] = a.pbuf[i];
  for (int i = tid; i < kRows * kXLd; i += kThreads) xb[i] = 0.f;   // columns 3.. stay zero
  const cips_mlp::Mlp<T> mlp{wsm, wl, psm, fsm, a.L, a.H, a.C, R, a.fast_sin};

  for (int task = blockIdx.x; task < a.b * nrb; task += gridDim.x) {
    const int bi = task / nrb, ray0 = (task % nrb) * kRays;
    const int nvalid = min(kRays, n - ray0) * S;   // points of the block's existing rays
    __syncthreads();   // the previous ray block is done with the shared buffers
    for (int i = tid; i < a.nfilm; i += kThreads) fsm[i] = a.films[(size_t)bi * a.nfilm + i];
    for (int i = tid; i < kRays * S; i += kThreads) {
      const int r = i / S, s = i % S, ray = ray0 + r;
      const bool ok = ray < n;
      const size_t idx = ((size_t)bi * n + ray) * S + s;
      zall[r * M + S + s] = ok ? a.z[idx] : 0.f;
      uv[i] = ok ? a.u[idx] : 0.f;
      ncv[i] = ok && a.use_noise ? a.nc[idx] : 0.f;
    }
    for (int i = tid; i < kRays * M; i += kThreads) {
      const int r = i / M, j = i % M, ray = ray0 + r;
      nfv[i] = ray < n && a.use_noise ? a.nf[((size_t)bi * n + ray) * M + j] : 0.f;
    }
    for (int i = tid; i < kRays * 3; i += kThreads) {
      const int r = i / 3, c = i % 3, ray = ray0 + r;
      const size_t idx = ((size_t)bi * n + ray) * 3 + c;
      od[r * 8 + c] = ray < n ? a.org[idx] : 0.f;
      od[r * 8 + 4 + c] = ray < n ? a.dir[idx] : 0.f;
    }
    __syncthreads();

    // FiLM-SIREN over one pass of the block's kRays * S points, 64 at a time.
    auto run_pass = [&](bool fine) {
      for (int q0 = 0; q0 < kRays * S; q0 += kRows) {
        for (int i = tid; i < kRows * 3; i += kThreads) {
          const int row = i / 3, c = i % 3, q = q0 + row;
          float v = 0.f;
          if (q < nvalid) {
            const int r = q / S, s = q % S;
            v = fine ? od[r * 8 + c] + od[r * 8 + 4 + c] * zall[r * M + s]
                     : a.pts[(((size_t)bi * n + ray0 + r) * S + s) * 3 + c];
          }
          xb[row * kXLd + c] = cips::round_mm<T>(v * a.warp_scale);   // UniformBoxWarp
        }
        __syncthreads();
        auto store_rgb = [&](int row, int col, float v) {
          const int q = q0 + row;
          if (q < nvalid) rgbs[((q / S) * M + (fine ? q % S : S + q % S)) * R + col] = v;
        };
        const long long res0 = (((long long)bi * 2 + fine) * n + ray0) * S + q0;
        cips_mlp::chunk_mlp<T, kRes>(mlp, xb, hb, lay.ldh, sig, store_rgb,
                                     max(0, min(kRows, nvalid - q0)), res0, a.ra, rh, a.rac, rhc);
        __syncthreads();
        for (int row = tid; row < kRows; row += kThreads) {
          const int q = q0 + row;
          if (q < kRays * S) sall[(q / S) * M + (fine ? q % S : S + q % S)] = sig[row];
        }
      }
      __syncthreads();
    };

    run_pass(false);
    cips_ray::resample_ray(zall + warp * M, sall + warp * M + S, uv + warp * S, ncv + warp * S,
                           t1 + warp * M, t2 + warp * M, S, a.use_noise, a.noise_std, a.softplus);
    __syncthreads();
    run_pass(true);

    // ---- compositing: warp = ray, lanes own samples lane and lane + 32 ----
    const int r = warp, ray = ray0 + r;
    float* wt = t2 + r * M;
    float wsum;
    const cips_ray::CompLane cl = cips_ray::composite_ray(
        zall + r * M, sall + r * M, nfv + r * M, t1 + r * M, rank + r * M, M, a.use_noise,
        a.noise_std, a.softplus, a.last_back, wsum);
    float dpart = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j >= M) continue;
      wt[j] = cl.w[t];
      dpart += cl.w[t] * cl.z[t];
    }
    const float dep = cips::warp_sum(dpart);
    __syncwarp();
    if (ray < n) {
      const size_t o = (size_t)bi * n + ray;
      const float* rgr = rgbs + r * M * R;
      for (int c = lane; c < R; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < M; ++j) acc = fmaf(wt[j], rgr[j * R + c], acc);
        if (a.white_back) acc += 1.f - wsum;
        if (a.out_bf16)
          static_cast<__nv_bfloat16*>(a.fea)[o * R + c] = __float2bfloat16_rn(acc);
        else
          static_cast<float*>(a.fea)[o * R + c] = acc;
      }
      if (lane == 0) a.depth[o] = dep;
    }
  }
}

template <typename T, bool kRes>
int launch(const RayArgs& a, cudaStream_t stream) {
  const RayLayout lay = RayLayout::make<T>(a);
  cudaError_t err = cudaFuncSetAttribute(ray_tile_kernel<T, kRes>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  ray_tile_kernel<T, kRes><<<a.grid, kThreads, lay.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Rays per block of the forward (and of the backward's cotangent kernel).
extern "C" int cips_ray_tile_block_rays() { return kRays; }

// Shapes as in RayArgs; rh, ra, rhc, rac are all null (no residuals) or
// all set.  rgb is (grid, kRays, 2S, R) f32 scratch.  The wrapper checks S
// in [3, 32], H, C, R multiples of 16 up to 128, and pads pbuf and the
// films rows to 16-byte multiples.  Returns the CUDA error of the launch (0
// on success).
extern "C" int cips_ray_tile_forward(
    const void* pts, const void* org, const void* dir, const void* z, const void* u,
    const void* nc, const void* nf, const void* wbuf, const void* pbuf, const void* films,
    void* fea, void* depth, void* rh, void* ra, void* rhc, void* rac, void* rgb,
    int b, int n, int S, int L, int H, int C, int R, int grid,
    float noise_std, float warp_scale,
    int np, int nfilm, int softplus, int white_back, int last_back, int flags,
    void* stream) {
  RayArgs a;
  a.pts = static_cast<const float*>(pts);
  a.org = static_cast<const float*>(org);
  a.dir = static_cast<const float*>(dir);
  a.z = static_cast<const float*>(z);
  a.u = static_cast<const float*>(u);
  a.nc = static_cast<const float*>(nc);
  a.nf = static_cast<const float*>(nf);
  a.wbuf = wbuf;
  a.pbuf = static_cast<const float*>(pbuf);
  a.films = static_cast<const float*>(films);
  a.fea = fea;
  a.depth = static_cast<float*>(depth);
  a.rh = rh;
  a.ra = static_cast<float*>(ra);
  a.rhc = rhc;
  a.rac = static_cast<float*>(rac);
  a.rgb = static_cast<float*>(rgb);
  a.b = b; a.n = n; a.S = S; a.L = L; a.H = H; a.C = C; a.R = R;
  a.grid = grid;
  a.np = np; a.nfilm = nfilm;
  a.noise_std = noise_std;
  a.warp_scale = warp_scale;
  a.softplus = softplus;
  a.white_back = white_back;
  a.last_back = last_back;
  // flags: bit 0 use_noise, bit 1 fast_sin, bit 2 bf16 matmul inputs, bit 3 bf16 features
  a.use_noise = flags & 1;
  a.fast_sin = (flags >> 1) & 1;
  a.out_bf16 = (flags >> 3) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = rh != nullptr;
  if ((flags >> 2) & 1)
    return res ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
  return res ? launch<float, true>(a, st) : launch<float, false>(a, st);
}

// Resident warps per SM, dynamic shared memory and threads of the forward
// at these widths (flags as above, bit 4: with residuals) into out[0..2].
extern "C" int cips_ray_tile_forward_occupancy(int S, int L, int H, int C, int R, int flags,
                                               int* out) {
  RayArgs a = {};
  a.S = S; a.L = L; a.H = H; a.C = C; a.R = R;
  a.np = L * H + C + R + 4;
  a.nfilm = 2 * L * H + 2 * C;
  const bool bf16 = (flags >> 2) & 1, res = (flags >> 4) & 1;
  if (bf16) {
    const size_t sm = RayLayout::make<__nv_bfloat16>(a).total;
    return res ? cips::occupancy(ray_tile_kernel<__nv_bfloat16, true>, kThreads, sm, out)
               : cips::occupancy(ray_tile_kernel<__nv_bfloat16, false>, kThreads, sm, out);
  }
  const size_t sm = RayLayout::make<float>(a).total;
  return res ? cips::occupancy(ray_tile_kernel<float, true>, kThreads, sm, out)
             : cips::occupancy(ray_tile_kernel<float, false>, kThreads, sm, out);
}
