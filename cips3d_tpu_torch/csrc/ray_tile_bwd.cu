// Backward of the fused ray tile: the gradients of the NeRF stage's weights,
// biases and per-sample FiLM gains/shifts, and of the coarse points.
//
// Replaces: cips3d_tpu/ops/pallas/ray_tile.py::_ray_tile_bwd_kernel (entry
// _pallas_backward, the custom VJP of fused_ray_render), in both of its
// modes: residual (`vjp_impl='pallas_residual'`: the MLP states come from
// the residuals that ray_tile.cu's forward wrote) and recompute
// (`'pallas'`: the wrapper first runs that forward again, with residuals,
// into scratch, so the chunk MLP of both modes is ray_mlp.cuh's).
//
// What bounds it on an H100: the MLP products.  Per point the backward
// needs about twice the forward's 27136 multiply-adds (the d-input and the
// d-weight products): at r64, b = 4, S = 12 (0.39 M points over both
// passes) 42.7 GFLOP, 0.64 ms at the 67 TFLOP/s f32 FMA rate and a few
// tenths of that on the tensor cores; residual mode reads 2560 B of
// residuals a point (1.0 GB, 0.30 ms at 3.35 TB/s).  An earlier version ran
// everything on the FMA units with 4 warps per SM, added each 16-point
// chunk's weight grads into a 225 KB partial row in device memory (5.5 GB
// of L2 traffic at those shapes) and ran 25 barriers a chunk.  This one has
// two stages:
//   K1 `ray_tile_bwd_cot`, grid (gx, b), 16 warps, 16 rays a block (one warp
//     per ray in the per-ray stages, ray_tile.cuh), walking the ray blocks
//     x, x + gx, .. of batch row blockIdx.y:
//       A. sigma and rgb of both passes from the residuals (the sigma head is
//          ray_mlp.cuh's, on the same rounded h as the forward's, so the
//          resample gives the forward's fine depths bit for bit), rgb
//          dotted with d fea at once;
//       B. compositing forward and backward, warp = ray: d rgb and d sigma of
//          every sample.  white_back, last_back, the `(1 - alpha) > 1e-10`
//          gate on d logx and the relu/softplus derivative follow the Pallas
//          kernel (ray_tile.py:636-663);
//       C. per pass (fine, then coarse) and 64-point chunk, the d-input chain
//          on the tensor cores (d rgb -> d hc -> d h_{L-1} -> .. -> d x),
//          with the mm-type rounding of the Pallas kernel's `mlp_bwd`
//          (ray_tile.py:511-548) and the FiLM epilogues on the accumulator
//          fragments.  It writes each point's rounded cotangents (d a of
//          every hidden layer, d ac, d sigma, d rgb: 1440 B a point in f32)
//          and its rounded warped point to scratch, and d pts for the coarse
//          pass.  The bias and FiLM grads are summed on chip per block (one
//          fixed owner thread per column and m-tile) and written once per
//          block.
//   K2 `ray_tile_bwd_wgrad`: every weight grad dW = X^T dA over all points of
//     the call (X: the points, the residual h_l or hc; dA: K1's cotangents)
//     as a split-K product on the tensor cores, a fixed 2048-point split per
//     block, each k-step's products in a fresh partial added in f32 (a
//     393k-deep sum in the MMA's C register would drift), written to a
//     partial row per split.
//   A third kernel sums the partial rows in a fixed order.  No float
//   atomics anywhere: two runs give the same bits.
// The sigma head is the port's (H, 1) column, not the Pallas kernel's
// lane-padded (H, 8) block: its grad is (H, 1) and (1,).
#include "ray_mlp.cuh"
#include "ray_tile.cuh"
#include "wgrad.cuh"

namespace {

using cips_mlp::Frag;
using cips_mlp::kMaxNT;
using cips_mlp::kMT;
using cips_mlp::kRows;
using cips_mlp::kThreads;
using cips_mlp::kWarps;
using cips_mlp::wld;
using cips_mlp::WLayout;
constexpr int kRays = kWarps;   // rays per block: one warp per ray
constexpr int kXW = 8;          // row width of the point scratch (3 used)

struct BwdArgs {
  const float *pts, *org, *dir, *z, *u, *nc, *nf;   // as the forward's
  const float* noise;  // (1,) density-noise scale on the device, as the forward's
  const void* wbuf;    // mm type: w_0 (3,H), w_1.. (H,H), wc (H,C), wr (C,R), ws (H)
  const float* pbuf;   // b_0.. (H), bc (C), br (R), bs (1); padded
  const float* films;  // (b, nfilm): g_0, f_0, g_1, f_1, .. (H each), gc, fc (C each)
  const float* dfea;   // (b, n, R) cotangent of the feature
  const float* ddep;   // (b, n) cotangent of the depth
  const void* rh;      // residuals in the forward's layout (both modes)
  const float* ra;
  const void* rhc;
  const float* rac;
  void* xs;            // (b, 2, n, S, kXW) mm type: rounded, warped points
  void* dq;            // (b, 2, n, S, CotRow::width) mm type: rounded cotangents
  float* part_b;       // (b, gx, nb + nf): per-block bias and FiLM sums
  float* dpts;         // (b, n, S, 3)
  int b, n, S, L, H, C, R, gx, np, nfilm;
  float warp_scale;
  int softplus, white_back, last_back, use_noise, fast_sin;
};

// Offsets of the flat gradient row (the order of wbuf, pbuf and a films
// row): matrices, then biases, then FiLM gains and shifts.
struct GradRow {
  int w0, wl, wc, wr, ws, nw, nb, nf;
  __host__ __device__ GradRow(int L, int H, int C, int R) {
    w0 = 0;
    wl = 3 * H;                       // w_l at wl + (l - 1) H^2
    wc = wl + (L - 1) * H * H;
    wr = wc + H * C;
    ws = wr + C * R;
    nw = ws + H;
    nb = L * H + C + R + 1;           // b_l at l H, bc, br, bs
    nf = 2 * L * H + 2 * C;           // g_l at 2 l H, f_l at 2 l H + H, gc, fc
  }
};

// Columns of a point's cotangent row: d a_l (H each), d ac (C), d sigma
// (1, then 7 zeros), d rgb (R).  Every block starts 16-byte aligned.
struct CotRow {
  int dac, dsig, drgb, width;
  __host__ __device__ CotRow(int L, int H, int C, int R) {
    dac = L * H;
    dsig = dac + C;
    drgb = dsig + 8;
    width = drgb + R;
  }
};

struct CotLayout {
  size_t w, p, f, d, dsg, facc, bacc, zall, sall, t1, t2, rdot, rank, od, dfv, ddv, total;
  int ldh, nsum;
  template <typename T>
  __host__ __device__ static CotLayout make(const BwdArgs& a) {
    CotLayout y;
    const int M = 2 * a.S, H = a.H, C = a.C, R = a.R;
    const WLayout wl = WLayout::make<T>(a.L, H, C, R);
    int wmax = H > C ? H : C;
    if (R > wmax) wmax = R;
    y.ldh = wmax + 4;
    y.nsum = 3 * (a.L * H + C);        // per layer [d g | d f | d b], then the colour FiLM's
    size_t off = 0;
    y.w = cips::take(off, sizeof(T) * wl.total);
    y.p = cips::take(off, sizeof(float) * a.np);
    y.f = cips::take(off, sizeof(float) * a.nfilm);
    y.d = cips::take(off, sizeof(float) * kRows * y.ldh);
    y.dsg = cips::take(off, sizeof(float) * kRows);
    y.facc = cips::take(off, sizeof(float) * kMT * y.nsum);
    y.bacc = cips::take(off, sizeof(float) * (R + 1));
    y.zall = cips::take(off, sizeof(float) * kRays * M);
    y.sall = cips::take(off, sizeof(float) * kRays * M);
    y.t1 = cips::take(off, sizeof(float) * kRays * M);
    y.t2 = cips::take(off, sizeof(float) * kRays * M);
    y.rdot = cips::take(off, sizeof(float) * kRays * M);
    y.rank = cips::take(off, sizeof(int) * kRays * M);
    y.od = cips::take(off, sizeof(float) * kRays * 8);
    y.dfv = cips::take(off, sizeof(float) * kRays * R);
    y.ddv = cips::take(off, sizeof(float) * kRays);
    y.total = off;
    return y;
  }
};

__device__ __forceinline__ float sin_grad(float x, int fast_sin) {
  return fast_sin ? cips_fast_sin_gradf(x) : cosf(x);
}

__device__ __forceinline__ float col_sum16(float top, float bottom) {
  // the 16 rows of an m-tile: rows g and g + 8 of this lane, then over g
  float x = top + bottom;
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ray_tile_bwd_cot(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CotLayout lay = CotLayout::make<T>(a);
  const WLayout wl = WLayout::make<T>(a.L, a.H, a.C, a.R);
  T* wsm = reinterpret_cast<T*>(smem + lay.w);
  float* psm = reinterpret_cast<float*>(smem + lay.p);
  float* fsm = reinterpret_cast<float*>(smem + lay.f);
  float* D = reinterpret_cast<float*>(smem + lay.d);          // [row][ldh] chunk cotangents
  float* dsg = reinterpret_cast<float*>(smem + lay.dsg);      // [row] d sigma
  float* facc = reinterpret_cast<float*>(smem + lay.facc);    // [m-tile][nsum]
  float* bacc = reinterpret_cast<float*>(smem + lay.bacc);    // d br (R), d bs
  float* zall = reinterpret_cast<float*>(smem + lay.zall);    // [ray][fine 0..S-1, coarse S..2S-1]
  float* sall = reinterpret_cast<float*>(smem + lay.sall);
  float* t1 = reinterpret_cast<float*>(smem + lay.t1);
  float* t2 = reinterpret_cast<float*>(smem + lay.t2);        // compositing weights after phase B
  // rgb . d fea per sample until phase B, then d raw sigma per sample: the lane that reads
  // a sample's rgb . d fea is the one that writes its d sigma
  float* rdot = reinterpret_cast<float*>(smem + lay.rdot);
  float* dsa = rdot;
  int* rank = reinterpret_cast<int*>(smem + lay.rank);
  float* od = reinterpret_cast<float*>(smem + lay.od);
  float* dfv = reinterpret_cast<float*>(smem + lay.dfv);      // [ray][R]
  float* ddv = reinterpret_cast<float*>(smem + lay.ddv);

  const int S = a.S, M = 2 * S, H = a.H, C = a.C, R = a.R, L = a.L, n = a.n, LH = L * H;
  const int ldh = lay.ldh, nsum = lay.nsum;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* rh = static_cast<const T*>(a.rh);
  const T* rhc = static_cast<const T*>(a.rhc);
  T* xs = static_cast<T*>(a.xs);
  T* dq = static_cast<T*>(a.dq);
  const CotRow cr(L, H, C, R);
  const Frag fr;

  cips_mlp::load_weights<T>(wsm, static_cast<const T*>(a.wbuf), wl, L, H, C, R);
  for (int i = tid; i < a.np; i += kThreads) psm[i] = a.pbuf[i];
  for (int i = tid; i < a.nfilm; i += kThreads) fsm[i] = a.films[(size_t)bi * a.nfilm + i];
  for (int i = tid; i < kMT * nsum; i += kThreads) facc[i] = 0.f;
  for (int i = tid; i <= R; i += kThreads) bacc[i] = 0.f;
  __syncthreads();

  const T* wr = wsm + wl.wr;
  const T* ws = wsm + wl.ws;
  const int ldr = wld<T>(R);
  const float* br = psm + LH + C;
  const float bs = br[R];
  const float* gc = fsm + 2 * LH;
  const float* fcv = gc + C;

  const float noise_std = a.use_noise ? __ldg(a.noise) : 0.f;
  const int nrb = (n + kRays - 1) / kRays;
  for (int rb = blockIdx.x; rb < nrb; rb += a.gx) {
    const int ray0 = rb * kRays;
    const int nvalid = min(kRays, n - ray0) * S;   // points of the block's existing rays
    __syncthreads();   // the previous ray block is done with the shared buffers
    for (int i = tid; i < kRays * S; i += kThreads) {
      const int r = i / S, s = i % S, ray = ray0 + r;
      zall[r * M + S + s] = ray < n ? a.z[((size_t)bi * n + ray) * S + s] : 0.f;
    }
    for (int i = tid; i < kRays * M; i += kThreads) {
      sall[i] = 0.f;
      rdot[i] = 0.f;
    }
    for (int i = tid; i < kRays * 3; i += kThreads) {
      const int r = i / 3, c = i % 3, ray = ray0 + r;
      const size_t idx = ((size_t)bi * n + ray) * 3 + c;
      od[r * 8 + c] = ray < n ? a.org[idx] : 0.f;
      od[r * 8 + 4 + c] = ray < n ? a.dir[idx] : 0.f;
    }
    for (int i = tid; i < kRays * R; i += kThreads) {
      const int r = i / R, ray = ray0 + r;
      dfv[i] = ray < n ? a.dfea[((size_t)bi * n + ray) * R + i % R] : 0.f;
    }
    for (int r = tid; r < kRays; r += kThreads)
      ddv[r] = ray0 + r < n ? a.ddep[(size_t)bi * n + ray0 + r] : 0.f;
    __syncthreads();

    // ---- phase A: sigma and rgb . d fea of one pass from the residuals, warp = point ----
    auto phase_a = [&](bool fine) {
      const long long base = (((long long)bi * 2 + fine) * n + ray0) * S;
      for (int q = warp; q < nvalid; q += kWarps) {
        const long long g = base + q;
        const int r = q / S, slot = fine ? q % S : S + q % S;
        const float sg = cips_mlp::sigma_head(rh + g * LH + (L - 1) * H, ws, H, bs);
        float hv[4];   // hc of the point, lane k holding k = lane + 32 i
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = lane + 32 * i;
          hv[i] = k < C ? cips::to_f(rhc[g * C + k]) : 0.f;
        }
        float dot = 0.f;
        for (int c0 = 0; c0 < R; c0 += 32) {   // rgb head, lane c = c0 + lane
          const int c = c0 + lane;
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (32 * i >= C) break;
            for (int kk = 0; kk < 32; ++kk) {
              const float h = __shfl_sync(0xffffffffu, hv[i], kk);
              if (c < R && 32 * i + kk < C) v = fmaf(h, cips::to_f(wr[(32 * i + kk) * ldr + c]), v);
            }
          }
          if (c < R) dot = fmaf(v + br[c], dfv[r * R + c], dot);
        }
        dot = cips::warp_sum(dot);
        if (lane == 0) {
          sall[r * M + slot] = sg;
          rdot[r * M + slot] = dot;
        }
      }
    };
    phase_a(false);
    __syncthreads();
    {   // the draws of the warp's ray are read where they lie (null past n)
      const size_t dro = ((size_t)bi * n + ray0 + warp) * S;
      const bool live = ray0 + warp < n;
      cips_ray::resample_ray(zall + warp * M, sall + warp * M + S, live ? a.u + dro : nullptr,
                             live ? a.nc + dro : nullptr, t1 + warp * M, t2 + warp * M, S,
                             a.use_noise, noise_std, a.softplus);
    }
    __syncthreads();
    phase_a(true);
    __syncthreads();

    // ---- phase B: compositing forward and backward, warp = ray ----
    {
      const int r = warp, ray = ray0 + r;
      float wsum;
      const cips_ray::CompLane cl = cips_ray::composite_ray(
          zall + r * M, sall + r * M, ray < n ? a.nf + ((size_t)bi * n + ray) * M : nullptr,
          t1 + r * M, rank + r * M, M, a.use_noise, noise_std, a.softplus, a.last_back, wsum);
      const float* df = dfv + r * R;
      float dw0[cips_ray::kLaneSamples], lastpart = 0.f;
#pragma unroll
      for (int t = 0; t < cips_ray::kLaneSamples; ++t) {
        const int j = lane + 32 * t;
        dw0[t] = 0.f;
        if (j >= M) continue;
        dw0[t] = rdot[r * M + j] + ddv[r] * cl.z[t];        // d w (after last_back)
        if (cl.rank[t] == M - 1) lastpart += dw0[t];
      }
      float dwsum = 0.f;                                     // d of the pre-last_back weight sum
      if (a.white_back) {
        float sdf = 0.f;
        for (int c = 0; c < R; ++c) sdf += df[c];
        dwsum -= sdf;
      }
      const float dlast = cips::warp_sum(lastpart);
      if (a.last_back) dwsum -= dlast;
      float* dacc = t1 + r * M;
#pragma unroll
      for (int t = 0; t < cips_ray::kLaneSamples; ++t) {
        const int j = lane + 32 * t;
        if (j >= M) continue;
        dw0[t] += dwsum;
        t2[r * M + j] = cl.w[t];
        dacc[j] = cl.trans[t] * (dw0[t] * cl.alpha[t]);     // d of the log-transmittance sum
      }
      __syncwarp();
      const int* rk = rank + r * M;
#pragma unroll
      for (int t = 0; t < cips_ray::kLaneSamples; ++t) {
        const int j = lane + 32 * t;
        if (j >= M) continue;
        float dlogx = 0.f;                                   // sum over the samples behind j
        for (int k = 0; k < M; ++k)
          if (rk[k] > cl.rank[t]) dlogx += dacc[k];
        float dalpha = dw0[t] * cl.trans[t];
        dalpha += (1.f - cl.alpha[t]) > 1e-10f ? -dlogx / fmaxf(1.f - cl.alpha[t], 1e-10f) : 0.f;
        const float ddens = dalpha * cl.delta[t] * cl.expd[t];
        dsa[r * M + j] = ddens * cips_ray::density_grad(cl.s[t], a.softplus);
      }
    }
    __syncthreads();

    // ---- phase C: the d-input chain, fine pass then coarse pass ----
    for (int pass = 1; pass >= 0; --pass) {
      const bool fine = pass == 1;
      const long long base = (((long long)bi * 2 + fine) * n + ray0) * S;
      for (int q0 = 0; q0 < nvalid; q0 += kRows) {
        const int nrow = min(kRows, nvalid - q0);
        const long long row0 = base + q0;   // residual / scratch row of chunk row 0
        auto slot_of = [&](int q) { return (q / S) * M + (fine ? q % S : S + q % S); };
        for (int i = tid; i < kRows * R; i += kThreads) {   // d rgb, f32
          const int row = i / R, c = i % R, q = q0 + row;
          D[row * ldh + c] = row < nrow ? t2[slot_of(q)] * dfv[(q / S) * R + c] : 0.f;
        }
        for (int row = tid; row < kRows; row += kThreads)
          dsg[row] = row < nrow ? dsa[slot_of(q0 + row)] : 0.f;
        for (int i = tid; i < nrow * kXW; i += kThreads) {  // the chunk's rounded, warped points
          const int row = i / kXW, c = i % kXW, q = q0 + row, r = q / S, s = q % S;
          float v = 0.f;
          if (c < 3)
            v = cips::round_mm<T>((fine ? od[r * 8 + c] + od[r * 8 + 4 + c] * zall[r * M + s]
                                        : a.pts[(((size_t)bi * n + ray0 + r) * S + s) * 3 + c]) *
                                  a.warp_scale);
          xs[(row0 + row) * kXW + c] = cips::from_f<T>(v);
        }
        __syncthreads();
        // d br and d bs from the f32 grads (thread c owns column c), then the mm-type rounding
        if (tid <= R) {
          float s = 0.f;
          for (int row = 0; row < nrow; ++row) s += tid < R ? D[row * ldh + tid] : dsg[row];
          bacc[tid] += s;
        }
        __syncthreads();
        for (int i = tid; i < kRows * R; i += kThreads) {
          const int row = i / R, c = i % R;
          const float v = cips::round_mm<T>(D[row * ldh + c]);
          D[row * ldh + c] = v;
          if (row < nrow) dq[(row0 + row) * cr.width + cr.drgb + c] = cips::from_f<T>(v);
        }
        for (int i = tid; i < kRows * 8; i += kThreads) {
          const int row = i / 8, c = i % 8;
          const float v = cips::round_mm<T>(dsg[row]);
          if (c == 0) dsg[row] = v;
          if (row < nrow) dq[(row0 + row) * cr.width + cr.dsig + c] = cips::from_f<T>(c == 0 ? v : 0.f);
        }
        __syncthreads();

        float acc[kMaxNT][4];
        // d arg = d out * sin'(g a + f): the FiLM sums, then d a = round(d arg g) to D and dq
        auto film_bwd = [&](int N, const float* ares, int ald, const float* gain,
                            const float* shift, int foff, int dcol) {
#pragma unroll
          for (int j = 0; j < kMaxNT; ++j) {
            if (8 * fr.nt(j) >= N) continue;
            float v[3][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = fr.row(e), col = fr.col(j, e);
              const float av = row < nrow ? ares[(row0 + row) * ald + col] : 0.f;
              const float g = gain[col];
              const float darg = acc[j][e] * sin_grad(g * av + shift[col], a.fast_sin);
              const float da = darg * g;
              v[0][e] = darg * av;
              v[1][e] = darg;
              v[2][e] = da;
              const float dam = cips::round_mm<T>(da);
              D[row * ldh + col] = dam;
              if (row < nrow) dq[(row0 + row) * cr.width + dcol + col] = cips::from_f<T>(dam);
            }
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                const float s = col_sum16(v[k][p], v[k][p + 2]);
                if (fr.g == 0) facc[fr.mt * nsum + foff + k * N + fr.col(j, p)] += s;
              }
          }
        };
        // d hc = d rgb wr^T -> colour FiLM
        cips_mlp::warp_mm<true>(acc, D, ldh, R, wr, ldr, C / 8);
        __syncthreads();
        film_bwd(C, a.rac, C, gc, fcv, 3 * LH, cr.dac);
        __syncthreads();
        // d h_{L-1} = d ac wc^T + d sigma ws
        cips_mlp::warp_mm<true>(acc, D, ldh, C, wsm + wl.wc, wld<T>(C), H / 8);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (8 * fr.nt(j) >= H) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += dsg[fr.row(e)] * cips::to_f(ws[fr.col(j, e)]);
        }
        for (int l = L - 1; l >= 0; --l) {
          film_bwd(H, a.ra + l * H, LH, fsm + 2 * l * H, fsm + 2 * l * H + H, 3 * l * H, l * H);
          __syncthreads();
          if (l > 0) {
            cips_mlp::warp_mm<true>(acc, D, ldh, H, wsm + wl.wl + (l - 1) * H * wld<T>(H),
                                    wld<T>(H), H / 8);
            __syncthreads();
          }
        }
        if (!fine) {   // d pts of the coarse points: d x = d a_0 w_0^T
          cips_mlp::warp_mm<true>(acc, D, ldh, H, wsm + wl.w0, wld<T>(H), 1);
          if (fr.nt(0) == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = fr.row(e), col = fr.col(0, e);
              if (row < nrow && col < 3)
                a.dpts[(((size_t)bi * n + ray0) * S + q0 + row) * 3 + col] = acc[0][e] * a.warp_scale;
            }
          }
        }
        __syncthreads();   // before the next chunk writes D
      }
    }
  }

  // the block's sums in the grad row's order: biases, then FiLM gains and shifts
  __syncthreads();
  const GradRow gr(L, H, C, R);
  float* out = a.part_b + ((size_t)bi * a.gx + blockIdx.x) * (gr.nb + gr.nf);
  auto fsum = [&](int k) {
    float s = 0.f;
    for (int mt = 0; mt < kMT; ++mt) s += facc[mt * nsum + k];
    return s;
  };
  for (int i = tid; i < gr.nb + gr.nf; i += kThreads) {
    float v;
    if (i < LH) v = fsum(3 * (i / H) * H + 2 * H + i % H);             // d b_l
    else if (i < LH + C) v = fsum(3 * LH + 2 * C + i - LH);            // d bc
    else if (i < gr.nb) v = bacc[i - LH - C];                          // d br, d bs
    else if (i < gr.nb + 2 * LH) {
      const int j = i - gr.nb;                                         // d g_l, d f_l
      v = fsum(3 * (j / (2 * H)) * H + j % (2 * H));
    } else {
      v = fsum(3 * LH + i - gr.nb - 2 * LH);                           // d gc, d fc
    }
    out[i] = v;
  }
}

// ---- K2: the weight grads over all points (wgrad.cuh) --------------------

using cips_wgrad::GemmJob;
using cips_wgrad::kWThreads;
using cips_wgrad::wg_smem;
constexpr int kMaxJobs = 8;

struct WgradArgs {
  const void* xs;
  const void* rh;
  const void* rhc;
  const void* dq;
  float* part_w;       // (nsplit, nw)
  long long rows;      // points of the call, both passes
  int split_rows, dld, nw, njobs;
  GemmJob job[kMaxJobs];
};

template <typename T>
__global__ void __launch_bounds__(kWThreads) ray_tile_bwd_wgrad(WgradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GemmJob jb = a.job[blockIdx.y];
  const T* X = static_cast<const T*>(jb.x == 0 ? a.xs : jb.x == 1 ? a.rh : a.rhc);
  const long long r0 = (long long)blockIdx.x * a.split_rows;
  const long long r1 = min(a.rows, r0 + a.split_rows);
  cips_wgrad::wgrad_body<T>(X, static_cast<const T*>(a.dq), a.dld, jb, r0, r1,
                            a.part_w + (size_t)blockIdx.x * a.nw + jb.out, jb.nout, smem);
}

// out_w[e] = the sum over splits (weights) or over (b, gx) (biases) of the
// partial rows, in a fixed order; out_f[bi][e] the sum over gx of batch
// row bi's FiLM grads.
__global__ void ray_tile_bwd_reduce(const float* part_w, int nsplit, int nw, const float* part_b,
                                    int b, int gx, int nb, int nf, float* out_w, float* out_f) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < nw) {
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += part_w[(size_t)sp * nw + e];
    out_w[e] = s;
  } else if (e < nw + nb) {
    float s = 0.f;
    for (int r = 0; r < b * gx; ++r) s += part_b[(size_t)r * (nb + nf) + e - nw];
    out_w[e] = s;
  } else if (e < nw + nb + nf) {
    const int i = e - nw - nb;
    for (int bi = 0; bi < b; ++bi) {
      float s = 0.f;
      for (int x = 0; x < gx; ++x) s += part_b[((size_t)bi * gx + x) * (nb + nf) + nb + i];
      out_f[(size_t)bi * nf + i] = s;
    }
  }
}

int wmax(const BwdArgs& a) { return max(a.H, max(a.C, a.R)); }

WgradArgs wgrad_args(const BwdArgs& a, float* part_w, int split_rows) {
  const int L = a.L, H = a.H, C = a.C, R = a.R, LH = L * H;
  const GradRow gr(L, H, C, R);
  const CotRow cr(L, H, C, R);
  WgradArgs w = {};
  w.xs = a.xs;
  w.rh = a.rh;
  w.rhc = a.rhc;
  w.dq = a.dq;
  w.part_w = part_w;
  w.rows = (long long)a.b * 2 * a.n * a.S;
  w.split_rows = split_rows;
  w.dld = cr.width;
  w.nw = gr.nw;
  int j = 0;
  w.job[j++] = GemmJob{0, kXW, 0, 3, 0, H, gr.w0};
  for (int l = 1; l < L; ++l) w.job[j++] = GemmJob{1, LH, (l - 1) * H, H, l * H, H, gr.wl + (l - 1) * H * H};
  w.job[j++] = GemmJob{1, LH, (L - 1) * H, H, cr.dac, C, gr.wc};
  w.job[j++] = GemmJob{1, LH, (L - 1) * H, H, cr.dsig, 1, gr.ws};
  w.job[j++] = GemmJob{2, C, 0, C, cr.drgb, R, gr.wr};
  w.njobs = j;
  return w;
}

template <typename T>
int launch(const BwdArgs& a, float* part_w, int nsplit, int split_rows, float* out_w,
           float* out_f, cudaStream_t stream) {
  if (a.S < 2 || a.S > cips_ray::kMaxSteps) return (int)cudaErrorInvalidValue;
  const CotLayout lay = CotLayout::make<T>(a);
  cudaError_t err = cips::raise_smem(ray_tile_bwd_cot<T>, lay.total);
  if (err != cudaSuccess) return (int)err;
  ray_tile_bwd_cot<T><<<dim3(a.gx, a.b), kThreads, lay.total, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const WgradArgs w = wgrad_args(a, part_w, split_rows);
  const size_t sm = wg_smem<T>(wmax(a), wmax(a));   // enough for every job
  err = cips::raise_smem(ray_tile_bwd_wgrad<T>, sm);
  if (err != cudaSuccess) return (int)err;
  ray_tile_bwd_wgrad<T><<<dim3(nsplit, w.njobs), kWThreads, sm, stream>>>(w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GradRow gr(a.L, a.H, a.C, a.R);
  const int total = gr.nw + gr.nb + gr.nf;
  ray_tile_bwd_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      part_w, nsplit, gr.nw, a.part_b, a.b, a.gx, gr.nb, gr.nf, out_w, out_f);
  return (int)cudaGetLastError();
}

}  // namespace

// Width of a point's cotangent row (elements) for these widths.
extern "C" int cips_ray_tile_backward_cot_width(int L, int H, int C, int R) {
  return CotRow(L, H, C, R).width;
}

// Shapes as in BwdArgs (noise as the forward's); rh, ra, rhc, rac in the layout of
// cips_ray_tile_forward's residuals (residual mode: the forward's; recompute
// mode: the wrapper's rerun of the forward).  xs (b, 2, n, S, 8) and dq
// (b, 2, n, S, cot_width) are mm-type scratch, part_b (b, gx, nb + nf) and
// part_w (nsplit, nw) f32 scratch, nsplit = ceil(b 2 n S / split_rows),
// split_rows a multiple of 32.  out_w (nw + nb) receives the weight and bias
// grads in wbuf/pbuf order, out_f (b, 2LH + 2C) the FiLM grads in films
// order.  Returns the CUDA error of the launches (0 on success).
extern "C" int cips_ray_tile_backward(
    const void* pts, const void* org, const void* dir, const void* z, const void* u,
    const void* nc, const void* nf, const void* noise, const void* wbuf, const void* pbuf,
    const void* films, const void* dfea, const void* ddep, const void* rh, const void* ra, const void* rhc,
    const void* rac, void* xs, void* dq, void* part_b, void* part_w, void* dpts, void* out_w,
    void* out_f, int b, int n, int S, int L, int H, int C, int R, int gx, int nsplit,
    int split_rows, int np, int nfilm, float warp_scale, int softplus,
    int white_back, int last_back, int flags, void* stream) {
  if (split_rows % cips_wgrad::kWRows != 0 || (long long)nsplit * split_rows < (long long)b * 2 * n * S)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.pts = static_cast<const float*>(pts);
  a.org = static_cast<const float*>(org);
  a.dir = static_cast<const float*>(dir);
  a.z = static_cast<const float*>(z);
  a.u = static_cast<const float*>(u);
  a.nc = static_cast<const float*>(nc);
  a.nf = static_cast<const float*>(nf);
  a.noise = static_cast<const float*>(noise);
  a.wbuf = wbuf;
  a.pbuf = static_cast<const float*>(pbuf);
  a.films = static_cast<const float*>(films);
  a.dfea = static_cast<const float*>(dfea);
  a.ddep = static_cast<const float*>(ddep);
  a.rh = rh;
  a.ra = static_cast<const float*>(ra);
  a.rhc = rhc;
  a.rac = static_cast<const float*>(rac);
  a.xs = xs;
  a.dq = dq;
  a.part_b = static_cast<float*>(part_b);
  a.dpts = static_cast<float*>(dpts);
  a.b = b; a.n = n; a.S = S; a.L = L; a.H = H; a.C = C; a.R = R; a.gx = gx;
  a.np = np; a.nfilm = nfilm;
  a.warp_scale = warp_scale;
  a.softplus = softplus;
  a.white_back = white_back;
  a.last_back = last_back;
  // flags: bit 0 use_noise, bit 1 fast_sin, bit 2 bf16 matmul inputs
  a.use_noise = flags & 1;
  a.fast_sin = (flags >> 1) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(part_w);
  float* ow = static_cast<float*>(out_w);
  float* of = static_cast<float*>(out_f);
  return (flags >> 2) & 1 ? launch<__nv_bfloat16>(a, pw, nsplit, split_rows, ow, of, st)
                          : launch<float>(a, pw, nsplit, split_rows, ow, of, st);
}

// Resident warps per SM, dynamic shared memory and threads (out[0..2]) of
// the cotangent kernel (which = 0) or of the weight-grad kernel at its
// largest job (which = 1), at these widths; flags bit 2: bf16.
extern "C" int cips_ray_tile_backward_occupancy(int which, int S, int L, int H, int C, int R,
                                                int flags, int* out) {
  BwdArgs a = {};
  a.S = S; a.L = L; a.H = H; a.C = C; a.R = R;
  a.np = L * H + C + R + 4;
  a.nfilm = 2 * L * H + 2 * C;
  const int nmax = wmax(a);
  if ((flags >> 2) & 1)
    return which == 0 ? cips::occupancy(ray_tile_bwd_cot<__nv_bfloat16>, kThreads,
                                        CotLayout::make<__nv_bfloat16>(a).total, out)
                      : cips::occupancy(ray_tile_bwd_wgrad<__nv_bfloat16>, kWThreads,
                                        wg_smem<__nv_bfloat16>(nmax, nmax), out);
  return which == 0 ? cips::occupancy(ray_tile_bwd_cot<float>, kThreads,
                                      CotLayout::make<float>(a).total, out)
                    : cips::occupancy(ray_tile_bwd_wgrad<float>, kWThreads,
                                      wg_smem<float>(nmax, nmax), out);
}

// Dynamic shared memory (bytes) of the resident cotangent kernel at these
// widths (flags bit 2: bf16), as cips_ray_tile_forward_smem.
extern "C" long long cips_ray_tile_backward_smem(int S, int L, int H, int C, int R, int flags) {
  BwdArgs a = {};
  a.S = S; a.L = L; a.H = H; a.C = C; a.R = R;
  a.np = L * H + C + R + 4;
  a.nfilm = 2 * L * H + 2 * C;
  return (long long)((flags >> 2) & 1 ? CotLayout::make<__nv_bfloat16>(a).total
                                      : CotLayout::make<float>(a).total);
}
