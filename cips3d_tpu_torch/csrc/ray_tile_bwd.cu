// Backward of the fused ray tile: the gradients of the NeRF stage's weights,
// biases and per-sample FiLM gains/shifts, and of the coarse points.
//
// Replaces: cips3d_tpu/ops/pallas/ray_tile.py::_ray_tile_bwd_kernel (entry
// _pallas_backward, the custom VJP of fused_ray_render), in both of its
// modes: recompute (`vjp_impl='pallas'`: the MLP states are recomputed
// from the points) and residual (`'pallas_residual'`: they are read from
// the residuals that ray_tile.cu's forward wrote).  Per block of 4 rays:
//   A. the forward again, for each pass's sigma and rgb (residual mode
//      reads the last hidden layer and the colour FiLM output instead of
//      recomputing them), with the same resample as the forward, so the
//      fine depths are those of the forward bit for bit;
//   B. compositing forward and backward, one warp per ray: d fea, d depth
//      -> d rgb and d sigma of every sample.  white_back, last_back, the
//      `(1 - alpha) > 1e-10` gate on d logx and the relu/softplus
//      derivative of the density clamp follow the Pallas kernel
//      (ray_tile.py:636-663);
//   C. the MLP backward of each pass, chunk by chunk (16 points): the
//      states come again from the recompute or the residuals, the grads
//      of rgb head -> colour FiLM -> sigma head -> hidden layers, with
//      the mm-type rounding of the Pallas kernel's `mlp_bwd` (ray_tile.py:
//      511-548).  The fine pass adds to the weight and FiLM grads only (its
//      points are detached); the coarse pass also gives d pts.
// The sigma head is the port's (H, 1) column, not the Pallas kernel's
// lane-padded (H, 8) block: its grad is (H, 1) and (1,).
//
// Order and determinism: on the TPU the weight grads add up in VMEM across
// a sequential grid.  Here the blocks run in parallel, so each block owns a
// row of a partial-sum buffer (b, gx, P) in device memory: grid (gx, b),
// block x walks the ray blocks x, x + gx, ... of its batch row, and every
// element of its row is read and written by one fixed thread, in a fixed
// order.  A second kernel sums the rows in a fixed order: over (b, gx) for
// the weights and biases, over gx for the per-sample FiLM grads.  No float
// atomics: two runs give the same bits.
//
// What bounds it on an H100: the MLP products.  Per point the backward
// needs about twice the forward's 27136 multiply-adds (the d-input and
// the d-weight products), so at r64, b = 4, S = 12 (0.39 M points over both
// passes) 42.7 GFLOP, 0.64 ms at the 67 TFLOP/s f32 FMA peak; recompute mode
// adds the forward's 21.3 GFLOP (0.96 ms in all).  Residual mode reads the
// residuals, 2560 B a point in f32 (1.0 GB, 0.30 ms at 3.35 TB/s).  This
// first version runs the products on the FMA units, with the weights
// (110 KB f32, rows padded by one so that a warp reading a column of a
// weight matrix hits 32 banks) in shared memory, and it recomputes or
// re-reads a chunk's states twice (phases A and C), since one block's
// states do not fit beside the weights: recompute mode runs the forward
// MLP twice here.  Each chunk adds its weight grads into the block's
// partial row (27 k floats, read and written once per 16-point chunk, in
// L2 while the rows of all resident blocks, 15 MB, fit there).
#include "common.cuh"
#include "fast_sin.cuh"
#include "ray_tile.cuh"

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kRays = 4;          // rays per block: one warp per ray in the per-ray stages
constexpr int kRows = 16;         // points per MLP chunk; warp w owns rows 4w..4w+3
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kColsPerLane = 4;   // layer widths up to 128

struct BwdArgs {
  const float *pts, *org, *dir, *z, *u, *nc, *nf;   // as the forward's
  const void* wbuf;    // mm type: w_0 (3,H), w_1.. (H,H), wc (H,C), wr (C,R), ws (H)
  const float* pbuf;   // b_0.. (H), bc (C), br (R), bs (1)
  const float* films;  // (b, nfilm): g_0, f_0, g_1, f_1, .. (H each), gc, fc (C each)
  const float* dfea;   // (b, n, R) cotangent of the feature
  const float* ddep;   // (b, n) cotangent of the depth
  const void* rh;      // residuals (residual mode) or null (recompute mode)
  const float* ra;
  const void* rhc;
  const float* rac;
  float* partial;      // (b, gx, P): per-block sums, P = nw + nb + nf
  float* dpts;         // (b, n, S, 3)
  int b, n, S, L, H, C, R, gx, nfilm;
  float noise_std, warp_scale;
  int softplus, white_back, last_back, use_noise, fast_sin;
};

// Offsets of the flat gradient row (the order of wbuf, pbuf and a films
// row): matrices, then biases, then FiLM gains and shifts.
struct GradRow {
  int w0, wl, wc, wr, ws, nw, bl, bc, br, bs, nb, fl, fc, nf, P;
  __host__ __device__ GradRow(int L, int H, int C, int R) {
    w0 = 0;
    wl = 3 * H;                       // w_l at wl + (l - 1) H^2
    wc = wl + (L - 1) * H * H;
    wr = wc + H * C;
    ws = wr + C * R;
    nw = ws + H;
    bl = nw;                          // b_l at bl + l H
    bc = bl + L * H;
    br = bc + C;
    bs = br + R;
    nb = L * H + C + R + 1;
    fl = nw + nb;                     // g_l at fl + 2 l H, f_l at fl + 2 l H + H
    fc = fl + 2 * L * H;              // gc at fc, fc at fc + C
    nf = 2 * L * H + 2 * C;
    P = nw + nb + nf;
  }
};

struct BwdLayout {
  // weights (mm type, rows padded by one), then f32 regions
  size_t w, p, f, x, A, Hh, ac, hc, d1, d2, drgb, dsig, sig, zall, sall, nfv, t1, t2, dsa, rank,
      uv, ncv, od, rgb, dfv, ddv, total;
  int ld;                             // row stride of d1, d2
  int pw_l, pw_c, pw_r, pw_s;         // padded offsets (elements) of w_1, wc, wr, ws
  __host__ __device__ BwdLayout(const BwdArgs& a, size_t tsize) {
    const int M = 2 * a.S, H = a.H, C = a.C, R = a.R, L = a.L;
    ld = H > C ? H : C;
    if (R > ld) ld = R;
    pw_l = 3 * (H + 1);
    pw_c = pw_l + (L - 1) * H * (H + 1);
    pw_r = pw_c + H * (C + 1);
    pw_s = pw_r + C * (R + 1);
    size_t off = 0;
    w = take(off, tsize * (pw_s + H));
    p = take(off, sizeof(float) * (L * H + C + R + 1));
    f = take(off, sizeof(float) * a.nfilm);
    x = take(off, sizeof(float) * kRows * 4);
    A = take(off, sizeof(float) * L * kRows * H);
    Hh = take(off, sizeof(float) * L * kRows * H);
    ac = take(off, sizeof(float) * kRows * C);
    hc = take(off, sizeof(float) * kRows * C);
    d1 = take(off, sizeof(float) * kRows * ld);
    d2 = take(off, sizeof(float) * kRows * ld);
    drgb = take(off, sizeof(float) * kRows * R);
    dsig = take(off, sizeof(float) * kRows);
    sig = take(off, sizeof(float) * kRows);
    zall = take(off, sizeof(float) * kRays * M);
    sall = take(off, sizeof(float) * kRays * M);
    nfv = take(off, sizeof(float) * kRays * M);
    t1 = take(off, sizeof(float) * kRays * M);
    t2 = take(off, sizeof(float) * kRays * M);
    dsa = take(off, sizeof(float) * kRays * M);
    rank = take(off, sizeof(int) * kRays * M);
    uv = take(off, sizeof(float) * kRays * a.S);
    ncv = take(off, sizeof(float) * kRays * a.S);
    od = take(off, sizeof(float) * kRays * 8);
    rgb = take(off, sizeof(float) * kRays * M * R);
    dfv = take(off, sizeof(float) * kRays * R);
    ddv = take(off, sizeof(float) * kRays);
    total = off;
  }
  __host__ __device__ static size_t take(size_t& off, size_t bytes) {
    const size_t o = off;
    off += cips::align16(bytes);
    return o;
  }
};

// First index i >= 0 with (off + i) % kThreads == threadIdx.x: element e of
// a block's partial row is read and written only by thread e % kThreads.
__device__ __forceinline__ int owned0(int off) {
  return (threadIdx.x + kThreads - off % kThreads) % kThreads;
}

// acc[i][j] = sum_k in[row][k] * W(k, c) for the chunk's rows of this warp
// (row = 4 warp + i) and c = lane + 32 j < N; W(k, c) = W[k ldw + c], or
// W[c ldw + k] with kTrans (a product with the transposed weight).
// The sum runs k = 0..K-1 from 0, as ray_tile.cu's chunk_layer.
template <typename T, bool kTrans>
__device__ __forceinline__ void rows_mm(const float* in, int ldi, int K, const T* W, int ldw,
                                        int N, float (&acc)[kRowsPerWarp][kColsPerLane]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xin = in + warp * kRowsPerWarp * ldi;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float w[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      w[j] = c < N ? cips::to_f(kTrans ? W[c * ldw + k] : W[k * ldw + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float xv = xin[i * ldi + k];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
    }
  }
}

// A FiLM-SIREN layer (or, without gain, a linear head) on the chunk:
// a = in W + bias (stored to aout if set), out = round_mm(sin(gain a + shift))
// or a.  The same arithmetic as ray_tile.cu's chunk_layer.
template <typename T>
__device__ void rows_layer(const float* in, int ldi, int K, const T* W, int ldw, int N,
                           const float* bias, const float* gain, const float* shift,
                           int fast_sin, float* aout, float* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[kRowsPerWarp][kColsPerLane];
  rows_mm<T, false>(in, ldi, K, W, ldw, N, acc);
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c >= N) continue;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      float v = acc[i][j] + bias[c];
      if (aout != nullptr) aout[row * ldo + c] = v;
      if (gain != nullptr) {
        const float arg = gain[c] * v + shift[c];
        v = cips::round_mm<T>(fast_sin ? cips_fast_sinf(arg) : sinf(arg));
      }
      out[row * ldo + c] = v;
    }
  }
}

// out[row][o] = sum_i d[row][i] W[o][i] (+ sv[row] wv[o]) for o < N: the
// d-input product of a layer whose weight is stored (N, K), rows padded.
template <typename T>
__device__ void rows_back(const float* d, int ldd, int K, const T* W, int ldw, int N, float* out,
                          int ldo, const float* sv = nullptr, const T* wv = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[kRowsPerWarp][kColsPerLane];
  rows_mm<T, true>(d, ldd, K, W, ldw, N, acc);
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c >= N) continue;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      float v = acc[i][j];
      if (sv != nullptr) v += sv[row] * cips::to_f(wv[c]);
      out[row * ldo + c] = v;
    }
  }
}

// part[off + k N + c] += sum_rows in[row][k] d[row][c]: a weight's grad.
__device__ void acc_outer(float* part, int off, const float* in, int ldi, int K, const float* d,
                          int ldd, int N) {
  for (int idx = owned0(off); idx < K * N; idx += kThreads) {
    const int k = idx / N, c = idx % N;
    float s = 0.f;
#pragma unroll 4
    for (int row = 0; row < kRows; ++row) s = fmaf(in[row * ldi + k], d[row * ldd + c], s);
    part[off + idx] += s;
  }
}

// part[off + c] += sum_rows d[row][c] (* m[row][c]) (* g[c]): a bias or FiLM grad.
__device__ void acc_cols(float* part, int off, const float* d, int ldd, int N,
                         const float* m = nullptr, int ldm = 0, const float* g = nullptr) {
  for (int c = owned0(off); c < N; c += kThreads) {
    float s = 0.f;
    for (int row = 0; row < kRows; ++row) {
      float v = d[row * ldd + c];
      if (m != nullptr) v *= m[row * ldm + c];
      if (g != nullptr) v *= g[c];
      s += v;
    }
    part[off + c] += s;
  }
}

__device__ __forceinline__ float sin_grad(float x, int fast_sin) {
  return fast_sin ? cips_fast_sin_gradf(x) : cosf(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ray_tile_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout lay(a, sizeof(T));
  const GradRow gr(a.L, a.H, a.C, a.R);
  T* wsm = reinterpret_cast<T*>(smem + lay.w);
  float* psm = reinterpret_cast<float*>(smem + lay.p);
  float* fsm = reinterpret_cast<float*>(smem + lay.f);
  float* xb = reinterpret_cast<float*>(smem + lay.x);       // [row][4]
  float* Ab = reinterpret_cast<float*>(smem + lay.A);       // [l][row][H] pre-activations
  float* Hb = reinterpret_cast<float*>(smem + lay.Hh);      // [l][row][H] layer outputs
  float* acb = reinterpret_cast<float*>(smem + lay.ac);     // [row][C]
  float* hcb = reinterpret_cast<float*>(smem + lay.hc);     // [row][C]
  float* d1 = reinterpret_cast<float*>(smem + lay.d1);      // [row][ld]
  float* d2 = reinterpret_cast<float*>(smem + lay.d2);
  float* drgb = reinterpret_cast<float*>(smem + lay.drgb);  // [row][R]
  float* dsig = reinterpret_cast<float*>(smem + lay.dsig);
  float* sig = reinterpret_cast<float*>(smem + lay.sig);
  float* zall = reinterpret_cast<float*>(smem + lay.zall);  // [ray][fine 0..S-1, coarse S..2S-1]
  float* sall = reinterpret_cast<float*>(smem + lay.sall);
  float* nfv = reinterpret_cast<float*>(smem + lay.nfv);
  float* t1 = reinterpret_cast<float*>(smem + lay.t1);
  float* t2 = reinterpret_cast<float*>(smem + lay.t2);      // compositing weights after phase B
  float* dsa = reinterpret_cast<float*>(smem + lay.dsa);    // d raw sigma per sample
  int* rank = reinterpret_cast<int*>(smem + lay.rank);
  float* uv = reinterpret_cast<float*>(smem + lay.uv);
  float* ncv = reinterpret_cast<float*>(smem + lay.ncv);
  float* od = reinterpret_cast<float*>(smem + lay.od);
  float* rgb = reinterpret_cast<float*>(smem + lay.rgb);    // [ray][slot][R]
  float* dfv = reinterpret_cast<float*>(smem + lay.dfv);    // [ray][R]
  float* ddv = reinterpret_cast<float*>(smem + lay.ddv);

  const int S = a.S, M = 2 * S, H = a.H, C = a.C, R = a.R, L = a.L, n = a.n, LH = L * H;
  const int ld = lay.ld, npts = kRays * S;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool res = a.rh != nullptr;
  const T* rh = static_cast<const T*>(a.rh);
  const T* rhc = static_cast<const T*>(a.rhc);
  float* part = a.partial + ((size_t)bi * a.gx + blockIdx.x) * gr.P;

  // weights into padded rows, biases, this batch row's films; zero this block's partial row
  {
    const T* wg = static_cast<const T*>(a.wbuf);
    auto copy_mat = [&](int dst, int src, int K, int N) {
      for (int i = tid; i < K * N; i += kThreads) wsm[dst + (i / N) * (N + 1) + i % N] = wg[src + i];
    };
    copy_mat(0, gr.w0, 3, H);
    for (int l = 1; l < L; ++l) copy_mat(lay.pw_l + (l - 1) * H * (H + 1), gr.wl + (l - 1) * H * H, H, H);
    copy_mat(lay.pw_c, gr.wc, H, C);
    copy_mat(lay.pw_r, gr.wr, C, R);
    for (int i = tid; i < H; i += kThreads) wsm[lay.pw_s + i] = wg[gr.ws + i];
    for (int i = tid; i < gr.nb; i += kThreads) psm[i] = a.pbuf[i];
    for (int i = tid; i < a.nfilm; i += kThreads) fsm[i] = a.films[(size_t)bi * a.nfilm + i];
    for (int i = tid; i < gr.P; i += kThreads) part[i] = 0.f;
  }
  __syncthreads();

  auto wmat = [&](int l) { return wsm + (l == 0 ? 0 : lay.pw_l + (l - 1) * H * (H + 1)); };
  const T* wc = wsm + lay.pw_c;
  const T* wr = wsm + lay.pw_r;
  const T* ws = wsm + lay.pw_s;
  const float* bc = psm + LH;
  const float* br = bc + C;
  const float bs = br[R];
  const float* gc = fsm + 2 * LH;
  const float* fcv = gc + C;

  const int nrb = (n + kRays - 1) / kRays;
  for (int rb = blockIdx.x; rb < nrb; rb += a.gx) {
    const int ray0 = rb * kRays;
    // point q of the block -> its residual row, or -1 (past the last ray)
    auto res_row = [&](bool fine, int q) -> long long {
      if (q >= npts) return -1;
      const int r = q / S, s = q % S;
      if (ray0 + r >= n) return -1;
      return (((long long)bi * 2 + fine) * n + ray0 + r) * S + s;
    };

    // per-ray inputs
    for (int i = tid; i < kRays * S; i += kThreads) {
      const int r = i / S, s = i % S, ray = ray0 + r;
      const bool ok = ray < n;
      const size_t idx = ((size_t)bi * n + ray) * S + s;
      zall[r * M + S + s] = ok ? a.z[idx] : 0.f;
      uv[i] = ok ? a.u[idx] : 0.f;
      ncv[i] = ok && a.use_noise ? a.nc[idx] : 0.f;
    }
    for (int i = tid; i < kRays * M; i += kThreads) {
      const int r = i / M, m = i % M, ray = ray0 + r;
      nfv[i] = ray < n && a.use_noise ? a.nf[((size_t)bi * n + ray) * M + m] : 0.f;
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

    // The MLP states of one chunk: x, a_l, h_l, ac, hc.  `full` = false
    // (phase A in residual mode) loads only h_{L-1} and hc.
    auto get_state = [&](bool fine, int q0, bool full) {
      for (int i = tid; i < kRows * 3; i += kThreads) {
        const int row = i / 3, c = i % 3, q = q0 + row;
        float v = 0.f;
        if (q < npts) {
          const int r = q / S, s = q % S, ray = ray0 + r;
          if (ray < n)
            v = fine ? od[r * 8 + c] + od[r * 8 + 4 + c] * zall[r * M + s]
                     : a.pts[(((size_t)bi * n + ray) * S + s) * 3 + c];
        }
        xb[row * 4 + c] = cips::round_mm<T>(v * a.warp_scale);   // UniformBoxWarp
      }
      if (res) {
        for (int i = tid; i < kRows * LH; i += kThreads) {
          const int row = i / LH, k = i % LH, l = k / H, c = k % H;
          if (!full && l != L - 1) continue;
          const long long g = res_row(fine, q0 + row);
          Ab[(l * kRows + row) * H + c] = g >= 0 ? a.ra[g * LH + k] : 0.f;
          Hb[(l * kRows + row) * H + c] = g >= 0 ? cips::to_f(rh[g * LH + k]) : 0.f;
        }
        for (int i = tid; i < kRows * C; i += kThreads) {
          const int row = i / C, c = i % C;
          const long long g = res_row(fine, q0 + row);
          acb[row * C + c] = g >= 0 && full ? a.rac[g * C + c] : 0.f;
          hcb[row * C + c] = g >= 0 ? cips::to_f(rhc[g * C + c]) : 0.f;
        }
        __syncthreads();
        return;
      }
      __syncthreads();
      for (int l = 0; l < L; ++l) {
        rows_layer<T>(l == 0 ? xb : Hb + (l - 1) * kRows * H, l == 0 ? 4 : H, l == 0 ? 3 : H,
                      wmat(l), H + 1, H, psm + l * H, fsm + 2 * l * H, fsm + 2 * l * H + H,
                      a.fast_sin, Ab + l * kRows * H, Hb + l * kRows * H, H);
        __syncthreads();
      }
      rows_layer<T>(Hb + (L - 1) * kRows * H, H, H, wc, C + 1, C, bc, gc, fcv, a.fast_sin, acb,
                    hcb, C);
      __syncthreads();
    };

    // ---- phase A: sigma and rgb of both passes, and the resample ----
    auto forward_pass = [&](bool fine) {
      for (int q0 = 0; q0 < npts; q0 += kRows) {
        get_state(fine, q0, false);
        const float* hl = Hb + (L - 1) * kRows * H;
        for (int i = 0; i < kRowsPerWarp; ++i) {   // sigma head
          const int row = warp * kRowsPerWarp + i;
          float v = 0.f;
          for (int k = lane; k < H; k += 32) v = fmaf(hl[row * H + k], cips::to_f(ws[k]), v);
          v = cips::warp_sum(v);
          if (lane == 0) sig[row] = v + bs;
        }
        rows_layer<T>(hcb, C, C, wr, R + 1, R, br, nullptr, nullptr, 0, nullptr, d1, ld);
        __syncthreads();
        for (int i = tid; i < kRows * R; i += kThreads) {
          const int row = i / R, c = i % R, q = q0 + row;
          if (q < npts) rgb[((q / S) * M + (fine ? q % S : S + q % S)) * R + c] = d1[row * ld + c];
        }
        for (int row = tid; row < kRows; row += kThreads) {
          const int q = q0 + row;
          if (q < npts) sall[(q / S) * M + (fine ? q % S : S + q % S)] = sig[row];
        }
        __syncthreads();
      }
    };
    forward_pass(false);
    cips_ray::resample_ray(zall + warp * M, sall + warp * M + S, uv + warp * S, ncv + warp * S,
                           t1 + warp * M, t2 + warp * M, S, a.use_noise, a.noise_std, a.softplus);
    __syncthreads();
    forward_pass(true);

    // ---- phase B: compositing forward and backward, warp = ray ----
    {
      const int r = warp;
      float wsum;
      const cips_ray::CompLane cl = cips_ray::composite_ray(
          zall + r * M, sall + r * M, nfv + r * M, t1 + r * M, rank + r * M, M, a.use_noise,
          a.noise_std, a.softplus, a.last_back, wsum);
      const float* rgr = rgb + r * M * R;
      const float* df = dfv + r * R;
      float dw0[2] = {0.f, 0.f}, lastpart = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j >= M) continue;
        float acc = 0.f;
        for (int c = 0; c < R; ++c) acc = fmaf(rgr[j * R + c], df[c], acc);
        dw0[t] = acc + ddv[r] * cl.z[t];                  // d w (after last_back)
        if (cl.rank[t] == M - 1) lastpart += dw0[t];
      }
      float dwsum = 0.f;                                   // d of the pre-last_back weight sum
      if (a.white_back) {
        float sdf = 0.f;
        for (int c = 0; c < R; ++c) sdf += df[c];
        dwsum -= sdf;
      }
      const float dlast = cips::warp_sum(lastpart);
      if (a.last_back) dwsum -= dlast;
      float* dacc = t1 + r * M;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j >= M) continue;
        dw0[t] += dwsum;
        t2[r * M + j] = cl.w[t];
        dacc[j] = cl.trans[t] * (dw0[t] * cl.alpha[t]);   // d of the log-transmittance sum
      }
      __syncwarp();
      const int* rk = rank + r * M;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j >= M) continue;
        float dlogx = 0.f;                                 // sum over the samples behind j
        for (int k = 0; k < M; ++k)
          if (rk[k] > cl.rank[t]) dlogx += dacc[k];
        float dalpha = dw0[t] * cl.trans[t];
        dalpha += (1.f - cl.alpha[t]) > 1e-10f ? -dlogx / fmaxf(1.f - cl.alpha[t], 1e-10f) : 0.f;
        const float ddens = dalpha * cl.delta[t] * cl.expd[t];
        dsa[r * M + j] = ddens * cips_ray::density_grad(cl.s[t], a.softplus);
      }
    }
    __syncthreads();

    // ---- phase C: MLP backward, fine pass then coarse pass ----
    for (int pass = 1; pass >= 0; --pass) {
      const bool fine = pass == 1;
      for (int q0 = 0; q0 < npts; q0 += kRows) {
        get_state(fine, q0, true);
        for (int i = tid; i < kRows * R; i += kThreads) {
          const int row = i / R, c = i % R, q = q0 + row;
          float v = 0.f;
          if (res_row(fine, q) >= 0) {
            const int r = q / S, slot = fine ? q % S : S + q % S;
            v = t2[r * M + slot] * dfv[r * R + c];
          }
          drgb[row * R + c] = v;
        }
        for (int row = tid; row < kRows; row += kThreads) {
          const int q = q0 + row;
          dsig[row] = res_row(fine, q) >= 0 ? dsa[(q / S) * M + (fine ? q % S : S + q % S)] : 0.f;
        }
        __syncthreads();
        // rgb head: d br from the f32 grads, then the mm-type rounding
        acc_cols(part, gr.br, drgb, R, R);
        if (gr.bs % kThreads == tid) {
          float s = 0.f;
          for (int row = 0; row < kRows; ++row) s += dsig[row];
          part[gr.bs] += s;
        }
        __syncthreads();
        for (int i = tid; i < kRows * R; i += kThreads) drgb[i] = cips::round_mm<T>(drgb[i]);
        for (int row = tid; row < kRows; row += kThreads) dsig[row] = cips::round_mm<T>(dsig[row]);
        __syncthreads();
        acc_outer(part, gr.wr, hcb, C, C, drgb, R, R);
        rows_back<T>(drgb, R, R, wr, R + 1, C, d1, ld);    // d hc
        __syncthreads();
        // colour FiLM
        for (int i = tid; i < kRows * C; i += kThreads) {
          const int row = i / C, c = i % C;
          d1[row * ld + c] *= sin_grad(gc[c] * acb[row * C + c] + fcv[c], a.fast_sin);
        }
        __syncthreads();
        acc_cols(part, gr.fc, d1, ld, C, acb, C);          // d gc
        acc_cols(part, gr.fc + C, d1, ld, C);              // d fc
        acc_cols(part, gr.bc, d1, ld, C, nullptr, 0, gc);  // d bc
        __syncthreads();
        for (int i = tid; i < kRows * C; i += kThreads) {
          const int row = i / C, c = i % C;
          d1[row * ld + c] = cips::round_mm<T>(d1[row * ld + c] * gc[c]);
        }
        __syncthreads();
        const float* hl = Hb + (L - 1) * kRows * H;
        acc_outer(part, gr.wc, hl, H, H, d1, ld, C);
        acc_outer(part, gr.ws, hl, H, H, dsig, 1, 1);
        rows_back<T>(d1, ld, C, wc, C + 1, H, d2, ld, dsig, ws);   // d h_{L-1}
        __syncthreads();
        // hidden layers, last to first
        float* dh = d2;
        float* dn = d1;
        for (int l = L - 1; l >= 0; --l) {
          const float* al = Ab + l * kRows * H;
          const float* g = fsm + 2 * l * H;
          for (int i = tid; i < kRows * H; i += kThreads) {
            const int row = i / H, c = i % H;
            dh[row * ld + c] *= sin_grad(g[c] * al[row * H + c] + g[H + c], a.fast_sin);
          }
          __syncthreads();
          acc_cols(part, gr.fl + 2 * l * H, dh, ld, H, al, H);   // d g_l
          acc_cols(part, gr.fl + 2 * l * H + H, dh, ld, H);      // d f_l
          acc_cols(part, gr.bl + l * H, dh, ld, H, nullptr, 0, g);  // d b_l
          __syncthreads();
          for (int i = tid; i < kRows * H; i += kThreads) {
            const int row = i / H, c = i % H;
            dh[row * ld + c] = cips::round_mm<T>(dh[row * ld + c] * g[c]);
          }
          __syncthreads();
          const int din = l == 0 ? 3 : H;
          acc_outer(part, l == 0 ? gr.w0 : gr.wl + (l - 1) * H * H,
                    l == 0 ? xb : Hb + (l - 1) * kRows * H, l == 0 ? 4 : H, din, dh, ld, H);
          if (l > 0 || !fine) rows_back<T>(dh, ld, H, wmat(l), H + 1, din, dn, ld);
          __syncthreads();
          float* t = dh; dh = dn; dn = t;
        }
        if (!fine) {   // d pts of the coarse points
          for (int i = tid; i < kRows * 3; i += kThreads) {
            const int row = i / 3, c = i % 3, q = q0 + row;
            if (res_row(false, q) >= 0)
              a.dpts[(((size_t)bi * n + ray0 + q / S) * S + q % S) * 3 + c] =
                  dh[row * ld + c] * a.warp_scale;
          }
        }
        __syncthreads();
      }
    }
  }
}

// out_w[e] = sum over (b, gx) of partial rows (e < nshared: weights and
// biases); out_f[bi][e - nshared] = sum over gx (FiLM grads of batch row bi).
__global__ void ray_tile_bwd_reduce(const float* partial, int b, int gx, int P, int nshared,
                                    float* out_w, float* out_f) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  if (e < nshared) {
    float s = 0.f;
    for (int r = 0; r < b * gx; ++r) s += partial[(size_t)r * P + e];
    out_w[e] = s;
  } else {
    for (int bi = 0; bi < b; ++bi) {
      float s = 0.f;
      for (int g = 0; g < gx; ++g) s += partial[((size_t)bi * gx + g) * P + e];
      out_f[(size_t)bi * (P - nshared) + e - nshared] = s;
    }
  }
}

template <typename T>
int launch(const BwdArgs& a, float* out_w, float* out_f, cudaStream_t stream) {
  const BwdLayout lay(a, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(ray_tile_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  ray_tile_bwd_kernel<T><<<dim3(a.gx, a.b), kThreads, lay.total, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GradRow gr(a.L, a.H, a.C, a.R);
  ray_tile_bwd_reduce<<<(gr.P + 255) / 256, 256, 0, stream>>>(a.partial, a.b, a.gx, gr.P,
                                                               gr.nw + gr.nb, out_w, out_f);
  return (int)cudaGetLastError();
}

}  // namespace

// Length of one partial-sum row (floats) for these widths.
extern "C" int cips_ray_tile_backward_row(int L, int H, int C, int R) {
  return GradRow(L, H, C, R).P;
}

// Shapes as in BwdArgs; rh, ra, rhc, rac all null (recompute) or all set
// (residual mode, the layout of cips_ray_tile_forward's residuals).
// partial is (b, gx, P) scratch; out_w (nw + nb) receives the weight and
// bias grads in wbuf/pbuf order, out_f (b, 2LH + 2C) the FiLM grads in
// films order.  Returns the CUDA error of the launches (0 on success).
extern "C" int cips_ray_tile_backward(
    const void* pts, const void* org, const void* dir, const void* z, const void* u,
    const void* nc, const void* nf, const void* wbuf, const void* pbuf, const void* films,
    const void* dfea, const void* ddep, const void* rh, const void* ra, const void* rhc,
    const void* rac, void* partial, void* dpts, void* out_w, void* out_f,
    int b, int n, int S, int L, int H, int C, int R, int gx, int nfilm,
    float noise_std, float warp_scale, int softplus, int white_back, int last_back, int flags,
    void* stream) {
  BwdArgs a;
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
  a.dfea = static_cast<const float*>(dfea);
  a.ddep = static_cast<const float*>(ddep);
  a.rh = rh;
  a.ra = static_cast<const float*>(ra);
  a.rhc = rhc;
  a.rac = static_cast<const float*>(rac);
  a.partial = static_cast<float*>(partial);
  a.dpts = static_cast<float*>(dpts);
  a.b = b; a.n = n; a.S = S; a.L = L; a.H = H; a.C = C; a.R = R; a.gx = gx; a.nfilm = nfilm;
  a.noise_std = noise_std;
  a.warp_scale = warp_scale;
  a.softplus = softplus;
  a.white_back = white_back;
  a.last_back = last_back;
  // flags: bit 0 use_noise, bit 1 fast_sin, bit 2 bf16 matmul inputs
  a.use_noise = flags & 1;
  a.fast_sin = (flags >> 1) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ow = static_cast<float*>(out_w);
  float* of = static_cast<float*>(out_f);
  return (flags >> 2) & 1 ? launch<__nv_bfloat16>(a, ow, of, st) : launch<float>(a, ow, of, st);
}
