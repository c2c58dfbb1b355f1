// The streamed path of the ray tile (#2, #2r) and of its backward (#3):
// every shape the Pallas kernels take, where the resident kernels
// (ray_tile.cu, ray_tile_bwd.cu) do not fit: S past 64, widths past 128, or
// the SIREN's weights past the shared memory (nerf_hidden_layers 3 at width
// 128 in f32).  Nothing here keeps a whole layer, a whole ray or a whole
// weight matrix on chip: shared memory is the same at every L, H, C, R and S.
//
// Replaces, for those shapes: cips3d_tpu/ops/pallas/ray_tile.py::
// _ray_tile_kernel (forward, with and without residuals) and
// _ray_tile_bwd_kernel (both modes).  The stages are the resident kernels',
// as a sequence of launches on one stream over device memory:
//   forward, per pass (coarse, then fine), point rows (b, 2, n, S):
//     each FiLM-SIREN layer as one tensor-core product (stream_gemm.cuh:
//     128 points a tile), its epilogue (bias, FiLM, sine, rounding) writing
//     the layer's output h (mm type) to the residual rows, or to a scratch
//     pair when no residuals are asked; with residuals and the exact sine
//     the product writes a = acc + b alone and film_sine takes the sine
//     after it; the sigma head by ray_mlp.cuh's sigma_head, a warp a point;
//     the colour FiLM and the rgb head as one launch (head_kernel: per
//     128-point tile the colour activations of each 64-column slab stay in
//     shared memory, rounded, and feed that slab's share of the rgb product
//     at once), or, with residuals and the exact sine, as the colour
//     product, its film_sine and the rgb product; between the passes the
//     resample, after them the compositing: a warp a ray, every per-sample
//     quantity in a row of device scratch (RayRow), loops over the samples
//     in the resident order (sample j on lane j % 32, the same serial prefix
//     sums), so no register array bounds S;
//   backward: sigma and rgb of both passes from the residuals, the per-ray
//     resample, compositing forward and backward (the resident phase B), the
//     rounded cotangents d rgb and d sigma, then per pass the d-input chain:
//     each layer's product with W^T writing x = d h (+ d sigma ws), then
//     film_backward at full occupancy (sin' of the layer, the rounded d a,
//     and each 128-row chunk's FiLM and bias sums in a fixed order); the
//     weight grads as products with X^T, the points as the depth (every
//     matrix of one width in one launch, split_rows points a split); and
//     column sums of every partial over the card, in a fixed order.  No
//     float atomics: two runs give the same bits.
// What bounds it on an H100 (PERF.md §6, tools/stream_split.py, depth 3,
// r64, b = 4, S = 12, f32): the products run on the tensor cores' issue,
// 3xTF32 on mma.sync, at 35 TFLOP/s (a K = 128 layer, forward or d-input,
// 182-184 us).  sinf's and cosf's range reductions in a product's epilogue
// ran at its 16 warps a SM with nothing to overlap them (180-300 us a
// product); here the exact sine and the whole FiLM backward run in launches
// of their own at up to 64 warps a SM (film_sine 80 us a layer,
// film_backward 122), the weight grads reuse the core's fragments, and the
// partials are summed over the card (about 40 us).  The weight grads take
// two fifths of #3's device time (1.69 of 4.24 ms), at the products' issue
// rate on 64- and 32-column tiles.
// The numerics are the resident kernels': the same products (3xTF32 with a
// fresh partial per k-step, or bf16 with f32 accumulation), roundings,
// floors and guards (max(1 - alpha, 1e-10), the `cdf < u` count with the
// denom < 1e-5 -> 1 guard, the successor delta and the 1e10 last delta).
// A forward and the backward that reads its residuals run the same
// sigma head and per-ray code, so the backward rebuilds the fine depths
// bit for bit.
#include "ray_mlp.cuh"
#include "ray_tile.cuh"
#include "stream_gemm.cuh"

#include <vector>

namespace {

using cips_stream::GemmArgs;
using cips_stream::Mat;
using cips_stream::Vec;

constexpr int kRayWarps = 8;                // rays per block of the per-ray kernels
constexpr int kRayThreads = 32 * kRayWarps;
constexpr int kXW = 8;                      // row of the point scratch (3 used)
constexpr int kSumGroups = 4;               // row groups of a batch row's FiLM and bias sums

// A ray's rows of device scratch, each of M = 2S floats, samples in [fine,
// coarse] arrival order (the rank row holds ints).
enum RayRow {
  kZ, kSraw, kSn, kLx, kPdf, kRank, kDelta, kExpd, kAlpha, kTrans, kW, kDw, kDacc, kDsig,
  kRayRows
};

struct Rows {
  float* base;
  int M;
  __device__ float* row(long long ray, int k) const { return base + (ray * kRayRows + k) * M; }
};

struct StreamArgs {
  const float *pts, *org, *dir, *z, *u, *nc, *nf;   // as the resident kernels'
  const float* noise;   // (1,) density-noise scale on the device
  const void* wbuf;     // mm type: w_0 (3,H), w_1.. (H,H), wc (H,C), wr (C,R), ws (H)
  const float* pbuf;    // b_0.. (H), bc (C), br (R), bs (1)
  const float* films;   // (b, nfilm): g_0, f_0, .. (H each), gc, fc (C each)
  int b, n, S, L, H, C, R, nfilm;
  float warp_scale;
  int softplus, white_back, last_back, use_noise, fast_sin, out_bf16;
  // forward
  void* fea;            // (b, n, R) out type
  float* depth;         // (b, n)
  void *rh, *rhc;       // residuals (b, 2, n, S, L H | C), or null
  float *ra, *rac;
  void* hbuf;           // (2, b n S, H) mm type: the layers' outputs without residuals
  // both
  void* xs;             // (b, 2, n, S, kXW) mm type: rounded, warped points
  float* sig;           // (b, 2, n, S) raw sigma
  float* rgb;           // (b, 2, n, S, R)
  float* rows;          // (b n, kRayRows, 2S)
  // backward
  const float *dfea, *ddep;   // (b, n, R), (b, n)
  void* dq;             // (b, 2, n, S, cot width) mm type: rounded cotangents
  float *fpart, *bpart; // (b, 2, nchunk, 3 (L H + C)), (b, 2, nchunk, R + 1)
  float* part_w;        // (nsplit, nw)
  float* sums;          // (b, kSumGroups, 3 (L H + C) + R + 1): fpart's and bpart's group sums
  float* xbuf;          // (b, n S, max(H, C)): a layer's d-input product before its FiLM backward
  float *dpts, *out_w, *out_f;
  int nsplit, split_rows;
};

// Offsets of the flat weight, bias and FiLM rows (wbuf, pbuf, films order).
struct Offsets {
  long long w0, wl, wc, wr, ws, nw;
  int b0, bc, br, bs, nb;
  int gc, nf;
  __host__ __device__ Offsets(int L, int H, int C, int R) {
    w0 = 0;
    wl = 3LL * H;                        // w_l at wl + (l - 1) H^2
    wc = wl + (long long)(L - 1) * H * H;
    wr = wc + (long long)H * C;
    ws = wr + (long long)C * R;
    nw = ws + H;
    b0 = 0;                              // b_l at l H
    bc = L * H;
    br = bc + C;
    bs = br + R;
    nb = bs + 1;
    gc = 2 * L * H;                      // g_l at 2 l H, f_l at 2 l H + H; fc at gc + C
    nf = gc + 2 * C;
  }
};

// Columns of a point's cotangent row, as ray_tile_bwd.cu's CotRow.
struct Cot {
  int dac, dsig, drgb, width;
  __host__ __device__ Cot(int L, int H, int C, int R) {
    dac = L * H;
    dsig = dac + C;
    drgb = dsig + 8;
    width = drgb + R;
  }
};

// ---- per-ray stages: a warp a ray, rows in device memory --------------------

// ray_tile.cuh's resample_ray at any S: the same arithmetic in the same
// order, the lane arrays kept in the pdf row (its upper half) instead.
__device__ void resample_any(float* zr, const float* sc, const float* uv, const float* ncv,
                             float* lx, float* pdf, int S, int use_noise, float noise_std,
                             int softplus) {
  const int lane = threadIdx.x & 31;
  float* alpha = pdf + S;
  for (int i = lane; i < S; i += 32) {
    const float zi = zr[S + i];
    const float delta = i < S - 1 ? zr[S + i + 1] - zi : 1e10f;
    float s = sc[i];
    if (use_noise) s += ncv[i] * noise_std;
    const float al = 1.f - expf(-delta * cips_ray::density(s, softplus));
    alpha[i] = al;
    lx[i] = logf(fmaxf(1.f - al, 1e-10f));
  }
  __syncwarp();
  float part = 0.f;   // the lane's share of the pdf total
  for (int i = lane; i < S; i += 32) {
    if (i < 1 || i > S - 2) continue;
    float acc = 0.f;
    for (int j = 0; j < i; ++j) acc += lx[j];
    const float wcv = alpha[i] * expf(acc);
    const float inner = (wcv + 1e-5f) + 1e-5f;
    alpha[i] = inner;
    part += inner;
  }
  const float total = cips::warp_sum(part);
  __syncwarp();
  for (int i = lane; i < S; i += 32)
    if (i >= 1 && i <= S - 2) pdf[i - 1] = alpha[i] / total;   // below S - 2 < S + 1
  __syncwarp();
  for (int i = lane; i < S - 1; i += 32) {   // cdf (S-1 edges), bin mid-points
    float c = 0.f;
    for (int k = 0; k < i; ++k) c += pdf[k];
    lx[i] = c;
    lx[S + i] = 0.5f * (zr[S + i] + zr[S + i + 1]);
  }
  __syncwarp();
  const int nb = S - 2;
  for (int i = lane; i < S; i += 32) {
    const float uu = uv[i];
    int inds = 0;
    for (int j = 0; j < S - 1; ++j) inds += lx[j] < uu;
    const int below = max(inds - 1, 0), above = min(inds, nb);
    const float cb = lx[below], ca = lx[above];
    const float zb = lx[S + below], za = lx[S + above];
    float denom = ca - cb;
    if (denom < 1e-5f) denom = 1.f;
    zr[i] = zb + (uu - cb) / denom * (za - zb);   // fine depth, unsorted
  }
  __syncwarp();
}

// ray_tile.cuh's composite_ray at any S: the ray's kZ and kSraw rows in,
// its rank, noisy sigma, delta, exp, alpha, transmittance and weight (after
// last_back) rows out; returns the weight sum before last_back.
__device__ float composite_any(const Rows& rows, long long ray, const float* nfr, int M,
                               int use_noise, float noise_std, int softplus, int last_back) {
  const int lane = threadIdx.x & 31;
  const float* zr = rows.row(ray, kZ);
  const float* sr = rows.row(ray, kSraw);
  float* sn = rows.row(ray, kSn);
  float* lx = rows.row(ray, kLx);
  int* rk = reinterpret_cast<int*>(rows.row(ray, kRank));
  float* dl = rows.row(ray, kDelta);
  float* ex = rows.row(ray, kExpd);
  float* al = rows.row(ray, kAlpha);
  float* tr = rows.row(ray, kTrans);
  float* wr = rows.row(ray, kW);
  for (int j = lane; j < M; j += 32) {
    const float zj = zr[j];
    int cnt = 0;
    for (int k = 0; k < M; ++k) {
      const float zk = zr[k];
      cnt += (zk < zj) || (zk == zj && k < j);
    }
    rk[j] = cnt;
    float sg = sr[j];
    if (use_noise) sg += nfr[j] * noise_std;
    sn[j] = sg;
  }
  __syncwarp();
  for (int j = lane; j < M; j += 32) {
    const int rj = rk[j];
    float delta = 1e10f;
    if (rj != M - 1) {
      for (int k = 0; k < M; ++k)
        if (rk[k] == rj + 1) delta = zr[k] - zr[j];
    }
    dl[j] = delta;
    const float e = expf(-delta * cips_ray::density(sn[j], softplus));
    ex[j] = e;
    const float a = 1.f - e;
    al[j] = a;
    lx[j] = logf(fmaxf(1.f - a, 1e-10f));
  }
  __syncwarp();
  float part = 0.f;
  for (int j = lane; j < M; j += 32) {
    const int rj = rk[j];
    float acc = 0.f;   // before[j, k] <=> rank_k < rank_j
    for (int k = 0; k < M; ++k)
      if (rk[k] < rj) acc += lx[k];
    const float t = expf(acc);
    tr[j] = t;
    const float w = al[j] * t;
    wr[j] = w;
    part += w;
  }
  const float wsum = cips::warp_sum(part);
  __syncwarp();
  if (last_back)
    for (int j = lane; j < M; j += 32)
      if (rk[j] == M - 1) wr[j] += 1.f - wsum;
  __syncwarp();
  return wsum;
}

__device__ __forceinline__ float noise_scale(const StreamArgs& a) {
  return a.use_noise ? __ldg(a.noise) : 0.f;
}

// The rounded, warped fine points of a ray (pass 1 of the point scratch).
template <typename T>
__device__ void fine_points(const StreamArgs& a, long long ray, const float* zr) {
  const int lane = threadIdx.x & 31, S = a.S;
  const long long bi = ray / a.n, r = ray % a.n, nS = (long long)a.n * S;
  const float* o = a.org + ray * 3;
  const float* d = a.dir + ray * 3;
  T* xs = static_cast<T*>(a.xs) + ((bi * 2 + 1) * nS + r * S) * kXW;
  for (int i = lane; i < S * kXW; i += 32) {
    const int s = i / kXW, c = i % kXW;
    float v = 0.f;
    if (c < 3) {
      const float p = o[c] + d[c] * zr[s];
      v = cips::round_mm<T>(p * a.warp_scale);   // UniformBoxWarp
    }
    xs[i] = cips::from_f<T>(v);
  }
}

// The coarse rows of a ray: depths and raw sigma (pass 0), and with `fine`
// also the fine pass's raw sigma.
__device__ void load_ray(const StreamArgs& a, const Rows& rows, long long ray, bool fine) {
  const int lane = threadIdx.x & 31, S = a.S;
  const long long bi = ray / a.n, r = ray % a.n, nS = (long long)a.n * S;
  float* zr = rows.row(ray, kZ);
  float* sr = rows.row(ray, kSraw);
  for (int i = lane; i < S; i += 32) {
    zr[S + i] = a.z[ray * S + i];
    sr[S + i] = a.sig[bi * 2 * nS + r * S + i];
    if (fine) sr[i] = a.sig[(bi * 2 + 1) * nS + r * S + i];
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kRayThreads) rays_resample(StreamArgs a, Rows rows) {
  const long long ray = (long long)blockIdx.x * kRayWarps + (threadIdx.x >> 5);
  if (ray >= (long long)a.b * a.n) return;
  load_ray(a, rows, ray, false);
  float* zr = rows.row(ray, kZ);
  resample_any(zr, rows.row(ray, kSraw) + a.S, a.u + ray * a.S, a.nc + ray * a.S,
               rows.row(ray, kLx), rows.row(ray, kPdf), a.S, a.use_noise, noise_scale(a),
               a.softplus);
  fine_points<T>(a, ray, zr);
}

// rgb of sample j of a ray ([fine, coarse] order)
__device__ __forceinline__ const float* rgb_row(const StreamArgs& a, long long ray, int j) {
  const long long bi = ray / a.n, r = ray % a.n, nS = (long long)a.n * a.S;
  const bool fine = j < a.S;
  return a.rgb + ((bi * 2 + fine) * nS + r * a.S + (fine ? j : j - a.S)) * a.R;
}

__global__ void __launch_bounds__(kRayThreads) rays_composite(StreamArgs a, Rows rows) {
  const long long ray = (long long)blockIdx.x * kRayWarps + (threadIdx.x >> 5);
  if (ray >= (long long)a.b * a.n) return;
  const int lane = threadIdx.x & 31, S = a.S, M = 2 * S, R = a.R;
  const long long bi = ray / a.n, r = ray % a.n, nS = (long long)a.n * S;
  float* sr = rows.row(ray, kSraw);
  for (int i = lane; i < S; i += 32) sr[i] = a.sig[(bi * 2 + 1) * nS + r * S + i];
  __syncwarp();
  const float wsum = composite_any(rows, ray, a.nf + ray * M, M, a.use_noise, noise_scale(a),
                                   a.softplus, a.last_back);
  const float* zr = rows.row(ray, kZ);
  const float* wt = rows.row(ray, kW);
  float dpart = 0.f;
  for (int j = lane; j < M; j += 32) dpart += wt[j] * zr[j];
  const float dep = cips::warp_sum(dpart);
  for (int c = lane; c < R; c += 32) {
    float acc = 0.f;
    for (int j = 0; j < M; ++j) acc = fmaf(wt[j], rgb_row(a, ray, j)[c], acc);
    if (a.white_back) acc += 1.f - wsum;
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.fea)[ray * R + c] = __float2bfloat16_rn(acc);
    else
      static_cast<float*>(a.fea)[ray * R + c] = acc;
  }
  if (lane == 0) a.depth[ray] = dep;
}

// The backward's per-ray stages (ray_tile_bwd.cu, phases A's resample and
// B): the fine depths and points again, then d w and d raw sigma of every
// sample into the kW and kDsig rows.
template <typename T>
__global__ void __launch_bounds__(kRayThreads) rays_backward(StreamArgs a, Rows rows) {
  const long long ray = (long long)blockIdx.x * kRayWarps + (threadIdx.x >> 5);
  if (ray >= (long long)a.b * a.n) return;
  const int lane = threadIdx.x & 31, S = a.S, M = 2 * S, R = a.R;
  const float noise_std = noise_scale(a);
  load_ray(a, rows, ray, true);
  float* zr = rows.row(ray, kZ);
  resample_any(zr, rows.row(ray, kSraw) + S, a.u + ray * S, a.nc + ray * S, rows.row(ray, kLx),
               rows.row(ray, kPdf), S, a.use_noise, noise_std, a.softplus);
  fine_points<T>(a, ray, zr);
  const float* df = a.dfea + ray * R;
  float* dw = rows.row(ray, kDw);
  for (int j = lane; j < M; j += 32) {   // rgb . d fea
    const float* rg = rgb_row(a, ray, j);
    float dot = 0.f;
    for (int c = 0; c < R; ++c) dot = fmaf(rg[c], df[c], dot);
    dw[j] = dot;
  }
  __syncwarp();
  composite_any(rows, ray, a.nf + ray * M, M, a.use_noise, noise_std, a.softplus, a.last_back);
  const int* rk = reinterpret_cast<const int*>(rows.row(ray, kRank));
  const float* tr = rows.row(ray, kTrans);
  const float* al = rows.row(ray, kAlpha);
  const float ddv = a.ddep[ray];
  float lastpart = 0.f;
  for (int j = lane; j < M; j += 32) {
    const float v = dw[j] + ddv * zr[j];   // d w (after last_back)
    dw[j] = v;
    if (rk[j] == M - 1) lastpart += v;
  }
  float dwsum = 0.f;                       // d of the pre-last_back weight sum
  if (a.white_back) {
    float sdf = 0.f;
    for (int c = 0; c < R; ++c) sdf += df[c];
    dwsum -= sdf;
  }
  const float dlast = cips::warp_sum(lastpart);
  if (a.last_back) dwsum -= dlast;
  float* dacc = rows.row(ray, kDacc);
  for (int j = lane; j < M; j += 32) {
    const float v = dw[j] + dwsum;
    dw[j] = v;
    dacc[j] = tr[j] * (v * al[j]);        // d of the log-transmittance sum
  }
  __syncwarp();
  const float* dl = rows.row(ray, kDelta);
  const float* ex = rows.row(ray, kExpd);
  const float* sn = rows.row(ray, kSn);
  float* dsa = rows.row(ray, kDsig);
  for (int j = lane; j < M; j += 32) {
    float dlogx = 0.f;                     // sum over the samples behind j
    for (int k = 0; k < M; ++k)
      if (rk[k] > rk[j]) dlogx += dacc[k];
    float dalpha = dw[j] * tr[j];
    dalpha += (1.f - al[j]) > 1e-10f ? -dlogx / fmaxf(1.f - al[j], 1e-10f) : 0.f;
    const float ddens = dalpha * dl[j] * ex[j];
    dsa[j] = ddens * cips_ray::density_grad(sn[j], a.softplus);
  }
}

// The coarse pass of the point scratch: round(pts * warp_scale), zeros past 3.
template <typename T>
__global__ void coarse_points(StreamArgs a) {
  const long long nS = (long long)a.n * a.S;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b * nS * kXW) return;
  const long long p = i / kXW, bi = p / nS, q = p % nS;
  const int c = i % kXW;
  const float v = c < 3 ? cips::round_mm<T>(a.pts[p * 3 + c] * a.warp_scale) : 0.f;
  static_cast<T*>(a.xs)[(bi * 2 * nS + q) * kXW + c] = cips::from_f<T>(v);
}

// Raw sigma of nrows points of each of gridDim.y batch rows, a warp a
// point: ray_mlp.cuh's sigma head on the layer-L output rows h.
template <typename T>
__global__ void __launch_bounds__(kRayThreads) sigma_rows(Mat h, const T* ws, const float* bs,
                                                          int H, int nrows, Mat sig) {
  const int r = blockIdx.x * kRayWarps + (threadIdx.x >> 5), z = blockIdx.y;
  if (r >= nrows) return;
  const float v = cips_mlp::sigma_head(h.at<T>(z, r), ws, H, __ldg(bs));
  if ((threadIdx.x & 31) == 0) *sig.at<float>(z, r) = v;
}

// The exact sine of a FiLM layer after its kFilmA product (which wrote a =
// acc + b): h = round(sin(g a + f)), at the card's full occupancy, where
// sinf's range reduction in the product's epilogue would stall its tile.
// The same sinf and roundings as the fused epilogue.  Four columns a
// thread; grid (rows N / 4 over 256 threads, batch rows).
template <typename T>
__global__ void __launch_bounds__(256) film_sine(Mat a_in, Mat out, Vec gain, Vec shift, int nrows,
                                                 int N) {
  const int z = blockIdx.y, nq = N / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nrows * nq) return;
  const int r = (int)(i / nq), c = (int)(i % nq) * 4;
  const float4 av = *reinterpret_cast<const float4*>(a_in.at<float>(z, r) + c);
  const float4 gv = __ldg(reinterpret_cast<const float4*>(gain.at(z) + c));
  const float4 fv = __ldg(reinterpret_cast<const float4*>(shift.at(z) + c));
  T* o = out.at<T>(z, r) + c;
  cips_stream::store2<T>(o, cips::round_mm<T>(sinf(gv.x * av.x + fv.x)),
                         cips::round_mm<T>(sinf(gv.y * av.y + fv.y)));
  cips_stream::store2<T>(o + 2, cips::round_mm<T>(sinf(gv.z * av.z + fv.z)),
                         cips::round_mm<T>(sinf(gv.w * av.w + fv.w)));
}

template <typename T>
cudaError_t film_sine_launch(Mat a_in, Mat out, Vec gain, Vec shift, long long nrows, int N,
                             int nz, cudaStream_t st) {
  film_sine<T><<<dim3((unsigned)((nrows * (N / 4) + 255) / 256), nz), 256, 0, st>>>(
      a_in, out, gain, shift, (int)nrows, N);
  return cudaGetLastError();
}

// The FiLM backward of a layer after its d-input product (kFilmBwd wrote x =
// d h + d sigma ws, f32), at the card's full occupancy: d arg = x sin'(g a +
// f), round(d arg g) to the cotangent rows, and per 128-row chunk the sums
// d g = sum d arg a, d f = sum d arg, d b = sum d arg g into the chunk's
// partial row (part: [d g | d f | d b] of N each).  A block a (chunk, 128
// columns, batch row): a thread a column pair, four row groups of 32 rows,
// each summed in order, then the groups in order.  No atomics.
template <typename T, bool kFast>
__global__ void __launch_bounds__(256) film_backward(Mat x, Mat ares, Mat out, Vec gain, Vec shift,
                                                Mat part, int nrows, int N) {
  __shared__ float red[4][3][128];
  const int chunk = blockIdx.x, c0 = blockIdx.y * 128, z = blockIdx.z;
  const int cp = threadIdx.x & 63, grp = threadIdx.x >> 6, col = c0 + 2 * cp;
  const int r0 = chunk * cips_stream::kRows, nrow = min(cips_stream::kRows, nrows - r0);
  float s[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  if (col < N) {
    const float2 gv = __ldg(reinterpret_cast<const float2*>(gain.at(z) + col));
    const float2 fv = __ldg(reinterpret_cast<const float2*>(shift.at(z) + col));
    const int rend = min(nrow, 32 * grp + 32);
#pragma unroll 4
    for (int i = 32 * grp; i < rend; ++i) {
      const int r = r0 + i;
      const float2 xv = *reinterpret_cast<const float2*>(x.at<float>(z, r) + col);
      const float2 av = *reinterpret_cast<const float2*>(ares.at<float>(z, r) + col);
      const float d0 = xv.x * cips_stream::sin_grad<kFast>(gv.x * av.x + fv.x);
      const float d1 = xv.y * cips_stream::sin_grad<kFast>(gv.y * av.y + fv.y);
      const float da0 = d0 * gv.x, da1 = d1 * gv.y;
      cips_stream::store2<T>(out.at<T>(z, r) + col, cips::round_mm<T>(da0), cips::round_mm<T>(da1));
      s[0][0] += d0 * av.x;
      s[0][1] += d1 * av.y;
      s[1][0] += d0;
      s[1][1] += d1;
      s[2][0] += da0;
      s[2][1] += da1;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    red[grp][k][2 * cp] = s[k][0];
    red[grp][k][2 * cp + 1] = s[k][1];
  }
  __syncthreads();
  float* pr = part.at<float>(z, chunk);
  for (int i = threadIdx.x; i < 3 * 128; i += 256) {
    const int k = i / 128, lc = i % 128;
    if (c0 + lc >= N) continue;
    pr[k * N + c0 + lc] = ((red[0][k][lc] + red[1][k][lc]) + red[2][k][lc]) + red[3][k][lc];
  }
}

// d rgb = w d fea and d sigma of one 128-point chunk of one pass: their
// sums (d br, d bs: a lane a column, the block's warps across the rows,
// then the warps in order) and their rounded values in the cotangent rows.
// Grid (nchunk, 2, b).
template <typename T>
__global__ void __launch_bounds__(kRayThreads) bwd_prep(StreamArgs a, Rows rows, int nchunk) {
  const int chunk = blockIdx.x, pass = blockIdx.y, bi = blockIdx.z, S = a.S, R = a.R;
  const int nS = a.n * S, q0 = chunk * cips_stream::kRows;
  const int nrow = min(cips_stream::kRows, nS - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Cot cot(a.L, a.H, a.C, R);
  auto at = [&](int i, long long& ray) {   // the chunk's row i: its ray and sample slot
    const int q = q0 + i;
    ray = (long long)bi * a.n + q / S;
    return pass ? q % S : S + q % S;
  };
  float* bp = a.bpart + (((long long)bi * 2 + pass) * nchunk + chunk) * (R + 1);
  T* dq = static_cast<T*>(a.dq) + (((long long)bi * 2 + pass) * nS + q0) * cot.width;
  __shared__ float red[kRayWarps][32];
  // a lane a column (d rgb, d sigma and its 7 zeros); warp w takes rows w, w + 8, ..
  for (int c0 = 0; c0 < R + 8; c0 += 32) {
    const int c = c0 + lane;
    float s = 0.f;
    for (int i = warp; i < nrow; i += kRayWarps) {
      long long ray;
      const int j = at(i, ray);
      T* d = dq + (long long)i * cot.width;
      if (c < R) {
        const float v = rows.row(ray, kW)[j] * a.dfea[ray * R + c];
        s += v;
        d[cot.drgb + c] = cips::from_f<T>(cips::round_mm<T>(v));
      } else if (c == R) {
        const float v = rows.row(ray, kDsig)[j];
        s += v;
        d[cot.dsig] = cips::from_f<T>(cips::round_mm<T>(v));
      } else if (c < R + 8) {
        d[cot.dsig + c - R] = cips::from_f<T>(0.f);
      }
    }
    red[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c <= R) {   // the warps' sums in order
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kRayWarps; ++w) t += red[w][lane];
      bp[c] = t;
    }
    __syncthreads();
  }
}

// ---- every sum in a fixed order, spread over the card --------------------------

// out[(z groups + q) ncols + c] = the sum over rows [q gr, (q + 1) gr) of batch
// row z's nrows rows of `in` ((nz, nrows, ncols) f32), gr = ceil(nrows /
// groups): warp w of the block sums rows w, w + 8, .. in order, a lane a
// column, then the 8 warps' sums in order.  No atomics.  Grid: (column
// blocks of 32, nz groups).
__global__ void __launch_bounds__(256) col_sums(const float* in, int nrows, int ncols, int groups,
                                                float* out) {
  __shared__ float red[8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane, z = blockIdx.y / groups, q = blockIdx.y % groups;
  const int gr = (nrows + groups - 1) / groups, rend = min(nrows, (q + 1) * gr);
  float s = 0.f;
  if (c < ncols) {
    const float* p = in + (long long)z * nrows * ncols + c;
#pragma unroll 4
    for (int r = q * gr + warp; r < rend; r += 8) s += p[(long long)r * ncols];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < ncols) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][lane];
    out[(long long)blockIdx.y * ncols + c] = t;
  }
}

// From the group sums of fpart and bpart (col_sums): out_w's bias grads over
// every batch row's groups in order, out_f[bi] batch row bi's FiLM grads over
// its groups.  A thread an element.
__global__ void bwd_gather(const float* sums, int b, int L, int H, int C, int R, float* out_w,
                           float* out_f) {
  const Offsets o(L, H, C, R);
  const int LH = L * H, nsum = 3 * (LH + C), G = kSumGroups;
  const float* sb = sums + (long long)b * G * nsum;   // bpart's group sums
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < o.nb) {
    float s = 0.f;
    if (e < LH + C) {
      const int col = e < LH ? 3 * (e / H) * H + 2 * H + e % H : 3 * LH + 2 * C + e - LH;
      for (int r = 0; r < b * G; ++r) s += sums[(long long)r * nsum + col];
    } else {
      for (int r = 0; r < b * G; ++r) s += sb[(long long)r * (R + 1) + e - LH - C];
    }
    out_w[o.nw + e] = s;
  } else if (e < o.nb + b * o.nf) {
    const int bi = (e - o.nb) / o.nf, i = (e - o.nb) % o.nf;
    const int col = i < 2 * LH ? 3 * (i / (2 * H)) * H + i % (2 * H) : 3 * LH + i - 2 * LH;
    float s = 0.f;
    for (int q = 0; q < G; ++q) s += sums[((long long)bi * G + q) * nsum + col];
    out_f[(long long)bi * o.nf + i] = s;
  }
}

// ---- the colour FiLM and the rgb head: one launch over a row tile ----------

constexpr int kHeadC = 64;   // colour columns a slab: 8 warps of 32 rows x 32 columns
constexpr int kHeadR = 32;   // rgb columns a slab: 8 warps of 16 rows x 32 columns

struct HeadArgs {
  cips_stream::Mat h;     // h_{L-1} (mm type): the colour FiLM's A
  const void *wc, *wr;    // (H, C), (C, R), mm type
  const float *bc, *br;
  cips_stream::Vec gc, fc;
  cips_stream::Mat hc, ac;   // the residuals rhc (mm type) and rac (f32), or p null
  cips_stream::Mat rgb;      // (rows, R) f32
  int nrows, H, C, R, fast_sin;
};

template <typename T>
__host__ __device__ constexpr int head_ld() {   // the colour slab's row stride (elements)
  return kHeadC + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t head_ring() {
  using namespace cips_stream;
  return Tile<T, T, false, kHeadC>::kBytes > Tile<T, T, false, kHeadR>::kBytes
             ? Tile<T, T, false, kHeadC>::kBytes
             : Tile<T, T, false, kHeadR>::kBytes;
}

template <typename T>
__host__ __device__ constexpr size_t head_smem() {
  return head_ring<T>() + cips_stream::al16(sizeof(T) * cips_stream::kRows * head_ld<T>());
}

// Per 128-row tile: each 64-wide slab of the colour FiLM (stream_gemm.cuh's
// product and kFilm epilogue) into shared memory, rounded, then that slab's
// share of the rgb head's product from it, the rgb sums kept in registers
// across the slabs (the k order of one product over C); rgb slabs past 32
// columns run the colour slabs again.  The colour activations never leave
// the chip but as residuals.  Grid: row tiles, batch rows.
template <typename T, bool kFast>
__global__ void __launch_bounds__(cips_stream::kThreads, 2) head_kernel(HeadArgs a) {
  using namespace cips_stream;
  using CC = Tile<T, T, false, kHeadC>;
  using CR = Tile<T, T, false, kHeadR>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* hcs = reinterpret_cast<T*>(smem + head_ring<T>());
  constexpr int LH = head_ld<T>();
  const int z = blockIdx.y, r0 = blockIdx.x * kRows, nrow = min(kRows, a.nrows - r0);
  const Frag<CC> fc;
  const Frag<CR> fr;
  const ASrc<T> A{a.h.at<T>(z, r0), a.h.ld, nrow, a.H, nullptr};
  const ASrc<T> Ah{nullptr, LH, kRows, kHeadC, hcs};
  const float* gv = a.gc.at(z);
  const float* sv = a.fc.at(z);
  for (int n0r = 0; n0r < a.R; n0r += kHeadR) {
    Acc<CR> racc;
    zero<CR>(racc);
    for (int n0c = 0; n0c < a.C; n0c += kHeadC) {
      Acc<CC> cacc;
      zero<CC>(cacc);
      tile_product<T, T, false, kHeadC, false>(cacc, smem, A, static_cast<const T*>(a.wc), a.C,
                                               a.H, a.H, a.C, n0c, nullptr);
      const int kc = min(kHeadC, a.C - n0c);
#pragma unroll
      for (int i = 0; i < CC::kMT; ++i)
#pragma unroll
        for (int j = 0; j < CC::kNT; ++j) {
          if (8 * fc.nt(j) >= kc) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = fc.row(i, 2 * hh), lc = fc.col(j, 0), col = n0c + lc;
            const float a0 = cacc[i][j][2 * hh] + __ldg(a.bc + col);
            const float a1 = cacc[i][j][2 * hh + 1] + __ldg(a.bc + col + 1);
            const float h0 =
                cips::round_mm<T>(film_sin<kFast>(__ldg(gv + col) * a0 + __ldg(sv + col)));
            const float h1 = cips::round_mm<T>(
                film_sin<kFast>(__ldg(gv + col + 1) * a1 + __ldg(sv + col + 1)));
            store2<T>(hcs + row * LH + lc, h0, h1);
            if (a.hc.p && n0r == 0 && row < nrow) {
              store2<T>(a.hc.at<T>(z, r0 + row) + col, h0, h1);
              store2<float>(a.ac.at<float>(z, r0 + row) + col, a0, a1);
            }
          }
        }
      __syncthreads();
      tile_product<T, T, false, kHeadR, false>(racc, smem, Ah,
                                               static_cast<const T*>(a.wr) + (long long)n0c * a.R,
                                               a.R, kc, kc, a.R, n0r, nullptr);
    }
    const int nr = min(kHeadR, a.R - n0r);
#pragma unroll
    for (int j = 0; j < CR::kNT; ++j) {
      if (8 * fr.nt(j) >= nr) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = fr.row(0, 2 * hh), col = n0r + fr.col(j, 0);
        if (row < nrow)
          store2<float>(a.rgb.at<float>(z, r0 + row) + col, racc[0][j][2 * hh] + __ldg(a.br + col),
                        racc[0][j][2 * hh + 1] + __ldg(a.br + col + 1));
      }
    }
  }
}

template <typename T, bool kFast>
cudaError_t head_launch(const HeadArgs& a, int nz, cudaStream_t st) {
  using namespace cips_stream;
  constexpr size_t sm = head_smem<T>();
  cudaError_t err = prep_kernel(head_kernel<T, kFast>, sm);
  if (err != cudaSuccess) return err;
  head_kernel<T, kFast><<<dim3((a.nrows + kRows - 1) / kRows, nz), kThreads, sm, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t head(const HeadArgs& a, int nz, cudaStream_t st) {
  return a.fast_sin ? head_launch<T, true>(a, nz, st) : head_launch<T, false>(a, nz, st);
}

// ---- the sequences ----------------------------------------------------------

template <typename T>
const T* wmat(const StreamArgs& a, long long off) {
  return static_cast<const T*>(a.wbuf) + off;
}

int ray_blocks(const StreamArgs& a) {
  return (int)(((long long)a.b * a.n + kRayWarps - 1) / kRayWarps);
}

template <typename T>
int stream_forward(const StreamArgs& a, cudaStream_t st) {
  using namespace cips_stream;
  const int L = a.L, H = a.H, C = a.C, R = a.R, LH = L * H;
  const long long nS = (long long)a.n * a.S, all = 2 * a.b * nS;
  const Offsets o(L, H, C, R);
  const bool res = a.rh != nullptr;
  // with residuals and the exact sine, each FiLM layer is a product that writes a = acc + b and
  // film_sine after it, and the head runs as the colour product, its sine and the rgb product
  // (the same bits as the fused epilogues); else the sine in the products' epilogues
  const bool split = res && !a.fast_sin;
  const Rows rows{a.rows, 2 * a.S};
  coarse_points<T><<<(unsigned)((a.b * nS * kXW + 255) / 256), 256, 0, st>>>(a);
  CIPS_TRY(cudaGetLastError());
  for (int pass = 0; pass < 2; ++pass) {
    const long long p0 = pass * nS;
    // a layer's output rows: the residuals, or a pair of scratch rows per point
    auto hmat = [&](int l) {
      return res ? Mat{a.rh, 2 * nS, p0, LH, l * H}
                 : Mat{static_cast<T*>(a.hbuf) + (l & 1) * (all / 2) * H, nS, 0, H, 0};
    };
    for (int l = 0; l < L; ++l) {
      GemmArgs g = {};
      g.a = l == 0 ? Mat{a.xs, 2 * nS, p0, kXW, 0} : hmat(l - 1);
      g.akvalid = l == 0 ? kXW : H;
      g.w = wmat<T>(a, l == 0 ? o.w0 : o.wl + (long long)(l - 1) * H * H);
      g.ldw = H;
      g.wvalid = l == 0 ? 3 : H;
      g.nrows = (int)nS;
      g.K = l == 0 ? cips_mlp::kK0 : H;
      g.N = H;
      g.out = hmat(l);
      if (res) g.out_a = Mat{a.ra, 2 * nS, p0, LH, l * H};
      g.bias = Vec{a.pbuf + o.b0 + l * H, 0};
      g.gain = Vec{a.films + 2 * l * H, a.nfilm};
      g.shift = Vec{a.films + 2 * l * H + H, a.nfilm};
      g.fast_sin = a.fast_sin;
      if (split) {   // the exact sine apart, at full occupancy
        CIPS_TRY((gemm<T, T, false, kFilmA>(g, a.b, st)));
        CIPS_TRY((film_sine_launch<T>(g.out_a, g.out, g.gain, g.shift, nS, H, a.b, st)));
      } else {
        CIPS_TRY((gemm<T, T, false, kFilm>(g, a.b, st)));
      }
    }
    sigma_rows<T><<<dim3((unsigned)((nS + kRayWarps - 1) / kRayWarps), a.b), kRayThreads, 0, st>>>(
        hmat(L - 1), wmat<T>(a, o.ws), a.pbuf + o.bs, H, (int)nS, Mat{a.sig, 2 * nS, p0, 1, 0});
    CIPS_TRY(cudaGetLastError());
    if (split) {   // the colour FiLM's product, its sine, the rgb product
      GemmArgs g = {};
      g.a = hmat(L - 1);
      g.akvalid = H;
      g.w = wmat<T>(a, o.wc);
      g.ldw = C;
      g.wvalid = H;
      g.nrows = (int)nS;
      g.K = H;
      g.N = C;
      g.out_a = Mat{a.rac, 2 * nS, p0, C, 0};
      g.bias = Vec{a.pbuf + o.bc, 0};
      g.gain = Vec{a.films + o.gc, a.nfilm};
      g.shift = Vec{a.films + o.gc + C, a.nfilm};
      CIPS_TRY((gemm<T, T, false, kFilmA>(g, a.b, st)));
      const Mat hc{a.rhc, 2 * nS, p0, C, 0};
      CIPS_TRY((film_sine_launch<T>(g.out_a, hc, g.gain, g.shift, nS, C, a.b, st)));
      GemmArgs q = {};
      q.a = hc;
      q.akvalid = C;
      q.w = wmat<T>(a, o.wr);
      q.ldw = R;
      q.wvalid = C;
      q.nrows = (int)nS;
      q.K = C;
      q.N = R;
      q.out = Mat{a.rgb, 2 * nS, p0, R, 0};
      q.bias = Vec{a.pbuf + o.br, 0};
      CIPS_TRY((gemm<T, T, false, kLinear>(q, a.b, st)));
      if (pass == 0) {
        rays_resample<T><<<ray_blocks(a), kRayThreads, 0, st>>>(a, rows);
        CIPS_TRY(cudaGetLastError());
      }
      continue;
    }
    HeadArgs hd = {};   // the colour FiLM and the rgb head
    hd.h = hmat(L - 1);
    hd.wc = wmat<T>(a, o.wc);
    hd.wr = wmat<T>(a, o.wr);
    hd.bc = a.pbuf + o.bc;
    hd.br = a.pbuf + o.br;
    hd.gc = Vec{a.films + o.gc, a.nfilm};
    hd.fc = Vec{a.films + o.gc + C, a.nfilm};
    if (res) {
      hd.hc = Mat{a.rhc, 2 * nS, p0, C, 0};
      hd.ac = Mat{a.rac, 2 * nS, p0, C, 0};
    }
    hd.rgb = Mat{a.rgb, 2 * nS, p0, R, 0};
    hd.nrows = (int)nS;
    hd.H = H;
    hd.C = C;
    hd.R = R;
    hd.fast_sin = a.fast_sin;
    CIPS_TRY(head<T>(hd, a.b, st));
    if (pass == 0) {
      rays_resample<T><<<ray_blocks(a), kRayThreads, 0, st>>>(a, rows);
      CIPS_TRY(cudaGetLastError());
    }
  }
  rays_composite<<<ray_blocks(a), kRayThreads, 0, st>>>(a, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int stream_backward(const StreamArgs& a, cudaStream_t st) {
  using namespace cips_stream;
  const int L = a.L, H = a.H, C = a.C, R = a.R, LH = L * H;
  const long long nS = (long long)a.n * a.S, all = 2 * a.b * nS;
  const int nchunk = (int)((nS + kRows - 1) / kRows);
  const Offsets o(L, H, C, R);
  const Cot cot(L, H, C, R);
  const Rows rows{a.rows, 2 * a.S};
  coarse_points<T><<<(unsigned)((a.b * nS * kXW + 255) / 256), 256, 0, st>>>(a);
  CIPS_TRY(cudaGetLastError());
  // sigma and rgb of every point of both passes, from the residuals
  sigma_rows<T><<<dim3((unsigned)((all + kRayWarps - 1) / kRayWarps), 1), kRayThreads, 0, st>>>(
      Mat{a.rh, 0, 0, LH, (L - 1) * H}, wmat<T>(a, o.ws), a.pbuf + o.bs, H, (int)all,
      Mat{a.sig, 0, 0, 1, 0});
  CIPS_TRY(cudaGetLastError());
  GemmArgs g = {};
  g.a = Mat{a.rhc, 0, 0, C, 0};
  g.akvalid = C;
  g.w = wmat<T>(a, o.wr);
  g.ldw = R;
  g.wvalid = C;
  g.nrows = (int)all;
  g.K = C;
  g.N = R;
  g.out = Mat{a.rgb, 0, 0, R, 0};
  g.bias = Vec{a.pbuf + o.br, 0};
  CIPS_TRY((gemm<T, T, false, kLinear>(g, 1, st)));
  rays_backward<T><<<ray_blocks(a), kRayThreads, 0, st>>>(a, rows);
  CIPS_TRY(cudaGetLastError());
  bwd_prep<T><<<dim3(nchunk, 2, a.b), kRayThreads, 0, st>>>(a, rows, nchunk);
  CIPS_TRY(cudaGetLastError());
  // the d-input chain, fine pass then coarse pass
  for (int pass = 1; pass >= 0; --pass) {
    const long long p0 = pass * nS;
    auto dqm = [&](int col) { return Mat{a.dq, 2 * nS, p0, cot.width, col}; };
    auto film_bwd = [&](Mat in, int K, long long woff, int ldw, int N, Mat ares, int goff,
                        int shift, Mat out, int foff, bool with_sigma) {
      GemmArgs g = {};
      g.a = in;
      g.akvalid = K;
      g.w = wmat<T>(a, woff);
      g.ldw = ldw;
      g.wvalid = N;
      g.nrows = (int)nS;
      g.K = K;
      g.N = N;
      g.out_a = Mat{a.xbuf, nS, 0, N, 0};
      if (with_sigma) {
        g.dsig = dqm(cot.dsig);
        g.ws = wmat<T>(a, o.ws);
      }
      cudaError_t e = gemm<T, T, true, kFilmBwd>(g, a.b, st);
      if (e != cudaSuccess) return e;
      const Mat part{a.fpart, 2LL * nchunk, (long long)pass * nchunk, 3 * (LH + C), foff};
      const Vec gain{a.films + goff, a.nfilm}, sh{a.films + goff + shift, a.nfilm};
      const dim3 grid(nchunk, (N + 127) / 128, a.b);
      const int rows = (int)nS;
      if (a.fast_sin)
        film_backward<T, true><<<grid, 256, 0, st>>>(g.out_a, ares, out, gain, sh, part, rows, N);
      else
        film_backward<T, false><<<grid, 256, 0, st>>>(g.out_a, ares, out, gain, sh, part, rows, N);
      return cudaGetLastError();
    };
    // d hc = d rgb wr^T -> the colour FiLM
    CIPS_TRY(film_bwd(dqm(cot.drgb), R, o.wr, R, C, Mat{a.rac, 2 * nS, p0, C, 0}, o.gc, C,
                      dqm(cot.dac), 3 * LH, false));
    // d h_{L-1} = d ac wc^T + d sigma ws -> layer L - 1
    CIPS_TRY(film_bwd(dqm(cot.dac), C, o.wc, C, H, Mat{a.ra, 2 * nS, p0, LH, (L - 1) * H},
                      2 * (L - 1) * H, H, dqm((L - 1) * H), 3 * (L - 1) * H, true));
    for (int l = L - 1; l >= 1; --l)   // d h_{l-1} = d a_l w_l^T -> layer l - 1
      CIPS_TRY(film_bwd(dqm(l * H), H, o.wl + (long long)(l - 1) * H * H, H, H,
                        Mat{a.ra, 2 * nS, p0, LH, (l - 1) * H}, 2 * (l - 1) * H, H,
                        dqm((l - 1) * H), 3 * (l - 1) * H, false));
    if (pass == 0) {   // d pts of the coarse points: d x = d a_0 w_0^T
      GemmArgs g = {};
      g.a = dqm(0);
      g.akvalid = H;
      g.w = wmat<T>(a, o.w0);
      g.ldw = H;
      g.wvalid = 3;
      g.nrows = (int)nS;
      g.K = H;
      g.N = 16;
      g.out = Mat{a.dpts, nS, 0, 3, 0};
      g.warp_scale = a.warp_scale;
      CIPS_TRY((gemm<T, T, true, kDx>(g, a.b, st)));
    }
  }
  // the weight grads, X^T dQ with the points as the depth: the matrices wider than 32 columns
  // in one launch of 64-column tiles (w_1 .., wc), the narrow ones in one of 32-column tiles
  // (w_0 as (d a_0)^T xs, ws, wr)
  struct Job {
    const void* x;
    int ldx, xcol, M;
    const void* b;
    int ldb, bcol, N;
    long long out;
    int ld, wn, trans;
  };
  std::vector<Job> jobs;
  for (int l = 1; l < L; ++l)
    jobs.push_back({a.rh, LH, (l - 1) * H, H, a.dq, cot.width, l * H, H,
                    o.wl + (long long)(l - 1) * H * H, H, H, 0});
  jobs.push_back({a.rh, LH, (L - 1) * H, H, a.dq, cot.width, cot.dac, C, o.wc, C, C, 0});
  jobs.push_back({a.dq, cot.width, 0, H, a.xs, kXW, 0, kXW, o.w0, H, 3, 1});
  jobs.push_back({a.rh, LH, (L - 1) * H, H, a.dq, cot.width, cot.dsig, 8, o.ws, 1, 1, 0});
  jobs.push_back({a.rhc, C, 0, C, a.dq, cot.width, cot.drgb, R, o.wr, R, R, 0});
  for (int wide = 1; wide >= 0; --wide) {
    auto launch = [&](const WgradArgs& w) {
      return wide ? cips_stream::wgrad<T, 64>(w, a.nsplit, st)
                  : cips_stream::wgrad<T, 32>(w, a.nsplit, st);
    };
    WgradArgs w = {};
    w.split_rows = a.split_rows;
    w.npoints = all;
    w.wstride = o.nw;
    int tiles = 0;
    for (const Job& q : jobs) {
      if ((q.N > 32) != (wide == 1)) continue;
      WJob& jb = w.job[w.njobs++];
      jb.x = static_cast<const T*>(q.x) + q.xcol;
      jb.b = static_cast<const T*>(q.b) + q.bcol;
      jb.ldx = q.ldx;
      jb.ldb = q.ldb;
      jb.M = q.M;
      jb.N = q.N;
      jb.out = a.part_w + q.out;
      jb.ld = q.ld;
      jb.wn = q.wn;
      jb.trans = q.trans;
      jb.tile0 = tiles;
      const int bn = wide ? 64 : 32;
      tiles += ((q.M + kRows - 1) / kRows) * ((q.N + bn - 1) / bn);
      if (w.njobs == kMaxJobs) {   // a full table: launch it, start the next
        CIPS_TRY(launch(w));
        w.njobs = tiles = 0;
      }
    }
    if (w.njobs) CIPS_TRY(launch(w));
  }
  // the sums: the weight grads over the splits, fpart and bpart over fixed row groups, then
  // the groups in order
  const int nsum = 3 * (LH + C);
  col_sums<<<dim3((unsigned)((o.nw + 31) / 32), 1), 256, 0, st>>>(a.part_w, a.nsplit, (int)o.nw, 1,
                                                                   a.out_w);
  CIPS_TRY(cudaGetLastError());
  col_sums<<<dim3((unsigned)((nsum + 31) / 32), a.b * kSumGroups), 256, 0, st>>>(
      a.fpart, 2 * nchunk, nsum, kSumGroups, a.sums);
  CIPS_TRY(cudaGetLastError());
  col_sums<<<dim3((unsigned)((R + 1 + 31) / 32), a.b * kSumGroups), 256, 0, st>>>(
      a.bpart, 2 * nchunk, R + 1, kSumGroups, a.sums + (long long)a.b * kSumGroups * nsum);
  CIPS_TRY(cudaGetLastError());
  const int ng = o.nb + a.b * o.nf;
  bwd_gather<<<(ng + 255) / 256, 256, 0, st>>>(a.sums, a.b, L, H, C, R, a.out_w, a.out_f);
  return (int)cudaGetLastError();
}

StreamArgs common_args(const void* pts, const void* org, const void* dir, const void* z,
                       const void* u, const void* nc, const void* nf, const void* noise,
                       const void* wbuf, const void* pbuf, const void* films, int b, int n, int S,
                       int L, int H, int C, int R, int nfilm, float warp_scale, int softplus,
                       int white_back, int last_back, int flags) {
  StreamArgs a = {};
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
  a.b = b; a.n = n; a.S = S; a.L = L; a.H = H; a.C = C; a.R = R;
  a.nfilm = nfilm;
  a.warp_scale = warp_scale;
  a.softplus = softplus;
  a.white_back = white_back;
  a.last_back = last_back;
  // flags: bit 0 use_noise, bit 1 fast_sin, bit 2 bf16 matmul inputs, bit 3 bf16 features
  a.use_noise = flags & 1;
  a.fast_sin = (flags >> 1) & 1;
  a.out_bf16 = (flags >> 3) & 1;
  return a;
}

}  // namespace

// The streamed forward (#2; #2r with rh, ra, rhc, rac all set).  Inputs,
// weights, outputs and residuals as cips_ray_tile_forward's, at widths that
// are multiples of 16 and any S >= 2.  Scratch: xs (b, 2, n, S, 8) and, without
// residuals, hbuf (2, b n S, H) in the mm type; sig (b, 2, n, S), rgb
// (b, 2, n, S, R) and rows (b n, 14, 2S) f32.  Returns the CUDA error of the
// launches (0 on success).
extern "C" int cips_ray_tile_forward_streamed(
    const void* pts, const void* org, const void* dir, const void* z, const void* u,
    const void* nc, const void* nf, const void* noise, const void* wbuf, const void* pbuf,
    const void* films, void* fea, void* depth, void* rh, void* ra, void* rhc, void* rac,
    void* xs, void* hbuf, void* sig, void* rgb, void* rows, int b, int n, int S, int L, int H,
    int C, int R, int nfilm, float warp_scale, int softplus, int white_back, int last_back,
    int flags, void* stream) {
  if (S < 2 || L < 1) return (int)cudaErrorInvalidValue;
  StreamArgs a = common_args(pts, org, dir, z, u, nc, nf, noise, wbuf, pbuf, films, b, n, S, L, H,
                             C, R, nfilm, warp_scale, softplus, white_back, last_back, flags);
  a.fea = fea;
  a.depth = static_cast<float*>(depth);
  a.rh = rh;
  a.ra = static_cast<float*>(ra);
  a.rhc = rhc;
  a.rac = static_cast<float*>(rac);
  a.xs = xs;
  a.hbuf = hbuf;
  a.sig = static_cast<float*>(sig);
  a.rgb = static_cast<float*>(rgb);
  a.rows = static_cast<float*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (flags >> 2) & 1 ? stream_forward<__nv_bfloat16>(a, st) : stream_forward<float>(a, st);
}

// The streamed backward (#3) from residuals in the forward's layout (both
// modes: recompute mode's are the wrapper's rerun of the streamed forward).
// Scratch: xs and dq (b, 2, n, S, 8 | cot width) in the mm type; sig, rgb
// and rows as the forward's; fpart (b, 2, nchunk, 3 (L H + C)), bpart (b, 2,
// nchunk, R + 1), part_w (nsplit, nw), sums (cips_ray_tile_streamed_sums
// floats) and xbuf (b, n S, max(H, C)) f32; nchunk = ceil(n S /
// cips_stream_tile(0)), nsplit = ceil(b 2 n S / split_rows), split_rows a
// multiple of 32.  Outputs as cips_ray_tile_backward's.
extern "C" int cips_ray_tile_backward_streamed(
    const void* pts, const void* org, const void* dir, const void* z, const void* u,
    const void* nc, const void* nf, const void* noise, const void* wbuf, const void* pbuf,
    const void* films, const void* dfea, const void* ddep, const void* rh, const void* ra,
    const void* rhc, const void* rac, void* xs, void* dq, void* sig, void* rgb, void* rows,
    void* fpart, void* bpart, void* part_w, void* sums, void* xbuf, void* dpts, void* out_w,
    void* out_f,
    int b, int n, int S, int L, int H, int C, int R, int nfilm, int nsplit, int split_rows,
    float warp_scale, int softplus, int white_back, int last_back, int flags, void* stream) {
  if (S < 2 || L < 1 || split_rows % 32 != 0 ||
      (long long)nsplit * split_rows < 2LL * b * n * S)
    return (int)cudaErrorInvalidValue;
  StreamArgs a = common_args(pts, org, dir, z, u, nc, nf, noise, wbuf, pbuf, films, b, n, S, L, H,
                             C, R, nfilm, warp_scale, softplus, white_back, last_back, flags);
  a.dfea = static_cast<const float*>(dfea);
  a.ddep = static_cast<const float*>(ddep);
  a.rh = const_cast<void*>(rh);
  a.ra = static_cast<float*>(const_cast<void*>(ra));
  a.rhc = const_cast<void*>(rhc);
  a.rac = static_cast<float*>(const_cast<void*>(rac));
  a.xs = xs;
  a.dq = dq;
  a.sig = static_cast<float*>(sig);
  a.rgb = static_cast<float*>(rgb);
  a.rows = static_cast<float*>(rows);
  a.fpart = static_cast<float*>(fpart);
  a.bpart = static_cast<float*>(bpart);
  a.part_w = static_cast<float*>(part_w);
  a.sums = static_cast<float*>(sums);
  a.xbuf = static_cast<float*>(xbuf);
  a.dpts = static_cast<float*>(dpts);
  a.out_w = static_cast<float*>(out_w);
  a.out_f = static_cast<float*>(out_f);
  a.nsplit = nsplit;
  a.split_rows = split_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (flags >> 2) & 1 ? stream_backward<__nv_bfloat16>(a, st) : stream_backward<float>(a, st);
}

// Rows of device scratch a ray of the streamed path takes (each 2S floats).
extern "C" int cips_ray_tile_streamed_ray_rows() { return kRayRows; }

// Floats of the streamed backward's group sums (its `sums` scratch).
extern "C" long long cips_ray_tile_streamed_sums(int b, int L, int H, int C, int R) {
  return (long long)b * kSumGroups * (3LL * (L * H + C) + R + 1);
}

// The largest dynamic shared memory of any streamed ray-tile kernel (bytes)
// with f32 (mm_bf16 0) or bf16 products: the same at every shape.
template <typename T>
size_t streamed_smem() {
  using namespace cips_stream;
  size_t m = Tile<T, T, false, 64, false, true>::kBytes;   // the weight grads (widest)
  m = max(m, gemm_smem_max<T, T, false, kFilm>());
  m = max(m, gemm_smem_max<T, T, true, kFilmBwd>());
  return max(m, head_smem<T>());
}

extern "C" int cips_ray_tile_streamed_smem(int mm_bf16) {
  return (int)(mm_bf16 ? streamed_smem<__nv_bfloat16>() : streamed_smem<float>());
}

// The streamed products' block tile: which 0 its rows (the chunk of the
// backward's FiLM sums), 1 its widest columns (the slab of the INR's ToRGB sums).
extern "C" int cips_stream_tile(int which) {
  return which == 0 ? cips_stream::kRows : cips_stream::kSlab;
}

// The current device's opt-in limit of dynamic shared memory a block (bytes).
extern "C" int cips_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
