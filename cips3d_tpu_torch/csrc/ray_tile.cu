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
// ray_tile_bwd.cu) it also writes, per pass and point, every hidden layer's
// pre-activation a (f32) and output h (mm type), and the colour FiLM's ac
// and hc: rh/ra (b, 2, n, S, L*H), rhc/rac (b, 2, n, S, C), pass 0 coarse,
// 1 fine, points ray-major.  That is 2560 B a point in f32 at the flagship
// widths, written once: at r64, b = 4, S = 12 (0.39 M points) 1.0 GB, or
// 0.30 ms at 3.35 TB/s beside the MLP's 0.32 ms bound, so with residuals
// the bound is about twice the plain forward's.  The stores are coalesced
// (a warp writes 32 neighbouring channels of one point).
//
// What bounds it on an H100: the point MLP.  Per sample point it costs
// 2 * (3H + (L-1)H^2 + HC + CR + H) = 54 kFLOP and L*H + C sines at the
// flagship widths (H=128, L=2, C=64, R=32); a 128x128 frame at S=24 is
// 0.79 M points, 43 GFLOP and 0.25 G sines, which this kernel runs on the
// f32 FMA units at about a tenth of their rate.  The products are not what
// bounds it: moved to the tensor cores (3xTF32) they left the f32 time
// unchanged on an H100, so the time goes to what surrounds them (per-chunk
// barriers with 4 warps per SM, the sines, the per-ray stages); that
// variant was not kept.  The per-ray stages are O(S^2) (resample) and
// O((2S)^2) (compositing) scalar work, one warp per ray.
//
// Design: as on the TPU, every intermediate of a block of rays stays on
// chip and only per-ray inputs and (feature, depth) touch device memory.
// The weights of the whole SIREN (106 KB in f32 at the flagship widths)
// are copied once per block into shared memory.  The per-point hidden state
// of a whole ray block does not fit beside them, so a block of 4 rays walks
// its S points per pass in chunks of 32 points, keeping one chunk's hidden
// states in two 32 x 128 f32 buffers; the per-point sigma and rgb of both
// passes stay in shared memory for compositing.  The per-ray stages run one
// warp per ray with one lane per sample, so they need no sort: ranks are
// counted, and the [fine, coarse] stable tie-break follows from counting
// equal depths at lower arrival index.  The Pallas kernel's floors and
// guards are kept exactly: max(1 - alpha, 1e-10), never + eps; the
// `cdf < u` count with the denom < 1e-5 -> 1 guard; the successor delta and
// the 1e10 last delta.  Finding what bounds it, and a persistent grid that
// loads the weights once per SM, are later work.

#include "common.cuh"
#include "fast_sin.cuh"
#include "ray_tile.cuh"

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kRays = 4;          // rays per block: one warp per ray in the per-ray stages
constexpr int kRows = 32;         // points per MLP chunk; warp w owns rows 8w..8w+7
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kColsPerLane = 4;   // layer widths up to 128; S <= 32 (two of 2S samples per lane)

struct RayArgs {
  const float* pts;    // (b, n, S, 3) coarse points
  const float* org;    // (b, n, 3)
  const float* dir;    // (b, n, 3)
  const float* z;      // (b, n, S) coarse depths, sorted along S
  const float* u;      // (b, n, S) importance-sample uniforms
  const float* nc;     // (b, n, S) resample density noise
  const float* nf;     // (b, n, 2S) compositing density noise
  const void* wbuf;    // mm type: w_0 (3,H), w_1.. (H,H), wc (H,C), wr (C,R), ws (H); padded
  const float* pbuf;   // b_0.. (H), bc (C), br (R), bs (1); padded
  const float* films;  // (b, nfilm): g_0, f_0, g_1, f_1, .. (H each), gc, fc (C each); padded
  void* fea;           // (b, n, R) out type
  float* depth;        // (b, n)
  void* rh;            // residuals, or null: (b, 2, n, S, L*H) mm type
  float* ra;           // (b, 2, n, S, L*H)
  void* rhc;           // (b, 2, n, S, C) mm type
  float* rac;          // (b, 2, n, S, C)
  int b, n, S, L, H, C, R;
  int nw, np, nfilm;   // padded element counts of wbuf, pbuf and one films row
  float noise_std, warp_scale;
  int softplus, white_back, last_back, use_noise, fast_sin, out_bf16;
};

struct RayLayout {
  size_t w, p, f, bufa, bufb, sig, zall, sall, nfv, t1, t2, rank, uv, ncv, od, rgb, resrow, total;
  int ldb;   // row stride of the chunk buffers
  __host__ __device__ RayLayout(const RayArgs& a, size_t tsize) {
    const int M = 2 * a.S;
    ldb = a.H > a.C ? a.H : a.C;
    if (a.R > ldb) ldb = a.R;
    size_t off = 0;
    w = take(off, tsize * a.nw);
    p = take(off, sizeof(float) * a.np);
    f = take(off, sizeof(float) * a.nfilm);
    bufa = take(off, sizeof(float) * kRows * ldb);
    bufb = take(off, sizeof(float) * kRows * ldb);
    sig = take(off, sizeof(float) * kRows);
    zall = take(off, sizeof(float) * kRays * M);
    sall = take(off, sizeof(float) * kRays * M);
    nfv = take(off, sizeof(float) * kRays * M);
    t1 = take(off, sizeof(float) * kRays * M);
    t2 = take(off, sizeof(float) * kRays * M);
    rank = take(off, sizeof(int) * kRays * M);
    uv = take(off, sizeof(float) * kRays * a.S);
    ncv = take(off, sizeof(float) * kRays * a.S);
    od = take(off, sizeof(float) * kRays * 8);
    rgb = take(off, sizeof(float) * kRays * M * a.R);
    resrow = take(off, sizeof(long long) * kRows);
    total = off;
  }
  // Offset of the next region of `bytes`; advances `off` past it.
  __host__ __device__ static size_t take(size_t& off, size_t bytes) {
    const size_t o = off;
    off += cips::align16(bytes);
    return o;
  }
};

// out[r][c] = epi(sum_k in[r][k] W[k][c] + bias[c]) for the 32 rows of a
// chunk and c < N (N <= 128).  epi: with `gain`, sin(gain[c] v + shift[c])
// rounded to the mm type (a FiLM-SIREN layer); without, v as is (f32).
// With kRes, row r's pre-activation v and output also go to res_a / res_h
// at row res_row[r] (row stride res_ld; skipped if < 0).  A template
// argument, so that the forward without residuals compiles as it did.
template <typename T, bool kRes = false>
__device__ void chunk_layer(const float* in, int ld, int K, const T* W, int N,
                            const float* bias, const float* gain, const float* shift,
                            int fast_sin, float* out, const long long* res_row = nullptr,
                            float* res_a = nullptr, T* res_h = nullptr, int res_ld = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* x = in + warp * kRowsPerWarp * ld;
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float w[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      w[j] = c < N ? cips::to_f(W[k * N + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float xv = x[i * ld + k];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c >= N) continue;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      float v = acc[i][j] + bias[c];
      const float a = v;
      if (gain != nullptr) {
        const float arg = gain[c] * v + shift[c];
        v = cips::round_mm<T>(fast_sin ? cips_fast_sinf(arg) : sinf(arg));
      }
      out[row * ld + c] = v;
      if (kRes && res_row[row] >= 0) {
        res_a[res_row[row] * res_ld + c] = a;
        res_h[res_row[row] * res_ld + c] = cips::from_f<T>(v);
      }
    }
  }
}

template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads) ray_tile_kernel(RayArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RayLayout lay(a, sizeof(T));
  const T* wsm = reinterpret_cast<const T*>(smem + lay.w);
  const float* psm = reinterpret_cast<const float*>(smem + lay.p);
  const float* fsm = reinterpret_cast<const float*>(smem + lay.f);
  float* bufa = reinterpret_cast<float*>(smem + lay.bufa);
  float* bufb = reinterpret_cast<float*>(smem + lay.bufb);
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
  float* rgb = reinterpret_cast<float*>(smem + lay.rgb);     // [ray][slot][R]
  long long* resrow = reinterpret_cast<long long*>(smem + lay.resrow);
  T* rh = static_cast<T*>(a.rh);
  T* rhc = static_cast<T*>(a.rhc);

  const int S = a.S, M = 2 * S, H = a.H, C = a.C, R = a.R, L = a.L, n = a.n;
  const int ld = lay.ldb;
  const int bi = blockIdx.y, ray0 = blockIdx.x * kRays;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  cips::copy16(smem + lay.w, a.wbuf, sizeof(T) * a.nw);
  cips::copy16(smem + lay.p, a.pbuf, sizeof(float) * a.np);
  cips::copy16(smem + lay.f, a.films + (size_t)bi * a.nfilm, sizeof(float) * a.nfilm);
  for (int i = threadIdx.x; i < kRays * S; i += kThreads) {
    const int r = i / S, s = i % S, ray = ray0 + r;
    const bool ok = ray < n;
    const size_t idx = ((size_t)bi * n + ray) * S + s;
    zall[r * M + S + s] = ok ? a.z[idx] : 0.f;
    uv[i] = ok ? a.u[idx] : 0.f;
    ncv[i] = ok && a.use_noise ? a.nc[idx] : 0.f;
  }
  for (int i = threadIdx.x; i < kRays * M; i += kThreads) {
    const int r = i / M, m = i % M, ray = ray0 + r;
    nfv[i] = ray < n && a.use_noise ? a.nf[((size_t)bi * n + ray) * M + m] : 0.f;
  }
  for (int i = threadIdx.x; i < kRays * 3; i += kThreads) {
    const int r = i / 3, c = i % 3, ray = ray0 + r;
    const size_t idx = ((size_t)bi * n + ray) * 3 + c;
    od[r * 8 + c] = ray < n ? a.org[idx] : 0.f;
    od[r * 8 + 4 + c] = ray < n ? a.dir[idx] : 0.f;
  }
  __syncthreads();

  const T* wc = wsm + 3 * H + (size_t)(L - 1) * H * H;
  const T* wr = wc + H * C;
  const T* ws = wr + C * R;
  const float* bc = psm + L * H;
  const float* br = bc + C;
  const float bs = br[R];
  const float* gc = fsm + 2 * L * H;
  const float* fc = gc + C;

  // FiLM-SIREN over one pass of the block's kRays * S points.
  auto run_mlp = [&](bool fine) {
    const int npts = kRays * S;
    for (int q0 = 0; q0 < npts; q0 += kRows) {
      for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
        const int row = i / 3, c = i % 3, q = q0 + row;
        float v = 0.f;
        if (q < npts) {
          const int r = q / S, s = q % S, ray = ray0 + r;
          if (ray < n)
            v = fine ? od[r * 8 + c] + od[r * 8 + 4 + c] * zall[r * M + s]
                     : a.pts[(((size_t)bi * n + ray) * S + s) * 3 + c];
        }
        bufa[row * ld + c] = cips::round_mm<T>(v * a.warp_scale);   // UniformBoxWarp
      }
      for (int row = threadIdx.x; kRes && row < kRows; row += kThreads) {   // residual rows
        const int q = q0 + row, r = q / S, s = q % S;
        resrow[row] = q < npts && ray0 + r < n
                          ? ((((long long)bi * 2 + fine) * n + ray0 + r) * S + s) : -1;
      }
      __syncthreads();
      float* cur = bufa;
      float* nxt = bufb;
      for (int l = 0; l < L; ++l) {
        const T* w = wsm + (l == 0 ? 0 : 3 * H + (size_t)(l - 1) * H * H);
        chunk_layer<T, kRes>(cur, ld, l == 0 ? 3 : H, w, H, psm + l * H,
                             fsm + 2 * l * H, fsm + 2 * l * H + H, a.fast_sin, nxt, resrow,
                             kRes ? a.ra + l * H : nullptr, kRes ? rh + l * H : nullptr, L * H);
        __syncthreads();
        float* t = cur; cur = nxt; nxt = t;
      }
      for (int i = 0; i < kRowsPerWarp; ++i) {   // sigma head
        const int row = warp * kRowsPerWarp + i;
        float v = 0.f;
        for (int k = lane; k < H; k += 32) v = fmaf(cur[row * ld + k], cips::to_f(ws[k]), v);
        v = cips::warp_sum(v);
        if (lane == 0) sig[row] = v + bs;
      }
      chunk_layer<T, kRes>(cur, ld, H, wc, C, bc, gc, fc, a.fast_sin, nxt, resrow,   // colour FiLM
                           kRes ? a.rac : nullptr, kRes ? rhc : nullptr, C);
      __syncthreads();
      chunk_layer<T>(nxt, ld, C, wr, R, br, nullptr, nullptr, 0, cur);   // rgb head
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * R; i += kThreads) {
        const int row = i / R, c = i % R, q = q0 + row;
        if (q < npts) {
          const int r = q / S, s = q % S;
          rgb[(r * M + (fine ? s : S + s)) * R + c] = cur[row * ld + c];
        }
      }
      for (int row = threadIdx.x; row < kRows; row += kThreads) {
        const int q = q0 + row;
        if (q < npts) {
          const int r = q / S, s = q % S;
          sall[r * M + (fine ? s : S + s)] = sig[row];
        }
      }
      __syncthreads();
    }
  };

  // ---- coarse pass ----
  run_mlp(false);

  // ---- resample: warp = ray, lane = sample ----
  cips_ray::resample_ray(zall + warp * M, sall + warp * M + S, uv + warp * S, ncv + warp * S,
                         t1 + warp * M, t2 + warp * M, S, a.use_noise, a.noise_std, a.softplus);
  __syncthreads();

  // ---- fine pass ----
  run_mlp(true);

  // ---- compositing: warp = ray, lanes own samples lane and lane + 32 ----
  {
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
      for (int c = lane; c < R; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < M; ++j) acc = fmaf(wt[j], rgb[(r * M + j) * R + c], acc);
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
  const RayLayout lay(a, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(ray_tile_kernel<T, kRes>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kRays - 1) / kRays, a.b);
  ray_tile_kernel<T, kRes><<<grid, kThreads, lay.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes as in RayArgs; rh, ra, rhc, rac are all null (no residuals) or
// all set.  The wrapper checks S in [3, 32], H, C, R <= 128 and pads
// wbuf, pbuf and the films rows to 16-byte multiples.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int cips_ray_tile_forward(
    const void* pts, const void* org, const void* dir, const void* z, const void* u,
    const void* nc, const void* nf, const void* wbuf, const void* pbuf, const void* films,
    void* fea, void* depth, void* rh, void* ra, void* rhc, void* rac,
    int b, int n, int S, int L, int H, int C, int R,
    float noise_std, float warp_scale,
    int nw, int np, int nfilm, int softplus, int white_back, int last_back, int flags,
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
  a.b = b; a.n = n; a.S = S; a.L = L; a.H = H; a.C = C; a.R = R;
  a.nw = nw; a.np = np; a.nfilm = nfilm;
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
