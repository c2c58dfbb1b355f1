// Per-ray stages shared by the ray-tile forward (ray_tile.cu) and its
// backward (ray_tile_bwd.cu): the density clamp, the inverse-CDF
// resample and the compositing weights.  One warp per ray; each lane holds
// every 32nd sample of the ray (see kMaxSteps).  Both kernels run the same
// arithmetic in the same order, so the backward reproduces the forward's
// fine depths and weights bit for bit.
#pragma once

#include "common.cuh"

namespace cips_ray {

__device__ __forceinline__ float density(float x, int softplus) {
  // jax.nn.softplus(x) = logaddexp(x, 0)
  return softplus ? fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) : fmaxf(x, 0.f);
}

// d density / dx: sigmoid for softplus, the step for relu (0 at x = 0).
__device__ __forceinline__ float density_grad(float x, int softplus) {
  return softplus ? 1.f / (1.f + expf(-x)) : (x > 0.f ? 1.f : 0.f);
}

// Most coarse samples a ray may have (the wrappers' MAX_STEPS): the
// compositing's 2S <= 128 samples take kLaneSamples per lane, the resample's
// S take kLaneCoarse.  Lane l holds samples l, l + 32, l + 64, ...; every
// prefix sum runs serially over the samples before it in sample order, the
// same order in both kernels, so the backward reproduces the forward bit
// for bit at any S.
constexpr int kMaxSteps = 64;
constexpr int kLaneCoarse = (kMaxSteps + 31) / 32;
constexpr int kLaneSamples = (2 * kMaxSteps + 31) / 32;

// Fine depths of one ray from its coarse densities: zr[S..2S) holds the
// coarse depths, sc the coarse raw sigma (stride 1), uv/ncv the ray's
// uniforms and resample noise in device memory (null for a ray past n: zero
// draws, as the forward's padding rows); the fine depths land in zr[0..S).
// lx and pdf are 2S-float scratch rows of this warp.
__device__ __forceinline__ void resample_ray(float* zr, const float* sc, const float* uv,
                                             const float* ncv, float* lx, float* pdf, int S,
                                             int use_noise, float noise_std, int softplus) {
  const int lane = threadIdx.x & 31;
  float alpha[kLaneCoarse];
#pragma unroll
  for (int t = 0; t < kLaneCoarse; ++t) {
    const int i = lane + 32 * t;
    alpha[t] = 0.f;
    if (i >= S) continue;
    const float zi = zr[S + i];
    const float delta = i < S - 1 ? zr[S + i + 1] - zi : 1e10f;
    float s = sc[i];
    if (use_noise && ncv) s += ncv[i] * noise_std;
    alpha[t] = 1.f - expf(-delta * density(s, softplus));
    lx[i] = logf(fmaxf(1.f - alpha[t], 1e-10f));
  }
  __syncwarp();
  const int nb = S - 2;                           // pdf bins: bin i - 1 is sample i
  float inner[kLaneCoarse];
  float part = 0.f;                               // the lane's share of the pdf total
#pragma unroll
  for (int t = 0; t < kLaneCoarse; ++t) {
    const int i = lane + 32 * t;
    inner[t] = 0.f;
    if (i < 1 || i > S - 2) continue;
    float acc = 0.f;
    for (int j = 0; j < i; ++j) acc += lx[j];
    const float wcv = alpha[t] * expf(acc);
    inner[t] = (wcv + 1e-5f) + 1e-5f;
    part += inner[t];
  }
  const float total = cips::warp_sum(part);
#pragma unroll
  for (int t = 0; t < kLaneCoarse; ++t) {
    const int i = lane + 32 * t;
    if (i >= 1 && i <= S - 2) pdf[i - 1] = inner[t] / total;
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kLaneCoarse; ++t) {         // cdf (S-1 edges), bin mid-points
    const int i = lane + 32 * t;
    if (i >= S - 1) continue;
    float c = 0.f;
    for (int k = 0; k < i; ++k) c += pdf[k];
    lx[i] = c;
    lx[S + i] = 0.5f * (zr[S + i] + zr[S + i + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kLaneCoarse; ++t) {
    const int i = lane + 32 * t;
    if (i >= S) continue;
    const float uu = uv ? uv[i] : 0.f;
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

// The compositing state of the samples j = lane + 32 t (t < kLaneSamples) of a ray.
struct CompLane {
  float z[kLaneSamples], s[kLaneSamples], dens[kLaneSamples], delta[kLaneSamples],
      expd[kLaneSamples], alpha[kLaneSamples], trans[kLaneSamples], w[kLaneSamples];
  int rank[kLaneSamples];
};

// Sort-free compositing weights of one ray's M = 2S samples in [fine,
// coarse] arrival order: zr and sr (raw sigma) are shared rows of M, nfr the
// ray's compositing noise in device memory (null for a ray past n); lx
// (float) and rk (int) are M-entry scratch rows of this warp.  Ranks are
// counted; equal depths keep arrival order (the stable sort's tie-break).
// Returns the lane's state; `wsum` is the sum of the weights before
// last_back, which (if set) is already applied to w.
__device__ __forceinline__ CompLane composite_ray(const float* zr, const float* sr,
                                                  const float* nfr, float* lx, int* rk, int M,
                                                  int use_noise, float noise_std, int softplus,
                                                  int last_back, float& wsum) {
  const int lane = threadIdx.x & 31;
  CompLane c;
#pragma unroll
  for (int t = 0; t < kLaneSamples; ++t) {
    const int j = lane + 32 * t;
    c.w[t] = 0.f;
    if (j >= M) continue;
    c.z[t] = zr[j];
    int cnt = 0;
    for (int k = 0; k < M; ++k) {
      const float zk = zr[k];
      cnt += (zk < c.z[t]) || (zk == c.z[t] && k < j);
    }
    c.rank[t] = cnt;
    rk[j] = cnt;
    float sg = sr[j];
    if (use_noise && nfr) sg += nfr[j] * noise_std;
    c.s[t] = sg;
    c.dens[t] = density(sg, softplus);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kLaneSamples; ++t) {
    const int j = lane + 32 * t;
    if (j >= M) continue;
    float delta = 1e10f;
    if (c.rank[t] != M - 1) {
      for (int k = 0; k < M; ++k)
        if (rk[k] == c.rank[t] + 1) delta = zr[k] - c.z[t];
    }
    c.delta[t] = delta;
    c.expd[t] = expf(-delta * c.dens[t]);
    c.alpha[t] = 1.f - c.expd[t];
    lx[j] = logf(fmaxf(1.f - c.alpha[t], 1e-10f));
  }
  __syncwarp();
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kLaneSamples; ++t) {
    const int j = lane + 32 * t;
    if (j >= M) continue;
    float acc = 0.f;   // before[j, k] <=> rank_k < rank_j
    for (int k = 0; k < M; ++k)
      if (rk[k] < c.rank[t]) acc += lx[k];
    c.trans[t] = expf(acc);
    c.w[t] = c.alpha[t] * c.trans[t];
    part += c.w[t];
  }
  wsum = cips::warp_sum(part);
#pragma unroll
  for (int t = 0; t < kLaneSamples; ++t) {
    const int j = lane + 32 * t;
    if (j < M && last_back && c.rank[t] == M - 1) c.w[t] += 1.f - wsum;
  }
  __syncwarp();
  return c;
}

}  // namespace cips_ray
