// Range-reduced polynomial sine: device counterpart of
// cips3d_tpu_torch/ops/fast_sin.py (and cips3d_tpu/ops/fast_sin.py).
//
//   y = x / 2pi;  r = y - rint(y) in [-0.5, 0.5];  sin(x) = r * P(r^2)
//
// rintf rounds half to even like jnp.round / torch.round (roundf would round
// half away from zero and move exact halves x = (k + 0.5) * 2pi).  Internals
// are float32 for every input type.  Built without --use_fast_math.
// cips_fast_sin_gradf is the derivative of the polynomial (not cos), as
// fast_sin_grad in the Python modules.
#pragma once

__device__ __forceinline__ float cips_fast_sinf(float x) {
  const float y = x * 0.15915494309189535f;
  const float r = y - rintf(y);
  const float r2 = r * r;
  float p = 33.16809461334938f;
  p = p * r2 + -74.67588386951022f;
  p = p * r2 + 81.40008976706686f;
  p = p * r2 + -41.33324754221887f;
  p = p * r2 + 6.283088463027395f;
  return r * p;
}

__device__ __forceinline__ float cips_fast_sin_gradf(float x) {
  const float y = x * 0.15915494309189535f;
  const float r = y - rintf(y);
  const float r2 = r * r;
  float p = 33.16809461334938f;
  p = p * r2 + -74.67588386951022f;
  p = p * r2 + 81.40008976706686f;
  p = p * r2 + -41.33324754221887f;
  p = p * r2 + 6.283088463027395f;
  float dp = 4.0f * 33.16809461334938f;
  dp = dp * r2 + 3.0f * -74.67588386951022f;
  dp = dp * r2 + 2.0f * 81.40008976706686f;
  dp = dp * r2 + -41.33324754221887f;
  return 0.15915494309189535f * (p + 2.0f * r2 * dp);
}
