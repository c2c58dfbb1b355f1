// Range-reduced polynomial sine: device counterpart of
// cips3d_tpu_torch/ops/fast_sin.py (and cips3d_tpu/ops/fast_sin.py).
//
//   y = x / 2pi;  r = y - rint(y) in [-0.5, 0.5];  sin(x) = r * P(r^2)
//
// rintf rounds half to even like jnp.round / torch.round (roundf would round
// half away from zero and move exact halves x = (k + 0.5) * 2pi).  Internals
// are float32 for every input type.  Built without --use_fast_math.
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
