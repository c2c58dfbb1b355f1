// Helpers shared by the kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cips {

// Matmul-input types: float, or bf16 with float accumulation.
template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to the matmul-input type and back: the `.astype(mm_dtype)`
// of the Pallas kernels, applied where they apply it.
template <typename T> __device__ __forceinline__ float round_mm(float v);
template <> __device__ __forceinline__ float round_mm<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_mm<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-cooperative copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory.
__device__ __forceinline__ void copy16(void* dst, const void* src, size_t bytes) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Offset of the next 16-byte aligned region of `bytes`; advances `off` past it.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t o = off;
  off += align16(bytes);
  return o;
}

// Raise `kernel`'s dynamic shared-memory limit on the current device to at
// least `bytes`.  The limit only grows and is set once per (device, kernel,
// size): a launch that fits what is set makes no CUDA call besides itself,
// so a training step captured into a CUDA graph after its warm-up launches
// only kernels.
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> set;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<int, const void*> key(dev, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> hold(mu);
  auto it = set.find(key);
  if (it != set.end() && it->second >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set[key] = bytes;
  return err;
}

// Resident warps per SM of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory: out[0] warps, out[1] shared bytes, out[2] threads.
template <typename K>
int occupancy(K kernel, int threads, size_t smem, int* out) {
  cudaError_t err = raise_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = blocks * threads / 32;
  out[1] = (int)smem;
  out[2] = threads;
  return (int)err;
}

// ---- tensor-core products (warp-level mma.sync, sm_80+) ------------------
// Fragment layouts (PTX ISA, mma.m16n8k8 / m16n8k16): with g = lane / 4 and
// t = lane % 4, A rows g and g + 8, B column g, C rows g and g + 8 at
// columns 2t and 2t + 1.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts TF32 (lo is the rounded remainder): three
// TF32 products (hi*hi + hi*lo + lo*hi) carry a product to close to f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += (a_hi + a_lo) (b_hi + b_lo), dropping lo * lo
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ahi[4], const uint32_t alo[4],
                                           const uint32_t bhi[2], const uint32_t blo[2]) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bf16 values (e.g. rows k and k + 1 of one column), the first in the low half
__device__ __forceinline__ uint32_t pack_bits(const __nv_bfloat16& lo, const __nv_bfloat16& hi) {
  return uint32_t(*reinterpret_cast<const unsigned short*>(&lo)) |
         uint32_t(*reinterpret_cast<const unsigned short*>(&hi)) << 16;
}

}  // namespace cips
