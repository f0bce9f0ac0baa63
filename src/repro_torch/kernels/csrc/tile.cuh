// Tile element types of the projector kernels: f32 or bf16 tiles, f32
// weights and sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 weight rounded to the tile's type (and back), so that weight x tile
// is the product of two values of the tile's type, summed in f32.
template <typename T>
__device__ __forceinline__ float round_like(float w);
template <>
__device__ __forceinline__ float round_like<float>(float w) {
  return w;
}
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16(w));
}
