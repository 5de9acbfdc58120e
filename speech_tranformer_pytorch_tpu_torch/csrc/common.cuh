// Helpers shared by the port's kernels: warp and block reductions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace st {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Reduce one float over the block; every thread gets the result.
// `scratch` holds at least 32 floats. Ends with a barrier, so `scratch`
// may be reused right after.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = kMax ? -INFINITY : 0.f;
  for (int w = 0; w < n_warps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

}  // namespace st
