// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch (kernels/__init__.py).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define H2_EXPORT extern "C" __attribute__((visibility("default")))

#define H2_FULL_MASK 0xFFFFFFFFu

// Warp-wide inclusive prefix sum / max (lane order).
__device__ __forceinline__ int h2_warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(H2_FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int h2_warp_incl_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(H2_FULL_MASK, v, o);
    if (lane >= o) v = max(v, t);
  }
  return v;
}

// Warp-wide suffix minimum: lane l gets min(v[l..31]).
__device__ __forceinline__ int h2_warp_suffix_min(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_down_sync(H2_FULL_MASK, v, o);
    if (lane + o < 32) v = min(v, t);
  }
  return v;
}

__device__ __forceinline__ int h2_warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(H2_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ int h2_warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(H2_FULL_MASK, v, o));
  return v;
}

// Warp-wide (value, index) maximum; ties go to the LARGER index (the
// "first max on the reversed axis" rule of ops/extend.py).
__device__ __forceinline__ void h2_warp_argmax_last(int& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    int v2 = __shfl_xor_sync(H2_FULL_MASK, v, o);
    int i2 = __shfl_xor_sync(H2_FULL_MASK, i, o);
    if (v2 > v || (v2 == v && i2 > i)) {
      v = v2;
      i = i2;
    }
  }
}

// numpy/JAX floor division for a positive divisor.
__device__ __forceinline__ int h2_floordiv(int a, int d) {
  int q = a / d;
  if ((a % d != 0) && (a < 0)) q -= 1;
  return q;
}

// A unit's slice of a global staging scratch: its bytes rounded up to 256.
__host__ __device__ inline size_t h2_slice(size_t bytes) {
  return (bytes + 255) & ~(size_t)255;
}

// Where a kernel stages the `per` bytes each of its units (a warp, or a
// whole block) works in.  Where one unit fits the dynamic shared memory a
// block of `shared_k` can opt in to (`room`), the caller sizes its shared
// launch.  Past it, the global instantiation `global_k` (`threads` threads
// of `units` units a block, no dynamic shared memory) stages in a slice
// of a global scratch per unit, over as many blocks as the card holds at
// once, no more than `blocks` (those the work needs) and no more than the
// caller's scratch of `have` bytes holds (a query passes SIZE_MAX); the
// blocks walk the work with a grid stride.  ops/ allocates `scratch`
// bytes (kernels.scratch).
struct H2Staging {
  bool global;
  size_t room;     // dynamic shared bytes a block of shared_k may use
  size_t slice;    // global: scratch bytes per unit
  long long grid;  // global: blocks
  size_t scratch;  // global: scratch bytes of the grid
};

template <class K>
inline cudaError_t h2_staging(K* shared_k, K* global_k, int threads,
                              int units, size_t per, long long blocks,
                              size_t have, H2Staging* s) {
  int dev = 0, cap = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, shared_k);
  if (e != cudaSuccess) return e;
  s->room = (size_t)cap - a.sharedSizeBytes;
  s->global = per > s->room;
  s->slice = s->scratch = 0;
  s->grid = blocks;
  if (!s->global) return cudaSuccess;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, global_k, threads,
                                                    0);
  if (e != cudaSuccess) return e;
  s->slice = h2_slice(per);
  const size_t block = s->slice * units;
  long long grid = (long long)sms * (occ > 0 ? occ : 1);
  if (blocks < grid) grid = blocks;
  if ((size_t)grid > have / block) grid = (long long)(have / block);
  if (grid < 1 && blocks > 0) return cudaErrorInvalidValue;
  s->grid = grid;
  s->scratch = block * (size_t)grid;
  return cudaSuccess;
}
