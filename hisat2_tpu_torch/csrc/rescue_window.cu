// Kernel 8: the top 8 diagonals of a mate-rescue window (K12).
//
// Replaces the cross-correlation and top_k of
// hisat2_tpu/ops/rescue.py:rescue_candidates (:39-59): for job r with
// window start ws = win_start[r] and read reads[r, :L],
//   matches[d] = sum_t [read[t] == ref[ws + d + t]],  d in [0, W),
// where a read code 4 (N, padding) and a position outside [0, n_text)
// match nothing; each count is rounded to the nearest bfloat16 value
// (ties to even), as the JAX one-hot convolution on bf16 inputs returns
// it, and the 8 largest are kept in lax.top_k's order: count descending,
// then d ascending.  out[r, i] = ws + d_i.  The rescoring of those 8
// diagonals is kernels 2 and 3 (ops/rescue.py).
// Plain twin: hisat2_tpu_torch/ops/rescue.py:rescue_window_plain.
//
// One block per job.  The window's chars are staged 2-bit packed in
// shared memory (~14 KB for W = 57,344), with a validity plane used only
// when the window leaves the text; the read is packed the same way with a
// mask of its ACGT columns.  Each thread counts a strided set of
// diagonals: per 16 read chars one funnel shift aligns the window word to
// the diagonal, and an xor/or/and/popc counts the equal 2-bit fields, so a
// diagonal of a 100 bp read costs 7 words.  Each thread keeps a private
// top 8 as 64-bit keys (rounded count << 32 | ~d, unique per d), warps
// merge theirs by shuffles, and warp 0 merges the warps'.
//
// Bound: operations.  W * L compares per job (2 * 4 * W * L flops as the
// JAX one-hot product, ~46 MFLOP for L = 100), against ~0.1 MB of window
// and read per job; this CUDA-core kernel does them 16 at a time with
// integer ops, far from the tensor-core rate the bound assumes.
#include "common.cuh"

namespace {

constexpr int RW_THREADS = 512;
constexpr int RW_TOP = 8;
constexpr int RW_MAX_READ_WORDS = 64;  // reads up to 1024 bp

// A match count rounded to the nearest bfloat16 value, ties to even
// (8 significant bits: counts below 256 are exact).
__device__ __forceinline__ unsigned bf16_round(unsigned c) {
  if (c < 256u) return c;
  const int sh = (32 - __clz(c)) - 8;
  unsigned q = c >> sh;
  const unsigned rem = c & ((1u << sh) - 1u);
  const unsigned half = 1u << (sh - 1);
  if (rem > half || (rem == half && (q & 1u))) q += 1u;
  return q << sh;
}

// Insert key into a descending list of 8 (keys are unique or 0 = empty).
__device__ __forceinline__ void top8_insert(unsigned long long (&best)[8],
                                            unsigned long long key) {
#pragma unroll
  for (int i = 0; i < RW_TOP; ++i) {
    const unsigned long long hi = best[i] > key ? best[i] : key;
    key = best[i] > key ? key : best[i];
    best[i] = hi;
  }
}

// Merge the 32 lanes' descending lists into the warp's top 8; lane 0
// writes them to out[0..7].
__device__ __forceinline__ void warp_top8(unsigned long long (&best)[8],
                                          unsigned long long* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RW_TOP; ++i) {
    unsigned long long m = best[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long t = __shfl_xor_sync(H2_FULL_MASK, m, o);
      m = t > m ? t : m;
    }
    if (m != 0ull && best[0] == m) {
#pragma unroll
      for (int j = 0; j < RW_TOP - 1; ++j) best[j] = best[j + 1];
      best[RW_TOP - 1] = 0ull;
    }
    if (lane == 0) out[i] = m;
  }
}

__global__ void __launch_bounds__(RW_THREADS)
rescue_window_kernel(const uint32_t* __restrict__ ref_words, int n_words,
                     long long n_text, const int* __restrict__ reads,
                     const int* __restrict__ win_start, int L, int W,
                     int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t rw[RW_MAX_READ_WORDS];
  __shared__ uint32_t rm[RW_MAX_READ_WORDS];
  __shared__ unsigned long long wtop[RW_THREADS / 32 * RW_TOP];
  const int r = blockIdx.x;
  const int nwr = (L + 15) >> 4;
  const int nww = ((W - 1) >> 4) + nwr + 1;
  uint32_t* win = smem;          // [nww] 2-bit window chars
  uint32_t* wval = smem + nww;   // [nww] 0b01 per in-text char
  const long long ws = win_start[r];
  const long long span = (long long)W + L - 1;
  const bool need_mask = ws < 0 || ws + span > n_text;
  const bool fast = (ws & 15) == 0 && ws >= 0 &&
                    ws + 16LL * nww <= n_text && (ws >> 4) + nww <= n_words;
  for (int k = threadIdx.x; k < nww; k += blockDim.x) {
    uint32_t w = 0u, v = 0u;
    if (fast) {
      w = __ldg(ref_words + (ws >> 4) + k);
      v = 0x55555555u;
    } else {
      for (int j = 0; j < 16; ++j) {
        const long long p = ws + 16LL * k + j;
        if (p >= 0 && p < n_text && (p >> 4) < n_words) {
          const uint32_t c =
              (__ldg(ref_words + (p >> 4)) >> (2 * (p & 15))) & 3u;
          w |= c << (2 * j);
          v |= 1u << (2 * j);
        }
      }
    }
    win[k] = w;
    wval[k] = v;
  }
  for (int k = threadIdx.x; k < nwr; k += blockDim.x) {
    uint32_t w = 0u, m = 0u;
    for (int j = 0; j < 16; ++j) {
      const int t = 16 * k + j;
      if (t < L) {
        const int c = reads[(long long)r * L + t];
        if (c >= 0 && c < 4) {
          w |= (uint32_t)c << (2 * j);
          m |= 1u << (2 * j);
        }
      }
    }
    rw[k] = w;
    rm[k] = m;
  }
  __syncthreads();

  unsigned long long best[RW_TOP];
#pragma unroll
  for (int i = 0; i < RW_TOP; ++i) best[i] = 0ull;
  for (int d = threadIdx.x; d < W; d += blockDim.x) {
    const int base = d >> 4;
    const int sh = 2 * (d & 15);
    unsigned cnt = 0u;
    uint32_t lo = win[base];
    if (need_mask) {
      uint32_t vlo = wval[base];
      for (int k = 0; k < nwr; ++k) {
        const uint32_t hi = win[base + k + 1];
        const uint32_t vhi = wval[base + k + 1];
        const uint32_t x = __funnelshift_r(lo, hi, sh) ^ rw[k];
        cnt += __popc(~(x | (x >> 1)) & rm[k] &
                      __funnelshift_r(vlo, vhi, sh));
        lo = hi;
        vlo = vhi;
      }
    } else {
      for (int k = 0; k < nwr; ++k) {
        const uint32_t hi = win[base + k + 1];
        const uint32_t x = __funnelshift_r(lo, hi, sh) ^ rw[k];
        cnt += __popc(~(x | (x >> 1)) & rm[k]);
        lo = hi;
      }
    }
    const unsigned long long key =
        ((unsigned long long)bf16_round(cnt) << 32) |
        (unsigned long long)(0xFFFFFFFFu - (unsigned)d);
    if (key > best[RW_TOP - 1]) top8_insert(best, key);
  }

  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_top8(best, wtop + warp * RW_TOP);
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < RW_TOP; ++i) best[i] = 0ull;
    for (int i = threadIdx.x; i < nwarps * RW_TOP; i += 32)
      top8_insert(best, wtop[i]);
    warp_top8(best, wtop);
    __syncwarp();
    if (threadIdx.x < RW_TOP) {
      const unsigned d =
          0xFFFFFFFFu - (unsigned)(wtop[threadIdx.x] & 0xFFFFFFFFull);
      out[(long long)r * RW_TOP + threadIdx.x] = (int)(ws + (long long)d);
    }
  }
}

}  // namespace

H2_EXPORT int h2_rescue_window(const void* ref_words, int n_words,
                               long long n_text, const void* reads,
                               const void* win_start, int R, int L, int W,
                               void* out, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (L < 1 || L > 16 * RW_MAX_READ_WORDS || W < RW_TOP)
    return (int)cudaErrorInvalidValue;
  const int nwr = (L + 15) >> 4;
  const int nww = ((W - 1) >> 4) + nwr + 1;
  const size_t smem = 2 * (size_t)nww * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rescue_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rescue_window_kernel<<<R, RW_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)ref_words, n_words, n_text, (const int*)reads,
      (const int*)win_start, L, W, (int*)out);
  return (int)cudaGetLastError();
}
