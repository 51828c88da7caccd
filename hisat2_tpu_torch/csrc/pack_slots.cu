// Kernel 6: unified slot selection, flags and the spill layout (K9).
//
// Replaces hisat2_tpu/align/pipeline.py:1278-1371 (the stable top-Mdev
// selection with ops/compact.py:stable_rank_asc + select_ranked, the best
// slot's alt, the flags byte, the d2 - d1 delta, and the spill D2H layout).
// Plain twin: hisat2_tpu_torch/ops/compact.py:pack_slots_plain.
//
// Input: the unified slot schema as one int32 tensor [F, N, K] (fields in
// the order of ops/compact.py:SLOT_FIELDS; the per-block concatenation
// stays torch glue).  Two launches on the caller's stream:
//   select (one warp per lane): the stable rank of every slot by
//     (valid desc, score desc) - the count of smaller keys plus equal keys
//     at lower index, as stable_rank_asc - the first Mdev slots, the best
//     slot by (valid ? score : -2^30) with the FIRST index on ties (as
//     jnp.argmax), the flags byte, the delta dd, and the dense outputs.  In
//     the spill layout it writes only slots 0-1 densely; slots 2..Mdev-1
//     go as their 4 packed words (+ the event row) to a scratch array,
//     and the lane's count of valid ones to cnt[n];
//   spill (one block): an exclusive scan over the N lane counts, then the
//     flat lane-major scatter of the valid spill slots into S rows, the
//     padding rows (source -1, words of flat slot 0, as the JAX gather at
//     max(src, 0) gives them), and the overflow mark -2 on the last row.
// No sort and no cumsum run on the card.  Spliced mode (a spliced or
// site-injecting pass, pipeline.py:1313-1318, :1351-1355): the dense d2
// itself instead of the delta, and 5 spill words (x alone in word 3, d2
// in word 4).
//
// Bound: per lane K keys and O(K^2 / 32) compares per thread, then
// Mdev * F scattered 4 B loads; the spill block is a scan over N ints and
// N * (Mdev - 2) row copies.  Both are tiny beside the sweeps.
#include "common.cuh"

enum {
  F_SCORE, F_D1, F_D2, F_X, F_KIND, F_SPLDIR, F_KNOWN, F_AB, F_POST,
  F_SELFGAP, F_NMM, F_NN, F_CLIPL, F_CLIPR, F_ALT, F_VALID, F_EVENT
};
#define PK_NFIELD_OUT 11  // score d1 x ab n_mm n_n clip_l clip_r flags dd event
#define PK_SPILL_THREADS 1024

#define PK_WORDS 6  // 4 or 5 packed words, then the event row

struct PackArgs {
  const int* uni;  // [F, N, K]
  int N, K, Mdev, do_select, spill, has_event, spliced;
  int* dense;      // [PK_NFIELD_OUT, N, Wd]: Wd = spill ? 2 : Mdev
  int* alt;        // [N]
  int* words;      // [N * (Mdev - 2), PK_WORDS] (spill)
  int* cnt;        // [N] (spill)
};

__device__ __forceinline__ int pk_clamp(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void pack_select_kernel(PackArgs A, int warps) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n = blockIdx.x * warps + wid;
  if (n >= A.N) return;  // uniform per warp
  const int K = A.K, Mdev = A.Mdev;
  int* sKey = smem + (size_t)wid * (K + Mdev);
  int* sSel = sKey + K;
  const size_t NK = (size_t)A.N * K;
  const int* row = A.uni + (size_t)n * K;
  auto fld = [&](int f, int j) { return row[f * NK + j]; };
  for (int j = lane; j < K; j += 32)
    sKey[j] = fld(F_VALID, j) > 0
                  ? (int)(0u - (unsigned)fld(F_SCORE, j)) : INT_MAX;
  __syncwarp();
  if (A.do_select) {
    for (int j = lane; j < K; j += 32) {
      const int kj = sKey[j];
      int r = 0;
      for (int k = 0; k < K; ++k) {
        const int kk = sKey[k];
        r += (kk < kj || (kk == kj && k < j)) ? 1 : 0;
      }
      if (r < Mdev) sSel[r] = j;
    }
  } else {
    for (int m = lane; m < Mdev; m += 32) sSel[m] = m;
  }
  __syncwarp();
  // best slot: first index of the maximum of (valid ? score : -2^30)
  int bv = INT_MIN, bm = INT_MAX;
  for (int m = lane; m < Mdev; m += 32) {
    const int j = sSel[m];
    const int v = fld(F_VALID, j) > 0 ? fld(F_SCORE, j) : -(1 << 30);
    if (v > bv) {  // m ascends per lane: the first maximum wins
      bv = v;
      bm = m;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(H2_FULL_MASK, bv, o);
    const int m2 = __shfl_xor_sync(H2_FULL_MASK, bm, o);
    if (v2 > bv || (v2 == bv && m2 < bm)) {
      bv = v2;
      bm = m2;
    }
  }
  if (lane == 0) A.alt[n] = fld(F_ALT, sSel[bm]);
  const int Wd = A.spill ? 2 : Mdev;
  const int Msp = Mdev - 2;
  const size_t NW = (size_t)A.N * Wd;
  int nvalid = 0;
  for (int m = lane; m < Mdev; m += 32) {
    const int j = sSel[m];
    const int valid = fld(F_VALID, j), spldir = fld(F_SPLDIR, j);
    const int cs = spldir > 0 ? 3 + spldir : fld(F_KIND, j);
    const int flags = valid | (fld(F_POST, j) << 1) |
                      (fld(F_SELFGAP, j) << 2) | (fld(F_KNOWN, j) << 3) |
                      (cs << 4);
    const int d1 = fld(F_D1, j);
    const int dd = (int)((unsigned)fld(F_D2, j) - (unsigned)d1);
    const int vals[PK_NFIELD_OUT] = {
        fld(F_SCORE, j), d1, fld(F_X, j), fld(F_AB, j), fld(F_NMM, j),
        fld(F_NN, j), fld(F_CLIPL, j), fld(F_CLIPR, j), flags,
        A.spliced ? fld(F_D2, j) : dd,
        A.has_event ? fld(F_EVENT, j) : 0};
    if (!A.spill || m < 2) {
      for (int f = 0; f < PK_NFIELD_OUT; ++f)
        A.dense[f * NW + (size_t)n * Wd + m] = vals[f];
    } else {
      const int sc16 = pk_clamp(vals[0], -32768, 32767);
      int* w = A.words + ((size_t)n * Msp + (m - 2)) * PK_WORDS;
      w[0] = d1;
      w[1] = (int)(((unsigned)sc16 & 0xFFFFu) |
                   (((unsigned)flags & 0x7Fu) << 16) |
                   ((unsigned)pk_clamp(vals[3], 0, 127) << 24));
      w[2] = (int)(((unsigned)pk_clamp(vals[6], 0, 255) & 0xFFu) |
                   (((unsigned)pk_clamp(vals[7], 0, 255) & 0xFFu) << 8) |
                   (((unsigned)pk_clamp(vals[4], 0, 255) & 0xFFu) << 16) |
                   ((unsigned)pk_clamp(vals[5], 0, 127) << 24));
      w[3] = A.spliced ? (int)((unsigned)pk_clamp(vals[2], 0, 255) & 0xFFu)
                       : (int)(((unsigned)pk_clamp(vals[2], 0, 255) & 0xFFu) |
                               (((unsigned)dd & 0xFFu) << 8));
      w[4] = fld(F_D2, j);
      w[5] = vals[10];
      nvalid += flags & 1;
    }
  }
  if (A.spill) {
    nvalid = h2_warp_sum(nvalid);
    if (lane == 0) A.cnt[n] = nvalid;
  }
}

// One block: exclusive scan of cnt into offs, then the lane-major scatter.
__global__ void pack_spill_kernel(const int* __restrict__ words,
                                  const int* __restrict__ cnt, int* offs,
                                  int N, int Msp, int S, int has_event,
                                  int nwd, int* src, int* sp_w, int* sp_ev) {
  __shared__ int sWarp[PK_SPILL_THREADS / 32];
  __shared__ int sCarry;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int nw = blockDim.x >> 5;
  if (t == 0) sCarry = 0;
  __syncthreads();
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + t;
    const int v = i < N ? cnt[i] : 0;
    const int incl = h2_warp_incl_sum(v, lane);
    if (lane == 31) sWarp[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      const int s = lane < nw ? sWarp[lane] : 0;
      const int si = h2_warp_incl_sum(s, lane);
      if (lane < nw) sWarp[lane] = si - s;  // exclusive warp offsets
    }
    __syncthreads();
    const int carry = sCarry;
    if (i < N) offs[i] = carry + sWarp[wid] + incl - v;
    __syncthreads();
    if (t == blockDim.x - 1) sCarry = carry + sWarp[wid] + incl;
    __syncthreads();
  }
  const int total = sCarry;
  for (int n = t; n < N; n += blockDim.x) {
    int r = offs[n];
    for (int m = 0; m < Msp && r < S; ++m) {
      const size_t f = (size_t)n * Msp + m;
      const int* w = words + f * PK_WORDS;
      if (!((w[1] >> 16) & 1)) continue;
      src[r] = (int)f;
      for (int k = 0; k < nwd; ++k) sp_w[(size_t)r * nwd + k] = w[k];
      if (has_event) sp_ev[r] = w[5];
      ++r;
    }
  }
  for (int r = total + t; r < S; r += blockDim.x) {
    src[r] = -1;
    for (int k = 0; k < nwd; ++k) sp_w[(size_t)r * nwd + k] = words[k];
    if (has_event) sp_ev[r] = words[5];
  }
  __syncthreads();
  if (t == 0 && total > S) {
    src[S - 1] = -2;
    for (int k = 0; k < nwd; ++k) sp_w[(size_t)(S - 1) * nwd + k] = words[k];
    if (has_event) sp_ev[S - 1] = words[5];
  }
}

H2_EXPORT int h2_pack_slots(const void* uni, int N, int K, int Mdev,
                            int do_select, int spill, int has_event,
                            int spliced, void* dense, void* alt, void* words, void* cnt,
                            void* offs, void* src, void* sp_w, void* sp_ev,
                            void* stream) {
  if (K < 1 || Mdev < 1 || Mdev > K || (spill && Mdev <= 2) ||
      (!do_select && Mdev != K))
    return (int)cudaErrorInvalidValue;
  PackArgs A{(const int*)uni, N, K, Mdev, do_select, spill, has_event,
             spliced, (int*)dense, (int*)alt, (int*)words, (int*)cnt};
  const size_t per_warp = (size_t)(K + Mdev) * sizeof(int);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pack_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + warps - 1) / warps;
  if (blocks <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  pack_select_kernel<<<blocks, 32 * warps, smem, st>>>(A, warps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !spill) return (int)e;
  pack_spill_kernel<<<1, PK_SPILL_THREADS, 0, st>>>(
      (const int*)words, (const int*)cnt, (int*)offs, N, Mdev - 2, N,
      has_event, spliced ? 5 : 4, (int*)src, (int*)sp_w, (int*)sp_ev);
  return (int)cudaGetLastError();
}
