// Kernel 5: full-SA resolve + candidate dedup and compaction (K3 fused
// into K4).
//
// Replaces hisat2_tpu/ops/resolve.py:resolve_consecutive, full-SA branch
// (:174-186), and the DNA-mode compaction of
// hisat2_tpu/align/pipeline.py:772-998 with ops/compact.py:22-62
// (select_ranked, take_cols).  Plain twin:
// hisat2_tpu_torch/ops/compact.py:compact_candidates_plain.
//
// One warp per lane (read strand).  The warp gates the lane's H hits (hit
// count, long/short row caps, the lite tier's caps), resolves the rows
// top..top+P-1 of every live hit straight from the suffix array, and keeps
// the J = H*P slot keys in shared memory:
//   ident = start (+ 2^30 for sweep-only slots), SENT for dead slots.
// It then keeps the first occurrence of each identity, ranks the kept
// slots by identity (kept identities are distinct, so the stable rank is
// the count of smaller kept keys), takes the first C, drops a short slot
// whose start also holds a long slot (dup_short), and reduces each taken
// slot's provenance over the J slots: min abefore, all-post, any
// align-capable.  Slots m < CC go to the core arrays, the rest to the
// extra arrays.  The JAX version builds [N, J, J] and [N, C, J] one-hot
// masks because the TPU had no fast gather; here every lookup is a direct
// index and the O(J^2) comparisons are spread over the warp's 32 lanes.
//
// Bound: per lane ~J reads of the SA (scattered, one 4 B load each) and
// O(J^2 / 32) shared-memory compares per thread; at J = 60 it is a few
// hundred instructions per thread, latency-bound on the SA gathers.
#include "common.cuh"

#define CC_SENT 0x7FFFFFFE  // 2^31 - 2
#define CC_SHORTBIT (1 << 30)
#define CC_BIG (1 << 30)

struct CompactArgs {
  const int* sa;
  const int* top;
  const int* bot;
  const int* lo;
  const int* hi;
  const int* nh;
  const int* abefore;
  const uint8_t* post;
  const uint8_t* stopped;
  int N, H, P, C, CC, min_k, maxsize, short_rows, lite_cap, lane_meta;
  int* cstart;   // [N, CC]
  uint8_t* cvalid;
  uint8_t* cvalid_long;
  int* cab;
  uint8_t* cpost;
  int* xstart;   // [N, C - CC]
  uint8_t* xvalid;
  int* xab;
  uint8_t* xpost;
  int* h_minw;   // [N] (lane_meta)
  uint8_t* h_alignable;
  int* h_sat;    // [N] (lite)
};

__host__ __device__ inline int cc_warp_ints(int J, int C, int H) {
  return 3 * J + 3 * C + 2 * H;
}

__global__ void compact_cands_kernel(CompactArgs A, int warps) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n = blockIdx.x * warps + wid;
  if (n >= A.N) return;  // uniform per warp
  const int H = A.H, P = A.P, C = A.C, J = H * P;
  int* sIdent = smem + (size_t)wid * cc_warp_ints(J, C, H);
  int* sStart = sIdent + J;
  int* sFlag = sStart + J;     // bit0 live, bit1 align-capable, bit2 kept
  int* sSlot = sFlag + J;      // [C] slot -> source j, -1 if empty
  int* sCStart = sSlot + C;    // [C]
  int* sCFlag = sCStart + C;   // [C] bit0 taken, bit1 short
  int* sAb = sCFlag + C;       // [H]
  int* sPost = sAb + H;        // [H]
  const int nh = A.nh[n];
  const bool stopped = A.stopped[n] != 0;
  const bool lite = A.lite_cap > 0;
  const int full_max = A.maxsize;
  const int maxsize = lite ? min(A.maxsize, A.lite_cap) : A.maxsize;
  const int* top = A.top + (size_t)n * H;
  const int* bot = A.bot + (size_t)n * H;
  const int* lo = A.lo + (size_t)n * H;
  const int* hi = A.hi + (size_t)n * H;

  // --- per-hit gates and lane metadata ---
  int minw = CC_BIG, alignable = 0, wide = 0;
  for (int h = lane; h < H; h += 32) {
    const int w = (int)((unsigned)bot[h] - (unsigned)top[h]);
    const bool islong = (int)((unsigned)hi[h] - (unsigned)lo[h]) > A.min_k + 2;
    const bool hv0 = h < nh;
    const bool hv = hv0 && (!lite || islong) &&
                    (islong ? w <= maxsize : w <= A.short_rows);
    const bool hv_meta =
        lite ? hv0 && (islong ? w <= full_max : w <= A.short_rows) : hv;
    if (hv_meta && w > 0) minw = min(minw, w);
    if (islong && (w == 1 || !stopped)) alignable = 1;
    if (lite && hv0 && islong && w > maxsize && w <= full_max) wide = 1;
    sAb[h] = A.abefore[(size_t)n * H + h];
    sPost[h] = A.post[(size_t)n * H + h];
  }
  // --- resolve rows top..top+P-1 and form the slot keys ---
  for (int j = lane; j < J; j += 32) {
    const int h = j / P, jj = j - h * P;
    const int t = top[h];
    const int w = (int)((unsigned)bot[h] - (unsigned)t);
    const bool islong = (int)((unsigned)hi[h] - (unsigned)lo[h]) > A.min_k + 2;
    const bool hv = h < nh && (!lite || islong) &&
                    (islong ? w <= maxsize : w <= A.short_rows);
    const bool cv = hv && jj < w;
    const bool align = islong && (w == 1 || !stopped);
    int st = 0, ident = CC_SENT;
    if (cv) {
      st = (int)((unsigned)__ldg(A.sa + ((long long)t + jj)) - (unsigned)lo[h]);
      ident = (int)((unsigned)st + (align ? 0u : (unsigned)CC_SHORTBIT));
    }
    sIdent[j] = ident;
    sStart[j] = st;
    sFlag[j] = (cv ? 1 : 0) | (align ? 2 : 0);
  }
  for (int m = lane; m < C; m += 32) sSlot[m] = -1;
  __syncwarp();
  // --- first occurrence of each identity ---
  for (int j = lane; j < J; j += 32) {
    const int id = sIdent[j];
    bool kept = id != CC_SENT;
    for (int k = 0; k < j && kept; ++k) kept = sIdent[k] != id;
    if (kept) sFlag[j] |= 4;
  }
  __syncwarp();
  // --- stable rank among kept slots; take the first C ---
  int nlong = 0;
  for (int j = lane; j < J; j += 32) {
    if (!(sFlag[j] & 4)) continue;
    const int id = sIdent[j];
    int r = 0;
    for (int k = 0; k < J; ++k) r += ((sFlag[k] & 4) && sIdent[k] < id) ? 1 : 0;
    if (r < C) sSlot[r] = j;
    if (sFlag[j] & 2) ++nlong;
  }
  __syncwarp();
  for (int m = lane; m < C; m += 32) {
    const int j = sSlot[m];
    sCStart[m] = j >= 0 ? sStart[j] : 0;
    sCFlag[m] = j >= 0 ? (1 | ((sFlag[j] & 2) ? 0 : 2)) : 0;
  }
  __syncwarp();
  // --- dup_short and per-slot provenance ---
  for (int m = lane; m < C; m += 32) {
    const int cs = sCStart[m];
    const int cf = sCFlag[m];
    bool valid = (cf & 1) != 0;
    if (cf & 2) {
      for (int m2 = 0; m2 < C; ++m2)
        if (sCStart[m2] == cs && sCFlag[m2] == 1) valid = false;
    }
    int ab = CC_BIG;
    bool allpost = true, anyalign = false;
    for (int j = 0; j < J; ++j) {
      const int f = sFlag[j];
      if (!(f & 1) || sStart[j] != cs) continue;
      const int h = j / P;
      ab = min(ab, sAb[h]);
      allpost = allpost && sPost[h] != 0;
      anyalign = anyalign || (f & 2);
    }
    const bool vlong = valid && anyalign;
    if (m < A.CC) {
      const size_t o = (size_t)n * A.CC + m;
      A.cstart[o] = cs;
      A.cvalid[o] = valid ? 1 : 0;
      A.cvalid_long[o] = vlong ? 1 : 0;
      A.cab[o] = ab;
      A.cpost[o] = allpost ? 1 : 0;
    } else {
      const size_t o = (size_t)n * (C - A.CC) + (m - A.CC);
      A.xstart[o] = cs;
      A.xvalid[o] = vlong ? 1 : 0;
      A.xab[o] = ab;
      A.xpost[o] = allpost ? 1 : 0;
    }
  }
  // --- lane outputs ---
  minw = -h2_warp_max(-minw);
  alignable = h2_warp_max(alignable);
  wide = h2_warp_max(wide);
  nlong = h2_warp_sum(nlong);
  if (lane == 0) {
    if (A.lane_meta) {
      A.h_minw[n] = minw;
      A.h_alignable[n] = alignable ? 1 : 0;
    }
    if (lite) A.h_sat[n] = min(nlong, 63) + 64 * wide;
  }
}

H2_EXPORT int h2_compact_cands(
    const void* sa, const void* top, const void* bot, const void* lo,
    const void* hi, const void* nh, const void* abefore, const void* post,
    const void* stopped, int N, int H, int P, int C, int CC, int min_k,
    int maxsize, int short_rows, int lite_cap, int lane_meta, void* cstart,
    void* cvalid, void* cvalid_long, void* cab, void* cpost, void* xstart,
    void* xvalid, void* xab, void* xpost, void* h_minw, void* h_alignable,
    void* h_sat, void* stream) {
  if (H < 1 || P < 1 || C < 1 || CC < 0 || CC > C)
    return (int)cudaErrorInvalidValue;
  CompactArgs A{(const int*)sa, (const int*)top, (const int*)bot,
                (const int*)lo, (const int*)hi, (const int*)nh,
                (const int*)abefore, (const uint8_t*)post,
                (const uint8_t*)stopped, N, H, P, C, CC, min_k, maxsize,
                short_rows, lite_cap, lane_meta, (int*)cstart,
                (uint8_t*)cvalid, (uint8_t*)cvalid_long, (int*)cab,
                (uint8_t*)cpost, (int*)xstart, (uint8_t*)xvalid, (int*)xab,
                (uint8_t*)xpost, (int*)h_minw, (uint8_t*)h_alignable,
                (int*)h_sat};
  const size_t per_warp = (size_t)cc_warp_ints(H * P, C, H) * sizeof(int);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compact_cands_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + warps - 1) / warps;
  if (blocks > 0)
    compact_cands_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
        A, warps);
  return (int)cudaGetLastError();
}
