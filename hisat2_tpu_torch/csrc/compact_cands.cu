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
// Sampled SA (off_rate > 0): the rows' offsets come resolved by the walk
// (csrc/resolve_walk.cu, K19+K20) as offs [N, H, P] and offs2 [N, H2, P2],
// read in place of the SA for the same live slots.
//
// Spliced mode (pipeline.py:846-933): the prefix re-search's H2 hits add
// P2 sweep-only rows each (J = H*P + H2*P2 slots); a short slot survives
// only within max_intron of one of the lane's 8 lowest align-capable
// starts (int32 distances wrap, as JAX's), and short slots rank by that
// distance (ties by slot index, the stable rank of JAX), the re-search
// rows inheriting the lane's last hit's provenance.
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
  const int* top2;  // [N, H2] the spliced prefix re-search (H2 = 0: none)
  const int* bot2;
  const int* lo2;
  const int* nh2;
  const int* offs;   // [N, H, P] resolved rows of a sampled SA, or null
  const int* offs2;  // [N, H2, P2] the re-search's (spliced), or null
  int N, H, P, C, CC, min_k, maxsize, short_rows, lite_cap, lane_meta;
  int H2, P2, max_intron;
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
  return 4 * J + 3 * C + 2 * H + 8;
}

// |a - b| in wrapping int32, |INT_MIN| = INT_MIN as jnp.abs
__device__ __forceinline__ int cc_wrap_absdiff(int a, int b) {
  const int d = (int)((unsigned)a - (unsigned)b);
  return d < 0 ? (int)(0u - (unsigned)d) : d;
}

// GLOBAL: each warp keeps its pool in its slice of `scratch` (cc_config),
// not in shared memory (a separate instantiation, so that the shared one
// keeps its shared-memory accesses), the warps walking the lanes with a
// grid stride; else a warp per lane, its pool in dynamic shared memory
template <bool GLOBAL>
__global__ void compact_cands_kernel(CompactArgs A, int warps,
                                     int* scratch) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int H = A.H, P = A.P, C = A.C, J1 = H * P;
  const int J = J1 + A.H2 * A.P2;
  const bool spliced = A.H2 > 0;
  const size_t per = cc_warp_ints(J, C, H);
  int* sIdent = GLOBAL ? scratch + ((size_t)blockIdx.x * warps + wid) *
                                       (h2_slice(per * sizeof(int)) /
                                        sizeof(int))
                       : smem + (size_t)wid * per;
  for (int n = blockIdx.x * warps + wid; n < A.N;
       n += gridDim.x * warps) {  // uniform per warp
    int* sStart = sIdent + J;
    int* sFlag = sStart + J;     // bit0 live, bit1 align-capable, bit2 kept
    int* sSlot = sFlag + J;      // [C] slot -> source j, -1 if empty
    int* sCStart = sSlot + C;    // [C]
    int* sCFlag = sCStart + C;   // [C] bit0 taken, bit1 short
    int* sAb = sCFlag + C;       // [H]
    int* sPost = sAb + H;        // [H]
    int* sSkey = sPost + H;      // [J] compaction key
    int* sLsort = sSkey + J;     // [8] lowest align-capable starts
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
      const bool islong =
          (int)((unsigned)hi[h] - (unsigned)lo[h]) > A.min_k + 2;
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
      if (j >= J1) {  // a re-search row: sweep-only
        const int j2 = j - J1, h2 = j2 / A.P2, jj = j2 - h2 * A.P2;
        const size_t o2 = (size_t)n * A.H2 + h2;
        const int t = A.top2[o2];
        const int w2 = (int)((unsigned)A.bot2[o2] - (unsigned)t);
        const bool cv = h2 < A.nh2[n] && w2 <= A.P2 && jj < w2;
        int st = 0;
        if (cv)
          st = (int)((unsigned)(A.offs2 != nullptr
                                    ? A.offs2[o2 * A.P2 + jj]
                                    : __ldg(A.sa + ((long long)t + jj))) -
                     (unsigned)A.lo2[o2]);
        sIdent[j] = cv ? (int)((unsigned)st + (unsigned)CC_SHORTBIT)
                       : CC_SENT;
        sStart[j] = st;
        sFlag[j] = cv ? 1 : 0;
        continue;
      }
      const int h = j / P, jj = j - h * P;
      const int t = top[h];
      const int w = (int)((unsigned)bot[h] - (unsigned)t);
      const bool islong =
          (int)((unsigned)hi[h] - (unsigned)lo[h]) > A.min_k + 2;
      const bool hv = h < nh && (!lite || islong) &&
                      (islong ? w <= maxsize : w <= A.short_rows);
      const bool cv = hv && jj < w;
      const bool align = islong && (w == 1 || !stopped);
      int st = 0, ident = CC_SENT;
      if (cv) {
        const int off = A.offs != nullptr
                            ? A.offs[((size_t)n * H + h) * P + jj]
                            : __ldg(A.sa + ((long long)t + jj));
        st = (int)((unsigned)off - (unsigned)lo[h]);
        ident = (int)((unsigned)st + (align ? 0u : (unsigned)CC_SHORTBIT));
      }
      sIdent[j] = ident;
      sStart[j] = st;
      sFlag[j] = (cv ? 1 : 0) | (align ? 2 : 0);
    }
    for (int m = lane; m < C; m += 32) sSlot[m] = -1;
    for (int k = lane; k < 8; k += 32) sLsort[k] = CC_SENT;
    __syncwarp();
    if (spliced) {
      // the 8 lowest align-capable starts, duplicates kept (sort + [:8])
      for (int j = lane; j < J; j += 32) {
        if ((sFlag[j] & 3) != 3) continue;
        const int v = sStart[j];
        int r = 0;
        for (int k = 0; k < J; ++k)
          if ((sFlag[k] & 3) == 3) {
            const int u = sStart[k];
            r += (u < v || (u == v && k < j)) ? 1 : 0;
          }
        if (r < 8) sLsort[r] = v;
      }
      __syncwarp();
      // proximity filter and the distance key
      for (int j = lane; j < J; j += 32) {
        const int st = sStart[j];
        int ad = INT_MAX;
        for (int k = 0; k < 8; ++k)
          ad = min(ad, cc_wrap_absdiff(st, sLsort[k]));
        int f = sFlag[j];
        const bool align = (f & 2) != 0;
        if ((f & 1) && !align && !(ad <= A.max_intron)) f &= ~1;
        sFlag[j] = f;
        const bool cv = f & 1;
        sIdent[j] = cv ? (int)((unsigned)st +
                               (align ? 0u : (unsigned)CC_SHORTBIT))
                       : CC_SENT;
        sSkey[j] = !cv ? CC_SENT
                 : align ? st
                 : (int)((unsigned)CC_SHORTBIT +
                         (unsigned)min(ad, CC_SHORTBIT - 1));
      }
    } else {
      for (int j = lane; j < J; j += 32) sSkey[j] = sIdent[j];
    }
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
      const int key = sSkey[j];
      int r = 0;
      for (int k = 0; k < J; ++k)
        if (sFlag[k] & 4) {
          const int u = sSkey[k];
          r += (u < key || (u == key && k < j)) ? 1 : 0;
        }
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
        const int h = j < J1 ? j / P : max(nh - 1, 0);
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
    __syncwarp();  // the next lane reuses the pool
  }
}

// warps per block (up to 4 within 48 KB of shared memory, else as many
// as the opt-in limit holds) and their dynamic shared bytes, else
// (h2_staging) CC_WARPS warps without shared memory, each keeping its
// pool in its slice of a scratch of `have` bytes
#define CC_WARPS 4
static cudaError_t cc_config(int J, int C, int H, int N, size_t have,
                             int* warps, size_t* smem, H2Staging* st) {
  const size_t per = (size_t)cc_warp_ints(J, C, H) * sizeof(int);
  cudaError_t e = h2_staging(compact_cands_kernel<false>,
                             compact_cands_kernel<true>, 32 * CC_WARPS,
                             CC_WARPS, per, (N + CC_WARPS - 1) / CC_WARPS,
                             have, st);
  if (e != cudaSuccess) return e;
  int w = CC_WARPS;
  while (!st->global && w > 1 && w * per > 48 * 1024) w >>= 1;
  *warps = w;
  *smem = st->global ? 0 : w * per;
  if (!st->global) st->grid = (N + w - 1) / w;
  return cudaSuccess;
}

// The global scratch h2_compact_cands needs for N lanes at these shapes
// (0: none).
H2_EXPORT int h2_compact_cands_scratch(int H, int P, int C, int H2, int P2,
                                       int N, long long* bytes) {
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e = cc_config(H * P + H2 * P2, C, H, N, SIZE_MAX, &warps,
                            &smem, &st);
  *bytes = (long long)st.scratch;
  return (int)e;
}

H2_EXPORT int h2_compact_cands(
    const void* sa, const void* top, const void* bot, const void* lo,
    const void* hi, const void* nh, const void* abefore, const void* post,
    const void* stopped, const void* top2, const void* bot2,
    const void* lo2, const void* nh2, const void* offs, const void* offs2,
    int N, int H, int P, int C, int CC,
    int min_k, int maxsize, int short_rows, int lite_cap, int lane_meta,
    int H2, int P2, int max_intron, void* cstart,
    void* cvalid, void* cvalid_long, void* cab, void* cpost, void* xstart,
    void* xvalid, void* xab, void* xpost, void* h_minw, void* h_alignable,
    void* h_sat, void* scratch, long long scratch_bytes, void* stream) {
  if (H < 1 || P < 1 || C < 1 || CC < 0 || CC > C)
    return (int)cudaErrorInvalidValue;
  CompactArgs A{(const int*)sa, (const int*)top, (const int*)bot,
                (const int*)lo, (const int*)hi, (const int*)nh,
                (const int*)abefore, (const uint8_t*)post,
                (const uint8_t*)stopped, (const int*)top2, (const int*)bot2,
                (const int*)lo2, (const int*)nh2, (const int*)offs,
                (const int*)offs2, N, H, P, C, CC, min_k,
                maxsize, short_rows, lite_cap, lane_meta, H2, P2,
                max_intron, (int*)cstart,
                (uint8_t*)cvalid, (uint8_t*)cvalid_long, (int*)cab,
                (uint8_t*)cpost, (int*)xstart, (uint8_t*)xvalid, (int*)xab,
                (uint8_t*)xpost, (int*)h_minw, (uint8_t*)h_alignable,
                (int*)h_sat};
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e = cc_config(H * P + H2 * P2, C, H, N,
                            scratch ? (size_t)scratch_bytes : 0, &warps,
                            &smem, &st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = st.grid;
  auto kern = st.global ? compact_cands_kernel<true>
                        : compact_cands_kernel<false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0)
    kern<<<(unsigned)blocks, 32 * warps, smem, (cudaStream_t)stream>>>(A, warps,
                                                             (int*)scratch);
  return (int)cudaGetLastError();
}
