// Kernel 6: unified slot merge, selection, flags and the spill layout (K9).
//
// Replaces hisat2_tpu/align/pipeline.py:1211-1375: the unified slot schema
// (the ungapped slots, then every junction block, with the schema's
// defaults), the stable top-Mdev selection by (valid desc, score desc)
// (ops/compact.py:stable_rank_asc + select_ranked), the best slot's alt,
// the flags byte, the d2 - d1 delta, and the spill D2H layout.  Plain twin:
// hisat2_tpu_torch/ops/compact.py:pack_slots_plain (on the schema that
// ops/compact.py:slot_schema concatenates).
//
// Input: the blocks read in place.  A table gives, per block, its column
// offset in the schema and, per field (ops/compact.py:SLOT_FIELDS order), a
// pointer, its element type (int32, int64, int16, int8, uint8 / bool) and
// its two strides, or a constant (an absent field's default: n_mm, n_n,
// clip_l, clip_r 0, alt NO_ALT, event -1, or a block's constant plane), or
// "valid from score" (score > -2^30).  The schema is never materialised.
//
// One launch.  A warp per lane (read strand), 8 lanes a block:
//   keys: the lane's K keys (valid ? -score : INT_MAX, biased unsigned) in
//     shared memory, a thread's slots j = lane + 32 i, PK_BATCH loads in
//     flight;
//   selection: the keys below INT_MAX (valid slots) by rounds of a warp
//     minimum over (key, slot) as one 64-bit value, each thread caching
//     the least of its K/32 keys above the last pick (only the owner of a
//     pick rescans): O(min(V, Mdev) * K / 32) a thread for V valid slots,
//     ties by lower slot index (the stable sort); then the slots of key
//     INT_MAX in slot order, by a ballot prefix count;
//   gather: each selected slot's fields, once, from its block; the best
//     slot's alt (first maximum of valid ? score : -2^30), the flags byte,
//     dd (or d2 in spliced mode), the dense outputs;
//   spill layout (slots 2..Mdev-1 of every lane, lane-major, packed into
//     S = N rows of 4 words, 5 in spliced mode, and the event row): the
//     row offsets are a device-wide exclusive scan of the lanes' counts of
//     valid spill slots, by a single-pass decoupled look-back (blocks take
//     their lane range from an atomic ticket, so a block waits only on
//     blocks already running; warp 0 of a block reads 32 predecessors'
//     states at once; summing every lower ticket's count instead, with no
//     chain, measured 5 us slower at N = 8,192); each warp then writes
//     its valid spill slots at its offset.  The block with the last
//     ticket waits for every block's rows, then writes the padding rows
//     (source -1, the words of flat slot 0 = lane 0's slot 2, as JAX's
//     gather at max(src, 0) gives them) and, past an overflow, -2 on the
//     last row.  Exact prefix sums: the layout does not depend on the
//     order the blocks run in.
// Spliced mode (a spliced or site-injecting pass, pipeline.py:1313-1318,
// :1351-1355): the dense d2 itself instead of the delta, and 5 spill
// words (x alone in word 3, d2 in word 4).
//
// Bound: bytes.  Per lane the K keys' score and valid planes, then Mdev x
// 16 scattered field loads (each distinct plane once); the outputs:
// 0.0019 ms on a linear step, 0.0167 on config 6's full step
// (chip_smoke.py:work).  Measured on an H100 (PERF.md): 0.031 and 0.043
// ms.  A copy that stops before the spill layout takes 0.020 on the
// linear step: the layout's scan and the last block's padding rows cost
// 11-12 us; the rest is latency over two waves of blocks (40 registers:
// 6 blocks an SM).  The previous design's two launches (a warp per lane
// ranking all K keys, then one block of 1024 threads for the scan and
// every row) took 0.058-0.21 ms behind 0.094-0.42 ms of torch.stack /
// torch.cat building the schema.
#include <string.h>

#include "common.cuh"

enum {
  F_SCORE, F_D1, F_D2, F_X, F_KIND, F_SPLDIR, F_KNOWN, F_AB, F_POST,
  F_SELFGAP, F_NMM, F_NN, F_CLIPL, F_CLIPR, F_ALT, F_VALID, F_EVENT,
  PK_NF
};
// a field's element type, or how its value is made (ops/compact.py:
// _PK_KIND)
enum { PK_CONST, PK_I32, PK_U8, PK_I8, PK_I16, PK_I64, PK_FROM_SCORE };
#define PK_MAXB 8            // blocks of the schema
#define PK_WARPS 8           // lanes a block
#define PK_NFIELD_OUT 11     // score d1 x ab n_mm n_n clip_l/r flags dd event
#define PK_WORDS 6           // 4 or 5 packed words, then the event row
#define PK_BATCH 4           // key loads a thread issues together
// the scan state (uint64 words): ticket, done, the 6 words of flat slot 0,
// then one state per block: flag << 32 | count (1 aggregate, 2 inclusive)
#define PK_ST_TICKET 0
#define PK_ST_DONE 1
#define PK_ST_PAD 2
#define PK_ST_BLOCKS 5

struct PkField {   // 24 bytes; ops/compact.py:_PK_FIELD
  const void* p;
  int sn, sk;      // strides in elements: lane, column
  int kind, cval;
};

struct PackArgs {
  PkField tab[PK_MAXB * PK_NF];
  int k0[PK_MAXB + 1];   // column offsets of the blocks, k0[nblk] = K
  int nblk, N, K, Mdev, do_select, spill, has_event, spliced, warps;
  int* dense;      // [PK_NFIELD_OUT, N, Wd]: Wd = spill ? 2 : Mdev
  int* alt;        // [N]
  int* src;        // [N] (spill)
  int* sp_w;       // [N, 4 or 5] (spill)
  int* sp_ev;      // [N] (spill with the event row)
  unsigned long long* state;  // (spill) zeroed by the entry point
};

__device__ __forceinline__ int pk_clamp(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int pk_load(const PkField& d, int n, int jj) {
  const long long o = (long long)n * d.sn + (long long)jj * d.sk;
  switch (d.kind) {
    case PK_I32: return __ldg((const int*)d.p + o);
    case PK_U8: return (int)__ldg((const unsigned char*)d.p + o);
    case PK_I8: return (int)__ldg((const signed char*)d.p + o);
    case PK_I16: return (int)__ldg((const short*)d.p + o);
    case PK_I64: return (int)__ldg((const long long*)d.p + o);  // wraps
    default: return d.cval;
  }
}

__device__ __forceinline__ unsigned long long pk_warp_min64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(H2_FULL_MASK, v, o);
    v = u < v ? u : v;
  }
  return v;
}

// the least (key << 32 | slot) of this thread's slots above `floor`
__device__ __forceinline__ unsigned long long pk_least_above(
    const unsigned* sKey, int K, int lane, unsigned long long floor,
    bool any) {
  unsigned long long best = ~0ull;
  for (int j = lane; j < K; j += 32) {
    const unsigned long long c = ((unsigned long long)sKey[j] << 32) | j;
    if ((any || c > floor) && c < best) best = c;
  }
  return best;
}

__host__ __device__ inline size_t pk_warp_bytes(int K, int Mdev, int spill) {
  return (size_t)(K + Mdev + (spill ? (Mdev - 2) * PK_WORDS : 0)) * 4;
}

__host__ __device__ inline size_t pk_head_bytes(int nblk, int warps) {
  return (size_t)nblk * PK_NF * sizeof(PkField) +
         (size_t)(PK_MAXB + 1 + 4 + warps) * 4;
}

__global__ void __launch_bounds__(PK_WARPS * 32)
    pack_slots_kernel(const __grid_constant__ PackArgs A) {
  extern __shared__ __align__(16) unsigned char pk_smem[];
  PkField* sTab = reinterpret_cast<PkField*>(pk_smem);
  int* sK0 = reinterpret_cast<int*>(sTab + A.nblk * PK_NF);
  int* sMisc = sK0 + PK_MAXB + 1;  // ticket, exclusive offset, total, -
  int* sCnt = sMisc + 4;           // [warps] valid spill slots per warp
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int warps = A.warps;
  {
    const int* src = reinterpret_cast<const int*>(A.tab);
    int* dst = reinterpret_cast<int*>(sTab);
    const int nw = A.nblk * PK_NF * (int)(sizeof(PkField) / 4);
    for (int i = threadIdx.x; i < nw; i += blockDim.x) dst[i] = src[i];
    for (int i = threadIdx.x; i <= A.nblk; i += blockDim.x)
      sK0[i] = A.k0[i];
  }
  if (threadIdx.x == 0)
    sMisc[0] = A.spill ? (int)atomicAdd(reinterpret_cast<unsigned*>(
                                            A.state + PK_ST_TICKET), 1u)
                       : (int)blockIdx.x;
  __syncthreads();
  const int ticket = sMisc[0];
  const int n = ticket * warps + wid;
  const bool active = n < A.N;
  const int K = A.K, Mdev = A.Mdev, nblk = A.nblk;
  unsigned* sKey = reinterpret_cast<unsigned*>(
      pk_smem + pk_head_bytes(nblk, warps) +
      (size_t)wid * pk_warp_bytes(K, Mdev, A.spill));
  int* sSel = reinterpret_cast<int*>(sKey + K);
  int* sW = sSel + Mdev;           // [Mdev - 2, PK_WORDS] (spill)
  int nvalid = 0;
  if (active) {
    // --- the lane's keys (a thread's slots j = lane + 32 i, the loads of
    //     PK_BATCH of them issued together) and the count below INT_MAX
    int nfin = 0;
    for (int j0 = lane; j0 < K; j0 += 32 * PK_BATCH) {
      int sc[PK_BATCH], va[PK_BATCH];
      bool by_score[PK_BATCH];
#pragma unroll
      for (int u = 0; u < PK_BATCH; ++u) {
        const int j = j0 + 32 * u;
        sc[u] = va[u] = 0;
        by_score[u] = false;
        if (j < K) {
          int b = 0;
          while (b + 1 < nblk && j >= sK0[b + 1]) ++b;
          const PkField& fs = sTab[b * PK_NF + F_SCORE];
          const PkField& fv = sTab[b * PK_NF + F_VALID];
          sc[u] = pk_load(fs, n, j - sK0[b]);
          by_score[u] = fv.kind == PK_FROM_SCORE;
          if (!by_score[u]) va[u] = pk_load(fv, n, j - sK0[b]);
        }
      }
#pragma unroll
      for (int u = 0; u < PK_BATCH; ++u) {
        const int j = j0 + 32 * u;
        if (j < K) {
          const int valid = by_score[u] ? sc[u] > -(1 << 30) : va[u];
          const int key =
              valid > 0 ? (int)(0u - (unsigned)sc[u]) : INT_MAX;
          sKey[j] = (unsigned)key ^ 0x80000000u;
          nfin += key != INT_MAX;
        }
      }
    }
    nfin = h2_warp_sum(nfin);
    __syncwarp();
    // --- stable top-Mdev: the keys below INT_MAX by rounds of a warp
    //     minimum, then the slots of key INT_MAX in slot order ---
    if (A.do_select) {
      const int nr = min(nfin, Mdev);
      if (nr > 0) {
        unsigned long long mine = pk_least_above(sKey, K, lane, 0, true);
        for (int m = 0; m < nr; ++m) {
          const unsigned long long w = pk_warp_min64(mine);
          if (lane == 0) sSel[m] = (int)(unsigned)w;
          if (mine == w) mine = pk_least_above(sKey, K, lane, w, false);
        }
      }
      int r0 = nr;
      for (int base = 0; base < K && r0 < Mdev; base += 32) {
        const int j = base + lane;
        const bool top = j < K && sKey[j] == 0xFFFFFFFFu;  // INT_MAX
        const unsigned bal = __ballot_sync(H2_FULL_MASK, top);
        const int r = r0 + __popc(bal & ((1u << lane) - 1));
        if (top && r < Mdev) sSel[r] = j;
        r0 += __popc(bal);
      }
    } else {
      for (int m = lane; m < Mdev; m += 32) sSel[m] = m;
    }
    __syncwarp();
    // --- gather the selected slots' fields, the outputs ---
    const int Wd = A.spill ? 2 : Mdev;
    const size_t NW = (size_t)A.N * Wd;
    int bv = INT_MIN, bm = INT_MAX, bj = 0, bb = 0;
    for (int m = lane; m < Mdev; m += 32) {
      const int j = sSel[m];
      int b = 0;
      while (b + 1 < nblk && j >= sK0[b + 1]) ++b;
      const int jj = j - sK0[b];
      const PkField* T = sTab + b * PK_NF;
      int v[PK_NF];
#pragma unroll
      for (int f = 0; f < PK_NF; ++f)
        v[f] = (f == F_ALT || f == F_VALID) ? 0 : pk_load(T[f], n, jj);
      v[F_VALID] = T[F_VALID].kind == PK_FROM_SCORE
                       ? v[F_SCORE] > -(1 << 30)
                       : pk_load(T[F_VALID], n, jj);
      const int key = v[F_VALID] > 0 ? v[F_SCORE] : -(1 << 30);
      if (bm == INT_MAX || key > bv) {  // m ascends: the first maximum
        bv = key;
        bm = m;
        bj = jj;
        bb = b;
      }
      const int cs = v[F_SPLDIR] > 0 ? 3 + v[F_SPLDIR] : v[F_KIND];
      const int flags = v[F_VALID] | (v[F_POST] << 1) | (v[F_SELFGAP] << 2) |
                        (v[F_KNOWN] << 3) | (cs << 4);
      const int d1 = v[F_D1];
      const int dd = (int)((unsigned)v[F_D2] - (unsigned)d1);
      const int ev = A.has_event ? v[F_EVENT] : 0;
      if (m < Wd) {
        const int vals[PK_NFIELD_OUT] = {
            v[F_SCORE], d1, v[F_X], v[F_AB], v[F_NMM], v[F_NN],
            v[F_CLIPL], v[F_CLIPR], flags, A.spliced ? v[F_D2] : dd, ev};
        for (int f = 0; f < PK_NFIELD_OUT; ++f)
          A.dense[f * NW + (size_t)n * Wd + m] = vals[f];
      } else {
        const int sc16 = pk_clamp(v[F_SCORE], -32768, 32767);
        int* w = sW + (m - 2) * PK_WORDS;
        w[0] = d1;
        w[1] = (int)(((unsigned)sc16 & 0xFFFFu) |
                     (((unsigned)flags & 0x7Fu) << 16) |
                     ((unsigned)pk_clamp(v[F_AB], 0, 127) << 24));
        w[2] = (int)(((unsigned)pk_clamp(v[F_CLIPL], 0, 255) & 0xFFu) |
                     (((unsigned)pk_clamp(v[F_CLIPR], 0, 255) & 0xFFu) << 8) |
                     (((unsigned)pk_clamp(v[F_NMM], 0, 255) & 0xFFu) << 16) |
                     ((unsigned)pk_clamp(v[F_NN], 0, 127) << 24));
        w[3] = A.spliced
                   ? (int)((unsigned)pk_clamp(v[F_X], 0, 255) & 0xFFu)
                   : (int)(((unsigned)pk_clamp(v[F_X], 0, 255) & 0xFFu) |
                           (((unsigned)dd & 0xFFu) << 8));
        w[4] = v[F_D2];
        w[5] = ev;
        nvalid += flags & 1;
      }
    }
    __syncwarp();  // sW: the spill loop reads other lanes' slots
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int v2 = __shfl_xor_sync(H2_FULL_MASK, bv, o);
      const int m2 = __shfl_xor_sync(H2_FULL_MASK, bm, o);
      const int j2 = __shfl_xor_sync(H2_FULL_MASK, bj, o);
      const int b2 = __shfl_xor_sync(H2_FULL_MASK, bb, o);
      if (v2 > bv || (v2 == bv && m2 < bm)) {
        bv = v2;
        bm = m2;
        bj = j2;
        bb = b2;
      }
    }
    if (lane == 0) A.alt[n] = pk_load(sTab[bb * PK_NF + F_ALT], n, bj);
    nvalid = h2_warp_sum(nvalid);
  }
  if (!A.spill) return;  // uniform per launch
  // --- the spill layout: the block's offset by decoupled look-back ---
  if (lane == 0) sCnt[wid] = active ? nvalid : 0;
  __syncthreads();
  unsigned long long* st = A.state + PK_ST_BLOCKS;
  const int G = (A.N + warps - 1) / warps;
  if (wid == 0) {
    int agg = 0;
    for (int w = 0; w < warps; ++w) agg += sCnt[w];
    int excl = 0;
    if (ticket == 0) {
      if (lane == 0) atomicExch(st, (2ull << 32) | (unsigned)agg);
    } else {
      if (lane == 0) atomicExch(st + ticket, (1ull << 32) | (unsigned)agg);
      for (int base = ticket - 1;; base -= 32) {
        const int p = base - lane;
        unsigned long long s = 2ull << 32;  // before block 0: prefix 0
        if (p >= 0) {
          do {
            s = *reinterpret_cast<volatile unsigned long long*>(st + p);
          } while ((s >> 32) == 0);
        }
        const unsigned inc = __ballot_sync(H2_FULL_MASK, (s >> 32) == 2);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        excl += h2_warp_sum(lane <= stop ? (int)(unsigned)s : 0);
        if (inc) break;
      }
      if (lane == 0)
        atomicExch(st + ticket, (2ull << 32) | (unsigned)(excl + agg));
    }
    if (lane == 0) {
      sMisc[1] = excl;
      sMisc[2] = excl + agg;
    }
  }
  __syncthreads();
  const int S = A.N;
  const int nwd = A.spliced ? 5 : 4;
  if (active) {
    int r = sMisc[1];
    for (int w = 0; w < wid; ++w) r += sCnt[w];
    for (int mb = 2; mb < Mdev; mb += 32) {
      const int m = mb + lane;
      const int* w = sW + (m - 2) * PK_WORDS;
      const bool v = m < Mdev && ((w[1] >> 16) & 1);
      const unsigned bal = __ballot_sync(H2_FULL_MASK, v);
      const int row = r + __popc(bal & ((1u << lane) - 1));
      if (v && row < S) {
        A.src[row] = n * (Mdev - 2) + (m - 2);
        for (int k = 0; k < nwd; ++k) A.sp_w[(size_t)row * nwd + k] = w[k];
        if (A.has_event) A.sp_ev[row] = w[5];
      }
      r += __popc(bal);
    }
    if (n == 0 && lane < PK_WORDS)  // flat slot 0: lane 0's slot 2
      reinterpret_cast<int*>(A.state + PK_ST_PAD)[lane] = sW[lane];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(reinterpret_cast<unsigned*>(A.state + PK_ST_DONE), 1u);
  }
  if (ticket != G - 1) return;
  // --- the last block: padding rows and the overflow mark ---
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile unsigned*>(A.state + PK_ST_DONE) <
           (unsigned)G) {
    }
    __threadfence();
  }
  __syncthreads();
  const int total = sMisc[2];
  int pad[PK_WORDS];  // read once: volatile reads in the row loop would
                      // each wait on the L2
#pragma unroll
  for (int k = 0; k < PK_WORDS; ++k)
    pad[k] = reinterpret_cast<const volatile int*>(A.state + PK_ST_PAD)[k];
  for (int row = total + threadIdx.x; row < S; row += blockDim.x) {
    A.src[row] = -1;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (k < nwd) A.sp_w[(size_t)row * nwd + k] = pad[k];
    if (A.has_event) A.sp_ev[row] = pad[5];
  }
  if (threadIdx.x == 0 && total > S) {
    A.src[S - 1] = -2;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (k < nwd) A.sp_w[(size_t)(S - 1) * nwd + k] = pad[k];
    if (A.has_event) A.sp_ev[S - 1] = pad[5];
  }
}

// lanes a block and the dynamic shared bytes (as many of PK_WARPS as the
// opt-in shared memory holds), the grid, and the scan state's bytes (at
// most 8 x (5 + N): the wrapper, ops/compact.py:pack_slots, allocates that)
static cudaError_t pk_config(int nblk, int N, int K, int Mdev, int spill,
                             int* warps, size_t* smem, int* grid,
                             size_t* state) {
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  int w = PK_WARPS;
  while (w > 1 && pk_head_bytes(nblk, w) + w * pk_warp_bytes(K, Mdev, spill) >
                      (size_t)cap)
    w >>= 1;
  *warps = w;
  *smem = pk_head_bytes(nblk, w) + w * pk_warp_bytes(K, Mdev, spill);
  if (*smem > (size_t)cap) return cudaErrorInvalidValue;
  *grid = (N + w - 1) / w;
  *state = spill ? (size_t)(PK_ST_BLOCKS + *grid) * 8 : 0;
  return cudaSuccess;
}

H2_EXPORT int h2_pack_slots(const void* tab, const void* k0, int nblk, int N,
                            int K, int Mdev, int do_select, int spill,
                            int has_event, int spliced, void* dense,
                            void* alt, void* src, void* sp_w, void* sp_ev,
                            void* scratch, long long scratch_bytes,
                            void* stream) {
  if (nblk < 1 || nblk > PK_MAXB || K < 1 || Mdev < 1 || Mdev > K ||
      (spill && Mdev <= 2) || (!do_select && Mdev != K))
    return (int)cudaErrorInvalidValue;
  PackArgs A;
  memcpy(A.tab, tab, (size_t)nblk * PK_NF * sizeof(PkField));
  memcpy(A.k0, k0, (size_t)(nblk + 1) * sizeof(int));
  if (A.k0[nblk] != K) return (int)cudaErrorInvalidValue;
  size_t smem = 0, state = 0;
  int grid = 0;
  cudaError_t e = pk_config(nblk, N, K, Mdev, spill, &A.warps, &smem, &grid,
                            &state);
  if (e != cudaSuccess) return (int)e;
  if (grid <= 0) return (int)cudaGetLastError();
  if ((size_t)scratch_bytes < state) return (int)cudaErrorInvalidValue;
  A.nblk = nblk;
  A.N = N;
  A.K = K;
  A.Mdev = Mdev;
  A.do_select = do_select;
  A.spill = spill;
  A.has_event = has_event;
  A.spliced = spliced;
  A.dense = (int*)dense;
  A.alt = (int*)alt;
  A.src = (int*)src;
  A.sp_w = (int*)sp_w;
  A.sp_ev = (int*)sp_ev;
  A.state = (unsigned long long*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  if (spill) {
    e = cudaMemsetAsync(scratch, 0, state, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pack_slots_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pack_slots_kernel<<<grid, 32 * A.warps, smem, st>>>(A);
  return (int)cudaGetLastError();
}
