// K18: fold up to 512 new splice sites into the sorted device tables.
//
// Replaces hisat2_tpu/align/splice_db.py:_merge_sorted_tabs (:40, with
// lob_add :72): the stable lexsort of old + new rows on (major, minor),
// truncated to capacity, for both table sets (donor-keyed and acceptor-
// keyed), and the bucket index's exclusive per-bin count of the new rows
// added onto lob.  Plain twin: hisat2_tpu_torch/ops/sites.py:
// merge_sorted_tabs_plain.
//
// One launch of independent blocks: no block waits on another, and no
// sort of the whole table runs.
//   table blocks (a set and a range of up to 2,048 old rows each): the
//     set's new rows are sorted by (key, row index) in shared memory, a
//     bitonic network over 512, so a row's sorted position is its rank
//     #{(key', idx') < (key, idx)}: JAX's stable order among equal keys.
//     An old row i goes to i + #{new keys < its key} (a lower-bound
//     search of the sorted keys); a new row goes to its rank + #{old keys
//     <= its key} (old rows win ties: the JAX concatenation order), and is
//     written by the block whose range holds that count (an upper-bound
//     search of the block's old keys, staged with the key before the
//     range).  Each block redoes the small sort rather than wait for one;
//   lob blocks (with the bucket index; a set and 4,096 entries each):
//     lob_out[b] = lob[b] + the weights of the new bins below b: those
//     below the range by a block sum, those inside it by a histogram in
//     shared memory and its exclusive scan, lob read and written with
//     16-byte loads and stores where aligned; the block that ends at NB
//     also writes lob_out[NB].
// Rows whose output index reaches the capacity are dropped, as the JAX
// slice drops them; the old table's sentinel tail and the padding rows
// fill it.  Keys compare as JAX's int32 lexsort: major, then minor, both
// signed.  The old tables must be sorted (device_tables builds them so).
//
// Bound: bytes: the 6 tables (cap ints each) and, with the bucket index,
// the 2 lob arrays (2^19 + 1 ints each) read and written once; the 8.4 MB
// of lob dominate.  The lob blocks stream them; the table blocks (one a set
// at the main path's capacity of 1,024) run beside them.
#include "common.cuh"

#define MS_CHUNK 512   // new rows a merge, and threads a block
#define MS_ROWS 2048   // old rows a table block
#define MS_BINS 4096   // lob entries a lob block

struct MergeArgs {
  const int* mj[2];  // old tables per set: major, minor, rd
  const int* mn[2];
  const int* rd[2];
  const int* nmj[2];  // new rows per set
  const int* nmn[2];
  const int* nrd;
  const int* lob[2];
  const int* bins[2];
  const int* wts;
  int cap, m, NB;       // NB < 0: no bucket index
  int tblocks, lblocks;  // blocks a set
  int* out;             // [6, cap]
  int* lob_out[2];      // [NB + 1] each
};

struct MsTableSmem {
  unsigned long long key[MS_CHUNK];
  int idx[MS_CHUNK];
  unsigned long long old[MS_ROWS + 1];  // the key before the range, then it
};

struct MsLobSmem {
  int h[MS_BINS];
  int warp[MS_CHUNK / 32];
};

union MsSmem {
  MsTableSmem t;
  MsLobSmem l;
};

// (major, minor) as an unsigned key in signed lexicographic order
__device__ __forceinline__ unsigned long long ms_key(int major, int minor) {
  return ((unsigned long long)((unsigned)major ^ 0x80000000u) << 32) |
         (unsigned long long)((unsigned)minor ^ 0x80000000u);
}

__device__ __forceinline__ int ms_major(unsigned long long k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int ms_minor(unsigned long long k) {
  return (int)((unsigned)k ^ 0x80000000u);
}

// Thread t's (key, idx) after an ascending sort of the block's MS_CHUNK
// pairs (a bitonic network: partners in the warp by shuffles, the 10
// stages across warps through shared memory sk, si).
__device__ __forceinline__ void ms_sort(unsigned long long& key, int& idx,
                                        unsigned long long* sk, int* si) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 2; k <= MS_CHUNK; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long ok;
      int oi;
      if (j >= 32) {
        sk[t] = key;
        si[t] = idx;
        __syncthreads();
        ok = sk[t ^ j];
        oi = si[t ^ j];
        __syncthreads();
      } else {
        ok = __shfl_xor_sync(H2_FULL_MASK, key, j);
        oi = __shfl_xor_sync(H2_FULL_MASK, idx, j);
      }
      const bool less = ok < key || (ok == key && oi < idx);
      if ((((t & j) == 0) == ((t & k) == 0)) == less) {
        key = ok;
        idx = oi;
      }
    }
  }
}

// #{v[0..n) < q} (strict) or #{v[0..n) <= q} of an ascending v, n <= 2^B,
// for R queries at once (branch-free, so the R searches interleave)
template <int B, int R, bool LE>
__device__ __forceinline__ void ms_rank(const unsigned long long* v, int n,
                                        const unsigned long long (&q)[R],
                                        int (&pos)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) pos[r] = 0;
#pragma unroll
  for (int step = 1 << B; step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int at = pos[r] + step;
      if (at <= n) {
        const unsigned long long x = v[at - 1];
        if (LE ? x <= q[r] : x < q[r]) pos[r] = at;
      }
    }
  }
}

#define MS_RPT (MS_ROWS / MS_CHUNK)  // old rows a thread

__device__ void ms_table(const MergeArgs& A, MsTableSmem& s, int set,
                         int blk) {
  const int t = threadIdx.x;
  const int i0 = blk * MS_ROWS, n = min(MS_ROWS, A.cap - i0);
  // every global load first: the new key, the old keys of the range and
  // the one before it, the old rows' rd
  unsigned long long key = ~0ull;
  int idx = t;
  if (t < A.m) key = ms_key(__ldg(A.nmj[set] + t), __ldg(A.nmn[set] + t));
  unsigned long long ok[MS_RPT + 1];
  int ord[MS_RPT];
#pragma unroll
  for (int h = 0; h <= MS_RPT; ++h) {
    const int k = t + MS_CHUNK * h, i = i0 - 1 + k;
    ok[h] = k <= n && i >= 0
                ? ms_key(__ldg(A.mj[set] + i), __ldg(A.mn[set] + i))
                : 0ull;
    if (h < MS_RPT)
      ord[h] = t + MS_CHUNK * h < n ? __ldg(A.rd[set] + i + 1) : 0;
  }
#pragma unroll
  for (int h = 0; h <= MS_RPT; ++h)
    if (t + MS_CHUNK * h <= n) s.old[t + MS_CHUNK * h] = ok[h];
  ms_sort(key, idx, s.key, s.idx);
  s.key[t] = key;
  s.idx[t] = idx;
  __syncthreads();
  int* o = A.out + (size_t)(3 * set) * A.cap;
  // old row i0 + k (k = t + MS_CHUNK h): i0 + k + #{new keys < its key}
  unsigned long long q[MS_RPT];
  int pos[MS_RPT];
#pragma unroll
  for (int h = 0; h < MS_RPT; ++h)
    q[h] = t + MS_CHUNK * h < n ? s.old[t + MS_CHUNK * h + 1] : 0ull;
  ms_rank<9, MS_RPT, false>(s.key, A.m, q, pos);
#pragma unroll
  for (int h = 0; h < MS_RPT; ++h) {
    const int k = t + MS_CHUNK * h, at = i0 + k + pos[h];
    if (k < n && at < A.cap) {
      o[at] = ms_major(q[h]);
      o[A.cap + at] = ms_minor(q[h]);
      o[2 * A.cap + at] = ord[h];
    }
  }
  // new row of sorted rank t: its rank + #{old keys <= its key}, written
  // by the block whose range holds that count (lo == n: a later block's,
  // or past the capacity)
  if (t < A.m && (blk == 0 || s.old[0] <= key)) {
    const unsigned long long qk[1] = {key};
    int lo[1];
    ms_rank<11, 1, true>(s.old + 1, n, qk, lo);
    const int at = i0 + lo[0] + t;
    if (lo[0] < n && at < A.cap) {
      o[at] = __ldg(A.nmj[set] + idx);
      o[A.cap + at] = __ldg(A.nmn[set] + idx);
      o[2 * A.cap + at] = __ldg(A.nrd + idx);
    }
  }
}

__device__ void ms_lob(const MergeArgs& A, MsLobSmem& s, int set, int blk) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = blk * MS_BINS, n = max(0, min(MS_BINS, A.NB - b0));
  const int e0 = 8 * t;
  const int* in = A.lob[set] + b0 + e0;
  int* out = A.lob_out[set] + b0 + e0;
  const bool vec = e0 + 8 <= n &&
                   ((reinterpret_cast<size_t>(in) |
                     reinterpret_cast<size_t>(out)) & 15) == 0;
  // every global load first: the new row's bin and weight, this
  // thread's 8 lob entries
  int b = 0, w = 0;
  if (t < A.m) {
    b = __ldg(A.bins[set] + t);
    w = __ldg(A.wts + t);
  }
  int4 x0 = make_int4(0, 0, 0, 0), x1 = x0;
  if (vec) {
    x0 = __ldg(reinterpret_cast<const int4*>(in));
    x1 = __ldg(reinterpret_cast<const int4*>(in) + 1);
  }
  for (int k = t; k < MS_BINS; k += MS_CHUNK) s.h[k] = 0;
  __syncthreads();
  unsigned below = 0u;
  if (t < A.m) {
    if (b < b0)
      below = (unsigned)w;
    else if (b - b0 < n)
      atomicAdd(&s.h[b - b0], w);
  }
  below = (unsigned)h2_warp_sum((int)below);
  if (lane == 0) s.warp[warp] = (int)below;
  __syncthreads();
  below = 0u;
#pragma unroll
  for (int k = 0; k < MS_CHUNK / 32; ++k) below += (unsigned)s.warp[k];
  unsigned hv[8], sum = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    hv[e] = e0 + e < n ? (unsigned)s.h[e0 + e] : 0u;
    sum += hv[e];
  }
  const unsigned inc = (unsigned)h2_warp_incl_sum((int)sum, lane);
  __syncthreads();  // every thread has read s.warp
  if (lane == 31) s.warp[warp] = (int)inc;
  __syncthreads();
  unsigned run = below + inc - sum;
  for (int k = 0; k < warp; ++k) run += (unsigned)s.warp[k];
  if (b0 + n == A.NB && t == MS_CHUNK - 1)  // every new bin is below NB
    A.lob_out[set][A.NB] = (int)((unsigned)__ldg(A.lob[set] + A.NB) + run +
                                 sum);
  if (vec) {
    int v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = (int)((unsigned)v[e] + run);
      run += hv[e];
    }
    reinterpret_cast<int4*>(out)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(out)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e0 + e < n) out[e] = (int)((unsigned)__ldg(in + e) + run);
      run += hv[e];
    }
  }
}

__global__ void __launch_bounds__(MS_CHUNK) merge_sites_kernel(MergeArgs A) {
  __shared__ MsSmem s;
  int b = blockIdx.x;
  if (b < 2 * A.tblocks) {
    ms_table(A, s.t, b / A.tblocks, b % A.tblocks);
    return;
  }
  b -= 2 * A.tblocks;
  ms_lob(A, s.l, b / A.lblocks, b % A.lblocks);
}

// NB < 0: no bucket index (lob_*, bins_*, wts and lob_out_* unused).
H2_EXPORT int h2_merge_sites(
    const void* kd, const void* ka, const void* rd, const void* ka_s,
    const void* kd_s, const void* rd_a, const void* nkd, const void* nka,
    const void* nrd, const void* lob_kd, const void* lob_ka,
    const void* bins_kd, const void* bins_ka, const void* wts, int cap,
    int m, int NB, void* out, void* lob_out_kd, void* lob_out_ka,
    void* stream) {
  if (cap < 1 || m < 0 || m > MS_CHUNK) return (int)cudaErrorInvalidValue;
  MergeArgs A{{(const int*)kd, (const int*)ka_s},
              {(const int*)ka, (const int*)kd_s},
              {(const int*)rd, (const int*)rd_a},
              {(const int*)nkd, (const int*)nka},
              {(const int*)nka, (const int*)nkd},
              (const int*)nrd,
              {(const int*)lob_kd, (const int*)lob_ka},
              {(const int*)bins_kd, (const int*)bins_ka},
              (const int*)wts,
              cap,
              m,
              NB,
              (cap + MS_ROWS - 1) / MS_ROWS,
              NB < 0 ? 0 : NB < 1 ? 1 : (NB + MS_BINS - 1) / MS_BINS,
              (int*)out,
              {(int*)lob_out_kd, (int*)lob_out_ka}};
  const long long grid = 2LL * (A.tblocks + A.lblocks);
  merge_sites_kernel<<<(unsigned)grid, MS_CHUNK, 0, (cudaStream_t)stream>>>(
      A);
  return (int)cudaGetLastError();
}
