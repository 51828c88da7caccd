// K18: fold up to 512 new splice sites into the sorted device tables.
//
// Replaces hisat2_tpu/align/splice_db.py:_merge_sorted_tabs (:40, with
// lob_add :72): the stable lexsort of old + new rows on (major, minor),
// truncated to capacity, for both table sets (donor-keyed and acceptor-
// keyed), and the bucket index's exclusive per-bin count of the new rows
// added onto lob.  Plain twin: hisat2_tpu_torch/ops/sites.py:
// merge_sorted_tabs_plain.
//
// No sort of the whole table runs.  Three launches on the caller's stream:
//   1. one block: each set's new rows are sorted in shared memory by
//      (packed key, row index) with a bitonic network, and each goes to
//      its sorted rank plus the count of old rows with key <= its key
//      (old rows win ties: the JAX concatenation order); the weighted
//      bins (wts = 1 rows) are sorted the same way.  Sorted keys and bins
//      go to a small scratch array;
//   2. one thread per old row: its own index plus the count of new keys
//      strictly below its key (binary search over <= 512 values);
//   3. one thread per lob entry b: lob[b] plus the count of new bins < b
//      (binary search), which replaces the 2^19-bin histogram and cumsum.
// Rows whose output index reaches the capacity are dropped, as the JAX
// slice; the old table's sentinel tail and the padding rows fill it.
//
// Bound: bytes: the 6 tables (cap ints each) and 2 lob arrays
// (2^19 + 1 ints each) read and written once; the 4 MB of lob dominate.
#include "common.cuh"

#define MS_CHUNK 512

__device__ __forceinline__ long long ms_key(int major, int minor) {
  return ((long long)major << 32) | (long long)(unsigned)minor;
}

// ascending bitonic sort of MS_CHUNK (key, idx) pairs, one per thread
__device__ void ms_bitonic(long long* key, int* idx) {
  const int t = threadIdx.x;
  for (int k = 2; k <= MS_CHUNK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int p = t ^ j;
      if (p > t) {
        const bool up = (t & k) == 0;
        const long long a = key[t], b = key[p];
        const int ia = idx[t], ib = idx[p];
        const bool gt = a > b || (a == b && ia > ib);
        if (gt == up) {
          key[t] = b;
          key[p] = a;
          idx[t] = ib;
          idx[p] = ia;
        }
      }
      __syncthreads();
    }
  }
}

struct MergeArgs {
  const int* mj[2];    // old tables per set: major, minor, rd
  const int* mn[2];
  const int* rd[2];
  const int* nmj[2];   // new rows per set
  const int* nmn[2];
  const int* nrd;
  const int* lob[2];
  const int* bins[2];
  const int* wts;
  int cap, m, NB;
  int* out;            // [6, cap]
  int* lob_out;        // [2, NB + 1]
  long long* scratch;  // [4, MS_CHUNK]: sorted keys per set, sorted bins
};

// the count of old rows of `set` with key < q (strict) or <= q
__device__ __forceinline__ int ms_old_rank(const MergeArgs& A, int set,
                                           long long q, bool le) {
  int lo = 0, hi = A.cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long v = ms_key(__ldg(A.mj[set] + mid), __ldg(A.mn[set] + mid));
    if (v < q || (le && v == q))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void merge_new_kernel(MergeArgs A) {
  __shared__ long long sKey[MS_CHUNK];
  __shared__ int sIdx[MS_CHUNK];
  const int t = threadIdx.x;
  for (int set = 0; set < 2; ++set) {
    sKey[t] = t < A.m ? ms_key(A.nmj[set][t], A.nmn[set][t]) : LLONG_MAX;
    sIdx[t] = t;
    __syncthreads();
    ms_bitonic(sKey, sIdx);
    const long long key = sKey[t];
    A.scratch[set * MS_CHUNK + t] = key;
    if (t < A.m) {
      const int r = sIdx[t];
      const int pos = t + ms_old_rank(A, set, key, true);
      if (pos < A.cap) {
        A.out[(3 * set) * A.cap + pos] = A.nmj[set][r];
        A.out[(3 * set + 1) * A.cap + pos] = A.nmn[set][r];
        A.out[(3 * set + 2) * A.cap + pos] = A.nrd[r];
      }
    }
    __syncthreads();
    if (A.NB > 0) {
      sKey[t] = (t < A.m && A.wts[t] != 0) ? (long long)A.bins[set][t]
                                            : LLONG_MAX;
      sIdx[t] = t;
      __syncthreads();
      ms_bitonic(sKey, sIdx);
      A.scratch[(2 + set) * MS_CHUNK + t] = sKey[t];
      __syncthreads();
    }
  }
}

// the count of sorted scratch values below q
__device__ __forceinline__ int ms_new_rank(const long long* v, int n,
                                           long long q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void merge_old_kernel(MergeArgs A) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2LL * A.cap) return;
  const int set = (int)(k / A.cap), i = (int)(k - (long long)set * A.cap);
  const int mj = A.mj[set][i], mn = A.mn[set][i];
  const int pos =
      i + ms_new_rank(A.scratch + set * MS_CHUNK, A.m, ms_key(mj, mn));
  if (pos < A.cap) {
    A.out[(3 * set) * A.cap + pos] = mj;
    A.out[(3 * set + 1) * A.cap + pos] = mn;
    A.out[(3 * set + 2) * A.cap + pos] = A.rd[set][i];
  }
}

__global__ void merge_lob_kernel(MergeArgs A) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nb1 = A.NB + 1;
  if (k >= 2LL * nb1) return;
  const int set = (int)(k / nb1), b = (int)(k - (long long)set * nb1);
  A.lob_out[(size_t)set * nb1 + b] =
      A.lob[set][b] +
      ms_new_rank(A.scratch + (2 + set) * MS_CHUNK, A.m, (long long)b);
}

H2_EXPORT int h2_merge_sites(
    const void* kd, const void* ka, const void* rd, const void* ka_s,
    const void* kd_s, const void* rd_a, const void* nkd, const void* nka,
    const void* nrd, const void* lob_kd, const void* lob_ka,
    const void* bins_kd, const void* bins_ka, const void* wts, int cap,
    int m, int NB, void* out, void* lob_out, void* scratch, void* stream) {
  if (cap < 1 || m < 0 || m > MS_CHUNK) return (int)cudaErrorInvalidValue;
  MergeArgs A{{(const int*)kd, (const int*)ka_s},
              {(const int*)ka, (const int*)kd_s},
              {(const int*)rd, (const int*)rd_a},
              {(const int*)nkd, (const int*)nka},
              {(const int*)nka, (const int*)nkd},
              (const int*)nrd,
              {(const int*)lob_kd, (const int*)lob_ka},
              {(const int*)bins_kd, (const int*)bins_ka},
              (const int*)wts, cap, m, NB, (int*)out, (int*)lob_out,
              (long long*)scratch};
  cudaStream_t st = (cudaStream_t)stream;
  merge_new_kernel<<<1, MS_CHUNK, 0, st>>>(A);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  merge_old_kernel<<<(unsigned)((2LL * cap + threads - 1) / threads),
                     threads, 0, st>>>(A);
  e = cudaGetLastError();
  if (e != cudaSuccess || NB <= 0) return (int)e;
  merge_lob_kernel<<<(unsigned)((2LL * (NB + 1) + threads - 1) / threads),
                     threads, 0, st>>>(A);
  return (int)cudaGetLastError();
}
