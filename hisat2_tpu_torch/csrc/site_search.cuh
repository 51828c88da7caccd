// Sorted splice-site table lookup (a device function shared by K15 and
// K16).
//
// Replaces hisat2_tpu/ops/splice.py:table_searchsorted (:192): the first
// row with tab[row] >= q (searchsorted side='left').  With a bucket index
// (lob [NB + 1]: lob[b] = first row with key >= b << shift), the query's
// bin bounds the span and SS_SB = 12 masked halving steps finish it, as
// the JAX version does; without one, a plain binary search over the whole
// padded table (2^31 - 2 sentinels) gives the same row.  Plain twin:
// hisat2_tpu_torch/ops/splice.py:table_searchsorted.
#pragma once

#include "common.cuh"

#define H2_SS_SB 12

struct H2Sites {
  const int* kd;      // donor-keyed table: kd sorted, ka, rdid beside it
  const int* ka;
  const int* rdid;
  const int* ka_s;    // acceptor-keyed table: ka sorted, kd, rdid beside it
  const int* kd_s;
  const int* rdid_a;
  const int* kd_lob;  // [NB + 1] bucket indexes (NB = 0: none)
  const int* ka_lob;
  int shift, S, NB;
};

__device__ __forceinline__ int h2_table_searchsorted(const int* tab, int S,
                                                     const int* lob, int NB,
                                                     int shift, int q) {
  if (NB <= 0) {
    int lo = 0, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(tab + mid) < q)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  }
  const int b = min(max(q >> shift, 0), NB - 1);  // arithmetic shift, as JAX
  int lo = __ldg(lob + b), hi = __ldg(lob + b + 1);
#pragma unroll
  for (int t = 0; t < H2_SS_SB; ++t) {
    const int mid = (lo + hi) >> 1;
    const int v = __ldg(tab + min(max(mid, 0), S - 1));
    const bool act = lo < hi;
    const bool go = v < q;
    if (act && go) lo = mid + 1;
    if (act && !go) hi = mid;
  }
  return lo;
}
