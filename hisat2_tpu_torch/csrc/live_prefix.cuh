// Penalty sums along one diagonal by a warp (K11, device functions).
//
// They replace hisat2_tpu/ops/extend.py:live_pen_prefix (:124-222) for one
// live injected slot: the SNV-forgiving penalty plane of the read against
// the diagonal starting at `start` (pen_planes semantics: quality
// mismatch penalty, N penalty, out-of-text penalty; a mismatch that
// matches a catalog SNV allele of either plane is forgiven), reduced on
// the fly to sums over runs of columns.  Plain twin:
// hisat2_tpu_torch/ops/extend.py:live_pen_prefix_plain.
//
// The JAX version compacts the live columns with a stable argsort and
// walks them in chunks under a while_loop, a TPU device for skipping dead
// columns; on the card a kernel lists its live slots and a warp walks
// each (inject_indels, K10; inject_known, K16, splice.py:708), its 32
// lanes taking the columns 32 apart, the sums in uint32 so that they wrap
// as JAX's int32 does.  Positions are computed in 64 bits.
//
// The chars come from a functor at(col, &rc4, &v1, &v2): the packed
// reference / SNV planes for a fresh diagonal (H2WordChars), or the
// pre-gathered diagonal windows for a source diagonal (H2WindowChars).
#pragma once

#include "common.cuh"

#define H2_OOB_PEN 100000

__device__ __forceinline__ int h2_packed_char(const uint32_t* words,
                                              int n_words, long long n_text,
                                              long long pos) {
  if (pos < 0 || pos >= n_text) return 4;
  const long long wi = pos >> 4;
  if (wi >= n_words) return 4;
  return (int)((__ldg(words + wi) >> (2 * (pos & 15))) & 3u);
}

// chars of the diagonal `start` gathered from the packed planes
struct H2WordChars {
  const uint32_t* ref;
  const uint32_t* snv1;
  const uint32_t* snv2;
  int n_ref, n_snv;
  long long n_text, start;
  __device__ void operator()(int col, int& rc4, int& v1, int& v2) const {
    const long long pos = start + col;
    rc4 = h2_packed_char(ref, n_ref, n_text, pos);
    v1 = snv1 ? h2_packed_char(snv1, n_snv, n_text, pos) : 0;
    v2 = snv2 ? h2_packed_char(snv2, n_snv, n_text, pos) : 0;
  }
};

// chars read from diagonal windows (diag_chars output, margin m)
struct H2WindowChars {
  const int* ch;
  const int* s1;
  const int* s2;
  __device__ void operator()(int col, int& rc4, int& v1, int& v2) const {
    rc4 = ch[col];
    v1 = s1 ? s1[col] : 0;
    v2 = s2 ? s2[col] : 0;
  }
};

// One column of a penalty plane (pen_planes semantics: the quality
// mismatch penalty unless a catalog SNV allele forgives it, the N
// penalty, the out-of-text penalty): its penalty and whether it is a raw
// mismatch.
__device__ __forceinline__ void h2_col_pen(int r, int q, int rc4, int v1,
                                           int v2, bool vp, bool oob,
                                           const int* mm_pen, int n_pen,
                                           unsigned& pen, unsigned& mi) {
  const int rc = min(rc4, 3);
  v1 = min(v1, 3);
  v2 = min(v2, 3);
  const bool isn = vp && r >= 4;
  const bool mm_raw = vp && r < 4 && r != rc && !oob;
  const bool snp_ok = mm_raw && ((v1 != 0 && r == ((rc + v1) & 3)) ||
                                 (v2 != 0 && r == ((rc + v2) & 3)));
  pen = (unsigned)((mm_raw && !snp_ok ? mm_pen[min(q, 63)] : 0) +
                   (isn ? n_pen : 0) + (oob ? H2_OOB_PEN : 0));
  mi = mm_raw ? 1u : 0u;
}

// live_pen_prefix's scalars in uint32, which wrap as JAX's int32 sums do
// (about 21,475 out-of-text columns pass 2^31).
struct H2PenSums {
  unsigned tot_pen, tot_mm;
  unsigned pen_at[2], mm_at[2];
};

// live_pen_prefix's scalars by one warp: the 32 lanes of a warp, all
// calling it with the same arguments, take the columns c_lo + lane,
// c_lo + lane + 32, ... below c_hi, each keeps partial sums over its
// columns, and one __reduce_add_sync a scalar gives every lane the sums
// over [c_lo, c_hi): the plane total and the prefixes below p0 and p1.
// With c_lo = 0 and c_hi = L these are live_pen_prefix's scalars; a
// caller that needs a sum over one run of columns (the columns from a
// junction to the read's end) walks that run only.  A lane reads a
// packed reference word once a column, a warp-wide load of the 2-3
// words its 32 columns share.
template <class CharAt>
__device__ H2PenSums h2_warp_pen_prefix(const int* rd, const int* qs,
                                        int len, int c_lo, int c_hi,
                                        long long start, long long n_text,
                                        const int* mm_pen, int n_pen, int p0,
                                        int p1, CharAt at, int lane) {
  unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0;
  for (int col = c_lo + lane; col < c_hi; col += 32) {
    const long long pos = start + col;
    const bool vp = col < len;
    const bool oob = vp && (pos < 0 || pos >= n_text);
    int rc4, v1, v2;
    at(col, rc4, v1, v2);
    unsigned pen, mi;
    h2_col_pen(rd[col], qs[col], rc4, v1, v2, vp, oob, mm_pen, n_pen, pen,
               mi);
    s0 += pen;
    s1 += mi;
    if (col < p0) {
      s2 += pen;
      s3 += mi;
    }
    if (col < p1) {
      s4 += pen;
      s5 += mi;
    }
  }
  H2PenSums s;
  s.tot_pen = __reduce_add_sync(H2_FULL_MASK, s0);
  s.tot_mm = __reduce_add_sync(H2_FULL_MASK, s1);
  s.pen_at[0] = __reduce_add_sync(H2_FULL_MASK, s2);
  s.mm_at[0] = __reduce_add_sync(H2_FULL_MASK, s3);
  s.pen_at[1] = __reduce_add_sync(H2_FULL_MASK, s4);
  s.mm_at[1] = __reduce_add_sync(H2_FULL_MASK, s5);
  return s;
}

// This lane's share of the penalty over the run [c_lo, c_hi) of a
// diagonal: the columns c_lo + lane, c_lo + lane + 32, ...  A caller adds
// the shares of several runs and reduces them once over the warp
// (K10's score is two runs, one on each side of the junction).
template <class CharAt>
__device__ __forceinline__ unsigned h2_lane_pen_run(
    const int* rd, const int* qs, int len, int c_lo, int c_hi,
    long long start, long long n_text, const int* mm_pen, int n_pen,
    CharAt at, int lane) {
  unsigned s = 0;
  for (int col = c_lo + lane; col < c_hi; col += 32) {
    const long long pos = start + col;
    const bool vp = col < len;
    const bool oob = vp && (pos < 0 || pos >= n_text);
    int rc4, v1, v2;
    at(col, rc4, v1, v2);
    unsigned pen, mi;
    h2_col_pen(rd[col], qs[col], rc4, v1, v2, vp, oob, mm_pen, n_pen, pen,
               mi);
    s += pen;
  }
  return s;
}
