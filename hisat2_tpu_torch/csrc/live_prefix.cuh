// Penalty prefix scalars along one diagonal (K11, a device function).
//
// Replaces hisat2_tpu/ops/extend.py:live_pen_prefix (:124-222) for one
// live injection column: the SNV-forgiving penalty plane of the read
// against the diagonal starting at `start` (pen_planes semantics: quality
// mismatch penalty, N penalty, out-of-text penalty; a mismatch that
// matches a catalog SNV allele of either plane is forgiven), reduced on
// the fly to the plane total, the raw-mismatch total, and both prefixes
// (columns < p) at two read positions.  Plain twin:
// hisat2_tpu_torch/ops/extend.py:live_pen_prefix_plain.
//
// The JAX version compacts the live columns with a stable argsort and
// walks them in chunks under a while_loop, a TPU device for skipping dead
// columns; on the card the caller's dead threads simply never call this.
// Positions are computed in 64 bits, so no column can overflow.
//
// The chars come from a functor at(col, &rc4, &v1, &v2): the packed
// reference / SNV planes for a fresh diagonal (H2WordChars), or the
// pre-gathered diagonal windows for a source diagonal (H2WindowChars).
// inject_known (K16, splice.py:708) calls the same function.
#pragma once

#include "common.cuh"

#define H2_OOB_PEN 100000

struct H2PenScalars {
  int tot_pen, tot_mm;
  int pen_at[2], mm_at[2];
};

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

template <class CharAt>
__device__ H2PenScalars h2_live_pen_prefix(const int* rd, const int* qs,
                                           int len, int L, long long start,
                                           long long n_text,
                                           const int* mm_pen, int n_pen,
                                           int p0, int p1, CharAt at) {
  H2PenScalars s{0, 0, {0, 0}, {0, 0}};
  for (int col = 0; col < L; ++col) {
    const long long pos = start + col;
    const bool vp = col < len;
    const bool oob = vp && (pos < 0 || pos >= n_text);
    int rc4, v1, v2;
    at(col, rc4, v1, v2);
    const int rc = min(rc4, 3);
    v1 = min(v1, 3);
    v2 = min(v2, 3);
    const int r = rd[col];
    const bool isn = vp && r >= 4;
    const bool mm_raw = vp && r < 4 && r != rc && !oob;
    const bool snp_ok = mm_raw && ((v1 != 0 && r == ((rc + v1) & 3)) ||
                                   (v2 != 0 && r == ((rc + v2) & 3)));
    const bool mm = mm_raw && !snp_ok;
    const int pen = (mm ? mm_pen[min(qs[col], 63)] : 0) + (isn ? n_pen : 0) +
                    (oob ? H2_OOB_PEN : 0);
    const int mi = mm_raw ? 1 : 0;
    s.tot_pen += pen;
    s.tot_mm += mi;
    if (col < p0) {
      s.pen_at[0] += pen;
      s.mm_at[0] += mi;
    }
    if (col < p1) {
      s.pen_at[1] += pen;
      s.mm_at[1] += mi;
    }
  }
  return s;
}
