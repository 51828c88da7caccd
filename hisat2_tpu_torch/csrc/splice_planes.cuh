// Per-diagonal junction planes of one lane in shared memory (shared by
// K13 pair_sweep.cu and K15 second_sweep.cu).
//
// Replaces what hisat2_tpu/ops/splice.py builds before its sweeps
// (pair_sweep :317-429, second_sweep :1125-1141): from each candidate's
// reference window (diag_chars, margin M) and the read, the penalty
// prefix P[x] (quality mismatch + N + out-of-text, ops/extend.py:72
// pen_planes' pen_raw: catalog SNVs are not forgiven), on a graph index
// the SNV-forgiving penalty prefix Pi[x] (pen_planes' pen, from the two
// SNV-plane windows: a mismatch whose read base is (ref + v) & 3 for a
// nonzero delta v = min(delta, 3) of either plane costs nothing, as
// extend.py:104-113; on a linear index Pi aliases P and takes no shared
// memory), the raw-mismatch prefix Pm[x], the penalized-column prefix
// Pr[x], the
// budget-scan bases (:389-419), the donor / acceptor dinucleotide codes
// and the four PWM products (_pwm_prod :222, t ascending, each product
// rounded once: __fmul_rn keeps nvcc from contracting anything).  Plain
// twins: ops/splice.py:_prefix, _codes, _pwm_planes and the base planes in
// _pair_sweep_lanes.  x runs over 0..L; past the read the prefixes hold
// their total.  The planes never touch device memory.
#pragma once

#include "live_prefix.cuh"

#define SP_MAX_L 512  // the qualifying-column bitmask's width

struct SpPlanes {
  int X1;        // L + 1 columns per diagonal
  int* P;        // [C][X1] penalty prefix (SNVs not forgiven)
  int* Pi;       // [C][X1] SNV-forgiving penalty prefix (P on a linear index)
  int* Pr;       // [C][X1] penalized-column prefix (budget planes only)
  int* Pm;       // [C][X1] raw-mismatch prefix
  int* bl;       // [C][X1] budget base, left (budget planes only)
  int* br;       // [C][X1] budget base, right
  uint8_t* dc;   // [C][X1] donor code d0*16+d1, 255 with an N
  uint8_t* ac;   // [C][X1] acceptor code
  float* dfw;    // [C][X1] PWM products
  float* drc;
  float* afw;
  float* arc;
};

__host__ __device__ inline size_t sp_smem_bytes(int C, int L, bool budget,
                                                bool snv = false) {
  const size_t X1 = (size_t)L + 1;
  return (size_t)C * X1 * (((budget ? 5 : 2) + (snv ? 1 : 0)) * 4 + 4 * 4 +
                           2) + 96 * 4 + 16;
}

// Carve the planes out of dynamic shared memory; returns the first free
// byte (4-aligned) and the PWM factor copy in *pwm_s.  snv: room for the
// SNV-forgiving prefix Pi (else Pi = P).
__device__ inline char* sp_carve(char* base, int C, int L, bool budget,
                                 SpPlanes& s, float** pwm_s,
                                 bool snv = false) {
  const int X1 = L + 1;
  const size_t n = (size_t)C * X1;
  s.X1 = X1;
  float* f = (float*)base;
  *pwm_s = f;
  f += 96;
  s.dfw = f;
  s.drc = f + n;
  s.afw = f + 2 * n;
  s.arc = f + 3 * n;
  int* p = (int*)(f + 4 * n);
  s.P = p;
  s.Pm = p + n;
  p += 2 * n;
  s.Pi = s.P;
  if (snv) {
    s.Pi = p;
    p += n;
  }
  if (budget) {
    s.Pr = p;
    s.bl = p + n;
    s.br = p + 2 * n;
    p += 3 * n;
  } else {
    s.Pr = s.bl = s.br = nullptr;
  }
  s.dc = (uint8_t*)p;
  s.ac = s.dc + n;
  return (char*)(((uintptr_t)(s.ac + n) + 15) & ~(uintptr_t)15);
}

__device__ __forceinline__ int sp_base(int c) { return c > 3 ? 0 : c; }

// PWM product over a rolling window (splice.py:_pwm_prod): factors
// f[b * ncol + col], window chars at w[off + t].
__device__ __forceinline__ float sp_pwm(const int* w, int off, int k,
                                        const float* f, int ncol, bool rc) {
  float acc = 1.0f;
  for (int t = 0; t < k; ++t) {
    int c = sp_base(w[off + t]);
    int col = t;
    if (rc) {
      c = 3 - c;
      col = k - 1 - t;
    }
    const float term = f[c * ncol + col];
    acc = t == 0 ? term : __fmul_rn(acc, term);
  }
  return acc;
}

// Build every plane of one lane's C diagonals, cooperatively over the
// block.  chl: the lane's windows [C][W]; starts/valid: its candidates
// (the windows and planes are of where(valid, start, -1), as the JAX step
// gathers them); s1l / s2l: the lane's SNV-plane windows [C][W] when
// s.Pi has its own room (nullptr on a linear index).  Ends with
// __syncthreads().
__device__ inline void sp_build(const SpPlanes& s, const float* pwm_s,
                         const int* __restrict__ chl,
                         const int* __restrict__ rd,
                         const int* __restrict__ qs, int len,
                         const int* __restrict__ starts,
                         const uint8_t* __restrict__ valid, long long n_text,
                         const int* __restrict__ mm_pen, int n_pen, int C,
                         int L, int W, int M,
                         const int* __restrict__ s1l = nullptr,
                         const int* __restrict__ s2l = nullptr) {
  const int X1 = L + 1;
  const float* fD = pwm_s;       // [4][9]
  const float* fA = pwm_s + 36;  // [4][15]
  // codes and PWM products, one (c, x) per thread
  for (int k = threadIdx.x; k < C * X1; k += blockDim.x) {
    const int c = k / X1, x = k - c * X1;
    const int* w = chl + (size_t)c * W;
    const int d0 = w[M + x], d1 = w[M + x + 1];
    const int a0 = w[M + x - 2], a1 = w[M + x - 1];
    s.dc[k] = (d0 < 4 && d1 < 4) ? (uint8_t)(d0 * 16 + d1) : 255;
    s.ac[k] = (a0 < 4 && a1 < 4) ? (uint8_t)(a0 * 16 + a1) : 255;
    s.dfw[k] = sp_pwm(w, M + x - 3, 9, fD, 9, false);
    s.drc[k] = sp_pwm(w, M + x - 6, 9, fD, 9, true);
    s.afw[k] = sp_pwm(w, M + x - 14, 15, fA, 15, false);
    s.arc[k] = sp_pwm(w, M + x - 1, 15, fA, 15, true);
  }
  // prefixes and budget bases, one diagonal per thread
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int* w = chl + (size_t)c * W + M;
    const long long st = valid[c] ? (long long)starts[c] : -1LL;
    int* P = s.P + (size_t)c * X1;
    int* Pm = s.Pm + (size_t)c * X1;
    int* Pr = s.Pr ? s.Pr + (size_t)c * X1 : nullptr;
    const bool snv = s1l != nullptr && s.Pi != s.P;
    int* Pf = snv ? s.Pi + (size_t)c * X1 : nullptr;
    const int* v1w = snv ? s1l + (size_t)c * W + M : nullptr;
    const int* v2w = snv ? s2l + (size_t)c * W + M : nullptr;
    int ps = 0, pm = 0, pr = 0, pf = 0;
    P[0] = 0;
    Pm[0] = 0;
    if (Pr) Pr[0] = 0;
    if (Pf) Pf[0] = 0;
    for (int col = 0; col < L; ++col) {
      const bool vp = col < len;
      const long long pos = st + col;
      const bool oob = vp && (pos < 0 || pos >= n_text);
      const int rc = min(w[col], 3);
      const int r = rd[col];
      const bool isn = vp && r >= 4;
      const bool mm_raw = vp && r < 4 && r != rc && !oob;
      const int mmq = mm_raw ? mm_pen[min(qs[col], 63)] : 0;
      const int base = (isn ? n_pen : 0) + (oob ? H2_OOB_PEN : 0);
      const int pen = mmq + base;
      ps += pen;
      pm += mm_raw ? 1 : 0;
      pr += pen > 0 ? 1 : 0;
      P[col + 1] = ps;
      Pm[col + 1] = pm;
      if (Pr) Pr[col + 1] = pr;
      if (Pf) {
        const int v1 = min(v1w[col], 3), v2 = min(v2w[col], 3);
        const bool snp_ok = mm_raw && ((v1 != 0 && r == ((rc + v1) & 3)) ||
                                       (v2 != 0 && r == ((rc + v2) & 3)));
        pf += (snp_ok ? 0 : mmq) + base;
        Pf[col + 1] = pf;
      }
    }
    if (!s.bl) continue;
    int* bl = s.bl + (size_t)c * X1;
    int* br = s.br + (size_t)c * X1;
    // next penalized column at or after col (L if none), kept in br
    int nxt = L;
    for (int col = L - 1; col >= 0; --col) {
      if (P[col + 1] - P[col] > 0) nxt = col;
      br[col] = nxt;
    }
    // the clean runs of >= 8 columns (minK_local) qualify; bl[x] is the
    // largest prefix at a qualifying column < x
    uint32_t qual[SP_MAX_L / 32] = {};
    int last = -1, m = 0;
    bl[0] = 0;
    for (int col = 0; col < L; ++col) {
      const bool mmc = P[col + 1] - P[col] > 0;
      if (mmc) last = col;
      const bool q = !mmc && (br[col] - (last + 1) >= 8);
      if (q) {
        qual[col >> 5] |= 1u << (col & 31);
        m = max(m, P[col]);
      }
      bl[col + 1] = m;
    }
    const int tot = P[L];
    m = 0;
    br[L] = 0;
    for (int col = L - 1; col >= 0; --col) {
      if ((qual[col >> 5] >> (col & 31)) & 1u) m = max(m, tot - P[col]);
      br[col] = m;
    }
  }
  __syncthreads();
}

// junction class of a (donor, acceptor) code pair (hi_aligner.h:1454-1458)
__device__ __forceinline__ int sp_classify(int dl, int ar, bool* canonical,
                                           bool* can_fw) {
  const bool cfw = dl == 0x23 && ar == 0x02;
  const bool crc = dl == 0x13 && ar == 0x01;
  const bool sfw = (dl == 0x21 && ar == 0x02) || (dl == 0x03 && ar == 0x01);
  const bool src = (dl == 0x13 && ar == 0x21) || (dl == 0x20 && ar == 0x03);
  *canonical = cfw || crc;
  *can_fw = cfw;
  return cfw ? 1 : crc ? 2 : sfw ? 3 : src ? 4 : 0;
}

__device__ __forceinline__ float sp_pth(int D) {
  return D >= (1 << 16) ? 0.99f : D >= (1 << 15) ? 0.97f
       : D >= (1 << 14) ? 0.94f : D >= (1 << 13) ? 0.91f
       : D >= (1 << 12) ? 0.88f : 0.8f;
}

__device__ __forceinline__ int sp_max_intron_len(int anchor, int min_anchor) {
  const int a = max(anchor, 2);
  const int sh = min(max((a << 1) - 4, 13), 30);
  return anchor >= min_anchor ? (1 << sh) : 0;
}

__device__ __forceinline__ int sp_max_intron_len_noncan(int anchor,
                                                        int min_anchor) {
  const int a = max(anchor, 5);
  const int sh = min((a << 1) - 10, 30);
  return anchor >= min_anchor ? (1 << sh) : 0;
}

// intronLen_prob (cut 14, add 4) / _noncan (cut 16, add 0); a shift
// outside [0, 32) gives 0, as XLA's
__device__ __forceinline__ float sp_intron_len_prob(int anchor, int D,
                                                    int max_intron, int cut,
                                                    int add) {
  const int sh = min((anchor << 1) + add, 30);
  const int p2 = sh >= 0 ? (1 << sh) : 0;
  int e = anchor < cut ? p2 : max_intron;
  e = min(e, max_intron);
  const float q = __fdiv_rn(__int2float_rn(D), __int2float_rn(e));
  return q > 1.0f ? 1.0f : q;  // NaN stays NaN, as jnp.minimum
}

// the intron-length penalty from its step table (ops/splice.py:
// lenpen_table): brk/val of n entries
__device__ __forceinline__ int sp_lenpen(const int* brk, const int* val,
                                         int n, int D) {
  int i = -1;
  for (int t = 0; t < n; ++t)
    if (brk[t] <= D) i = t;
  return val[max(i, 0)];
}
