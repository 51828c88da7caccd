// Kernel 7: known ALT indel injection (K10, with K11 as the device
// function h2_live_pen_prefix of live_prefix.cuh).
//
// Replaces hisat2_tpu/ops/splice.py:inject_indels (:838-949) with
// ops/extend.py:live_pen_prefix (:124-222).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:inject_indels_plain.
//
// One thread per (lane, column): J = 2 * slots * C columns per lane, the
// left-keyed event slots first (column t*C + c: the t-th event at or after
// start + 1 in the position-sorted table), then the right-keyed ones (the
// same in the table sorted by position + length).  Each thread runs a
// left-sided binary search over the whole padded table (2^30 sentinels),
// takes the fresh diagonal, and only for a live column (an in-read event
// on a valid candidate) computes the three SNV-forgiving prefix scalars of
// the fresh diagonal from the packed reference and SNV planes, and the two
// source-diagonal prefixes plus its total from the candidate's windows
// (ch, snv1_w, snv2_w: the JAX version reads them off the cumsum of the
// penalty planes, which the port never writes to device memory).  Then
// the left/right scores, the insertion-allele check, the x bounds and the
// minsc gate.  Dead columns return after the search; their positions are
// never formed in signed arithmetic (sums wrap as unsigned, like JAX's
// int32), so no column can overflow.
//
// Bound: a ~log2(E) chain of 4 B table loads per column, then for live
// columns (a few % at catalog density) 2 * L serial column steps with
// three packed-word loads each; latency-bound and divergent, but small.
#include "live_prefix.cuh"

#define INJ_MAX_INS 16
#define INJ_BIG (1 << 30)

struct InjArgs {
  const uint32_t* ref_words;
  const uint32_t* snv1;
  const uint32_t* snv2;
  const int* reads;
  const int* quals;
  const int* lens;
  const int* starts;
  const uint8_t* valid;
  const int* ch;   // [N, C, W] windows of the source diagonals
  const int* s1w;
  const int* s2w;
  const int* ip;   // [E] event positions, sorted, 2^30-padded
  const int* ilen;
  const int* ins_chars;  // [E, INJ_MAX_INS]
  const int* rkey;       // [E] ip + ilen, sorted, 2^30-padded
  const int* r_ilen;
  const int* r_row;
  const int* mm_pen;
  const int* minsc;
  long long n_text;
  int n_ref, n_snv, N, C, L, W, margin, E, slots, n_pen;
  int* score;  // [N, J] each
  int* d1;
  int* d2;
  int* x;
  int* kind;
  int* event;
  int* src;
};

__device__ __forceinline__ int inj_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// first index i in [0, E) with tab[i] >= v, else E
__device__ __forceinline__ int inj_lower_bound(const int* tab, int E, int v) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tab + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void inject_indels_kernel(InjArgs A) {
  const int C = A.C, half = A.slots * C, J = 2 * half;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)A.N * J) return;
  const int n = (int)(k / J), j = (int)(k - (long long)n * J);
  const bool is_left = j < half;
  const int jj = is_left ? j : j - half;
  const int t = jj / C, c = jj - t * C;
  const int st = A.starts[(size_t)n * C + c];
  const bool valid = A.valid[(size_t)n * C + c] != 0;
  const int len = A.lens[n];
  const int key = inj_add(st, 1);
  const int* tab = is_left ? A.ip : A.rkey;
  const int lo = inj_lower_bound(tab, A.E, key);
  const int idx = min(lo + t, A.E - 1);
  const int tv = __ldg(tab + idx);
  const bool okd = lo + t < A.E && valid && tv >= key &&
                   tv <= inj_add(st, len - 1);
  const int xv = okd ? inj_add(tv, -st) : 1;
  const int elen = is_left ? __ldg(A.ilen + idx) : __ldg(A.r_ilen + idx);
  const int fresh = is_left ? inj_add(st, elen) : inj_add(st, -elen);
  const int ev = is_left ? idx : __ldg(A.r_row + idx);
  const int I = max(-elen, 0);
  bool ok = okd && xv >= 1 && xv + I <= len - 1;
  if (ok && elen <= 0) {  // insertion: the skipped read chars are the allele
    const int* rd = A.reads + (size_t)n * A.L;
    const int* al = A.ins_chars + (size_t)max(ev, 0) * INJ_MAX_INS;
    for (int q = 0; q < I && q < INJ_MAX_INS; ++q)
      if (rd[min(xv + q, A.L - 1)] != __ldg(al + q)) ok = false;
  }
  int sc = -INJ_BIG;
  if (ok) {
    const int L = A.L;
    const int xr = min(xv + I, L);
    const int* rd = A.reads + (size_t)n * L;
    const int* qs = A.quals + (size_t)n * L;
    const H2WordChars fw{A.ref_words, A.snv1, A.snv2, A.n_ref, A.n_snv,
                         A.n_text, (long long)fresh};
    const H2PenScalars f = h2_live_pen_prefix(
        rd, qs, len, L, (long long)fresh, A.n_text, A.mm_pen, A.n_pen, xv,
        xr, fw);
    const size_t wo = ((size_t)n * C + c) * A.W + A.margin;
    const H2WindowChars sw{A.ch + wo, A.s1w ? A.s1w + wo : nullptr,
                           A.s2w ? A.s2w + wo : nullptr};
    const H2PenScalars s = h2_live_pen_prefix(
        rd, qs, len, L, (long long)st, A.n_text, A.mm_pen, A.n_pen, xv, xr,
        sw);
    // the source total is P_snv at lens (the plane is 0 past the read)
    const int s_val = is_left ? -(s.pen_at[0] + (f.tot_pen - f.pen_at[1]))
                              : -(f.pen_at[0] + (s.tot_pen - s.pen_at[1]));
    ok = s_val >= A.minsc[n];
    if (ok) sc = s_val;
  }
  A.score[k] = sc;
  A.d1[k] = is_left ? st : fresh;
  A.d2[k] = is_left ? fresh : st;
  A.x[k] = xv;
  A.kind[k] = ok ? (elen > 0 ? 2 : 3) : 0;  // KIND_DEL, KIND_INS, NONE
  A.event[k] = ok ? ev : -1;
  A.src[k] = c;
}

H2_EXPORT int h2_inject_indels(
    const void* ref_words, const void* snv1, const void* snv2,
    const void* reads, const void* quals, const void* lens,
    const void* starts, const void* valid, const void* ch, const void* s1w,
    const void* s2w, const void* ip, const void* ilen, const void* ins_chars,
    const void* rkey, const void* r_ilen, const void* r_row,
    const void* mm_pen, const void* minsc, long long n_text, int n_ref,
    int n_snv, int N, int C, int L, int W, int margin, int E, int slots,
    int n_pen, void* score, void* d1, void* d2, void* x, void* kind,
    void* event, void* src, void* stream) {
  if (E < 1 || C < 1 || L < 1 || slots < 1 || W < L + 2 * margin)
    return (int)cudaErrorInvalidValue;
  InjArgs A{(const uint32_t*)ref_words, (const uint32_t*)snv1,
            (const uint32_t*)snv2, (const int*)reads, (const int*)quals,
            (const int*)lens, (const int*)starts, (const uint8_t*)valid,
            (const int*)ch, (const int*)s1w, (const int*)s2w,
            (const int*)ip, (const int*)ilen, (const int*)ins_chars,
            (const int*)rkey, (const int*)r_ilen, (const int*)r_row,
            (const int*)mm_pen, (const int*)minsc, n_text, n_ref, n_snv, N,
            C, L, W, margin, E, slots, n_pen, (int*)score, (int*)d1,
            (int*)d2, (int*)x, (int*)kind, (int*)event, (int*)src};
  const long long total = (long long)N * 2 * slots * C;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    inject_indels_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
