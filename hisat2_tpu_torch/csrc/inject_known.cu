// K16: known / temp splice-site injection.
//
// Replaces hisat2_tpu/ops/splice.py:inject_known (:629) with
// table_searchsorted (:192, site_search.cuh) and, for the fresh diagonal,
// ops/extend.py:live_pen_prefix (:124, live_prefix.cuh).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:inject_known_ref.
//
// One thread per (lane, injected slot), as kernel 7: J = 2 * slots * C
// slots per lane, the donor-keyed ones first (slot t*C + c: the t-th site
// whose donor lies in candidate c's read span), then the acceptor-keyed
// ones.  Each thread looks its site up in the sorted tables (bucket index
// when there is one), gates it by visibility (a temp site is seen only by
// later reads), forms the complementary diagonal and the junction class
// from four reference chars.  Only a live slot then walks the read twice:
// the fresh diagonal's penalty / mismatch prefixes from the packed
// reference (at x and x - 1 and in total), and the source diagonal's
// penalty prefixes at x, x - 1 and at its inherited clip bounds from the
// candidate's window, with the clip-cost prefix.  On a graph index both
// sides forgive catalog SNVs (pipeline.py:1117-1120 passes the
// SNV-forgiving planes as the source prefix; the fresh side goes through
// live_pen_prefix with the SNV deltas, splice.py:701-711): the source
// from its SNV-plane windows, the fresh diagonal from the packed SNV
// planes, both with live_prefix.cuh's rule.  The penalty planes never
// reach device memory.  Then the donor-coverage gate (always on), the
// bounds, the anchor-purity gate (mismatches <= anchor / 4), the minsc
// gate and the clip rule.  Positions wrap as unsigned int32, as JAX's.
//
// Bound: a ~log2(S) chain of table loads per slot, then 2 * L column steps
// for the live slots (a few per cent); latency-bound and divergent, small.
#include "live_prefix.cuh"
#include "site_search.cuh"

#define IK_BIG (1 << 30)

struct KnownArgs {
  const uint32_t* ref;
  const int* reads;
  const int* quals;
  const int* lens;
  const int* rdids;
  const int* starts;
  const uint8_t* valid;
  const int* ch;       // [N, C, W]
  const int* mm_pen;
  const int* clip_pen;
  const int* minsc;
  const int* clip_l;   // [N, C] the candidates' ungapped clips
  const int* clip_r;
  H2Sites st;
  const int* s1w;      // [N, C, W] SNV-plane windows (graph index only)
  const int* s2w;
  const uint32_t* snv1;  // packed SNV planes (graph index only)
  const uint32_t* snv2;
  long long n_text;
  int n_ref, n_snv, use_snv, N, C, L, W, M, slots, n_pen;
  int* out;            // [9, N, J]: score d1 d2 x kind spldir clip_l clip_r src
};

__device__ __forceinline__ int ik_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void inject_known_kernel(KnownArgs A) {
  const int C = A.C, J1 = A.slots * C, J = 2 * J1;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)A.N * J) return;
  const int n = (int)(k / J), j = (int)(k - (long long)n * J);
  const bool donor = j < J1;
  const int jj = donor ? j : j - J1;
  const int t = jj / C, c = jj - t * C;
  const int st = A.starts[(size_t)n * C + c];
  const bool valid = A.valid[(size_t)n * C + c] != 0;
  const int len = A.lens[n];
  const int rdid = A.rdids[n];
  const int S = A.st.S;
  int x, fresh;
  bool ok;
  if (donor) {
    const int lo = h2_table_searchsorted(A.st.kd, S, A.st.kd_lob, A.st.NB,
                                         A.st.shift, st);
    const int idx = min(lo + t, S - 1);
    const int kv = __ldg(A.st.kd + idx), srd = __ldg(A.st.rdid + idx);
    ok = lo + t < S && valid && kv >= st && kv <= ik_add(st, len - 2) &&
         (srd < 0 || srd < rdid);
    x = ok ? ik_add(ik_add(kv, -st), 1) : 1;
    fresh = ik_add(__ldg(A.st.ka + idx), -x);
  } else {
    const int q = ik_add(st, 1);
    const int lo = h2_table_searchsorted(A.st.ka_s, S, A.st.ka_lob, A.st.NB,
                                         A.st.shift, q);
    const int idx = min(lo + t, S - 1);
    const int kv = __ldg(A.st.ka_s + idx), srd = __ldg(A.st.rdid_a + idx);
    ok = lo + t < S && valid && kv >= q && kv <= ik_add(st, len - 1) &&
         (srd < 0 || srd < rdid);
    x = ok ? ik_add(kv, -st) : 1;
    fresh = ik_add(ik_add(__ldg(A.st.kd_s + idx), -x), 1);
  }
  const int d1 = donor ? st : fresh;
  const int d2 = donor ? fresh : st;
  // junction class from the site's flanking dinucleotides
  const int jl = ik_add(d1, x);
  const int jr = ik_add(ik_add(d2, x), -1);
  const int c0 = h2_packed_char(A.ref, A.n_ref, A.n_text, (long long)jl);
  const int c1 = h2_packed_char(A.ref, A.n_ref, A.n_text,
                                (long long)ik_add(jl, 1));
  const int c2 = h2_packed_char(A.ref, A.n_ref, A.n_text,
                                (long long)ik_add(jr, -1));
  const int c3 = h2_packed_char(A.ref, A.n_ref, A.n_text, (long long)jr);
  const int dl = (c0 < 4 && c1 < 4) ? c0 * 16 + c1 : 255;
  const int ar = (c2 < 4 && c3 < 4) ? c2 * 16 + c3 : 255;
  const bool cfw = dl == 0x23 && ar == 0x02;
  const bool crc = dl == 0x13 && ar == 0x01;
  const bool sfw = (dl == 0x21 && ar == 0x02) || (dl == 0x03 && ar == 0x01);
  const bool src_ = (dl == 0x13 && ar == 0x21) || (dl == 0x20 && ar == 0x03);
  const int spldir = cfw ? 1 : crc ? 2 : sfw ? 3 : src_ ? 4 : 0;
  int score = -IK_BIG, out_cl = 0, out_cr = 0;
  if (ok) {
    const int L = A.L;
    const int* rd = A.reads + (size_t)n * L;
    const int* qs = A.quals + (size_t)n * L;
    const int x_m1 = max(x - 1, 0);
    const bool snv = A.use_snv != 0;
    const H2WordChars fw{A.ref, snv ? A.snv1 : nullptr,
                         snv ? A.snv2 : nullptr, A.n_ref, A.n_snv, A.n_text,
                         (long long)fresh};
    const H2PenScalars f = h2_live_pen_prefix(
        rd, qs, len, L, (long long)fresh, A.n_text, A.mm_pen, A.n_pen, x,
        x_m1, fw);
    const int cl_src = A.clip_l[(size_t)n * C + c];
    const int cr_src = A.clip_r[(size_t)n * C + c];
    const int cl_d = cl_src < x ? cl_src : 0;
    const int cr_a = (len - cr_src) > x ? cr_src : 0;
    const int hi_cr = len - cr_a;
    // the source diagonal's (SNV-forgiving) penalty prefixes and the
    // clip-cost prefix
    const size_t wo = ((size_t)n * C + c) * A.W + A.M;
    const int* w = A.ch + wo;
    const int* v1w = snv ? A.s1w + wo : nullptr;
    const int* v2w = snv ? A.s2w + wo : nullptr;
    int ps_x = 0, ps_xm1 = 0, ps_cl = 0, ps_cr = 0, cc_cl = 0, cc_cr = 0;
    int ps = 0, cc = 0;
    for (int col = 0; col <= L; ++col) {
      if (col == x) ps_x = ps;
      if (col == x_m1) ps_xm1 = ps;
      if (col == cl_d) {
        ps_cl = ps;
        cc_cl = cc;
      }
      if (col == hi_cr) ps_cr = ps;
      if (col == cr_a) cc_cr = cc;
      if (col == L) break;
      const bool vp = col < len;
      const long long pos = (long long)st + col;
      const bool oob = vp && (pos < 0 || pos >= A.n_text);
      const int rc = min(w[col], 3);
      const int r = rd[col];
      const bool isn = vp && r >= 4;
      const bool mm_raw = vp && r < 4 && r != rc && !oob;
      bool snp_ok = false;
      if (snv && mm_raw) {
        const int v1 = min(v1w[col], 3), v2 = min(v2w[col], 3);
        snp_ok = (v1 != 0 && r == ((rc + v1) & 3)) ||
                 (v2 != 0 && r == ((rc + v2) & 3));
      }
      ps += (mm_raw && !snp_ok ? A.mm_pen[min(qs[col], 63)] : 0) +
            (isn ? A.n_pen : 0) + (oob ? H2_OOB_PEN : 0);
      cc += vp ? A.clip_pen[min(qs[col], 63)] : 0;
    }
    int mm_new, anchor_new, lpad;
    if (donor) {
      score = -((ps_x - ps_cl) + cc_cl + (f.tot_pen - f.pen_at[0]));
      mm_new = f.tot_mm - f.mm_at[0];
      anchor_new = len - x;
      lpad = ps_x - ps_xm1;
      out_cl = cl_d;
    } else {
      score = -(f.pen_at[0] + (ps_cr - ps_x) + cc_cr);
      mm_new = f.mm_at[0];
      anchor_new = x;
      lpad = f.pen_at[0] - f.pen_at[1];
      out_cr = cr_a;
    }
    ok = lpad == 0 && x >= 1 && x <= len - 1 && d2 > d1 &&
         mm_new <= h2_floordiv(anchor_new, 4) && score >= A.minsc[n] &&
         out_cl < x && out_cr < len - x;
  }
  const size_t NJ = (size_t)A.N * J;
  int* o = A.out + k;
  o[0] = ok ? score : -IK_BIG;
  o[NJ] = d1;
  o[2 * NJ] = d2;
  o[3 * NJ] = x;
  o[4 * NJ] = ok ? 1 : 0;   // KIND_SPL / KIND_NONE
  o[5 * NJ] = spldir;
  o[6 * NJ] = ok ? out_cl : 0;
  o[7 * NJ] = ok ? out_cr : 0;
  o[8 * NJ] = c;
}

H2_EXPORT int h2_inject_known(
    const void* ref, const void* reads, const void* quals, const void* lens,
    const void* rdids, const void* starts, const void* valid, const void* ch,
    const void* mm_pen, const void* clip_pen, const void* minsc,
    const void* clip_l, const void* clip_r, const void* kd, const void* ka,
    const void* rdid, const void* ka_s, const void* kd_s,
    const void* rdid_a, const void* kd_lob, const void* ka_lob, int shift,
    int S, int NB, const void* s1w, const void* s2w, const void* snv1,
    const void* snv2, long long n_text, int n_ref, int n_snv, int use_snv,
    int N, int C, int L, int W, int M, int slots, int n_pen, void* out,
    void* stream) {
  if (C < 1 || L < 1 || slots < 1 || S < 1 || W != L + 2 * M)
    return (int)cudaErrorInvalidValue;
  H2Sites st{(const int*)kd, (const int*)ka, (const int*)rdid,
             (const int*)ka_s, (const int*)kd_s, (const int*)rdid_a,
             (const int*)kd_lob, (const int*)ka_lob, shift, S, NB};
  KnownArgs A{(const uint32_t*)ref, (const int*)reads, (const int*)quals,
              (const int*)lens, (const int*)rdids, (const int*)starts,
              (const uint8_t*)valid, (const int*)ch, (const int*)mm_pen,
              (const int*)clip_pen, (const int*)minsc, (const int*)clip_l,
              (const int*)clip_r, st, (const int*)s1w, (const int*)s2w,
              (const uint32_t*)snv1, (const uint32_t*)snv2, n_text, n_ref,
              n_snv, use_snv, N, C, L, W, M, slots, n_pen, (int*)out};
  const long long total = (long long)N * 2 * slots * C;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    inject_known_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
