"""K16's decomposition (hisat2_tpu_torch/csrc/inject_known.cu), emulated in
torch on the CPU and held against hisat2_tpu's inject_known (splice.py:629).

The kernel probes once per (lane, candidate, side) and reads `slots`
consecutive table rows; then a warp walks each live slot, its 32 lanes
taking the columns 32 apart, and every gate reads a sum over one run of
columns: the source diagonal's penalty below x (less the inherited left
clip, and at x - 1 for the coverage gate) and the clip cost below the
clip on a donor-keyed slot, the fresh diagonal's penalty and raw
mismatches from x to the read's end; on an acceptor-keyed slot the fresh
diagonal below x (and x - 1), the source from x to the right clip, the
clip cost below it.  Each sum is the sum of 32 per-lane partial sums,
modulo 2^32.  `split_inject` below does exactly that, and must give JAX's
outputs bit for bit: on lanes with planted introns (sites from file and
temp sites, with and without the bucket index, with inherited clips, SNV
planes on one case); and, against the port's plain twin, on a 22,050 bp
lane whose source diagonal starts before the text, so that its penalty
sum passes 2^31 and wraps as JAX's int32 does.

Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.ops import extend as j_extend
from hisat2_tpu.ops import splice as j_splice
from hisat2_tpu_torch.ops import rank as rk
from hisat2_tpu_torch.ops import splice
from hisat2_tpu_torch.utils.intops import u32_to_tensor

M = 16
SENT = 2 ** 31 - 2
OOB_PEN = 100_000
U32 = (1 << 32) - 1
LANES = 32
CLIP_PEN = np.array([1 + min(q, 40) // 20 for q in range(64)], np.int32)
MM_PEN = np.array([2 + min(q, 40) * 4 // 40 for q in range(64)], np.int32)


def _pack(codes):
    n = len(codes)
    words = np.zeros((n + 15) // 16, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     codes.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    return np.concatenate([words, np.zeros((-len(words)) % 128, np.uint32)])


def _lane_sum(v, mask):
    """The kernel's reduction: lane l sums the columns l, l + 32, ... of
    its run (`mask`) modulo 2^32, then the 32 partial sums are added
    modulo 2^32.  v, mask: [K, L]; returns [K] int64 in [0, 2^32)."""
    K, L = v.shape
    pad = (-L) % LANES
    vv = torch.nn.functional.pad(torch.where(mask, v, 0), (0, pad))
    part = vv.reshape(K, -1, LANES).sum(1) & U32
    return part.sum(1) & U32


def _s32(u):
    """uint32 bits as int32."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u)


def _col_pen(r, q, rc4, v1, v2, vp, oob):
    """h2_col_pen: the penalty and raw mismatch of each column."""
    rc = rc4.clamp(max=3)
    v1, v2 = v1.clamp(max=3), v2.clamp(max=3)
    isn = vp & (r >= 4)
    mm_raw = vp & (r < 4) & (r != rc) & ~oob
    snp_ok = mm_raw & (((v1 != 0) & (r == ((rc + v1) & 3)))
                       | ((v2 != 0) & (r == ((rc + v2) & 3))))
    mmp = torch.from_numpy(MM_PEN).long()[q.clamp(max=63)]
    pen = (torch.where(mm_raw & ~snp_ok, mmp, 0) + isn.long()
           + oob.long() * OOB_PEN)
    return pen, mm_raw.long()


def split_inject(words, n_text, reads, quals, lens, rdids, starts, valid, ch,
                 tabs, minsc, slots, clip_l, clip_r, snv=None):
    """K16 as the kernel decomposes it.  snv: (packed SNV planes 1 and 2,
    their windows 1 and 2) on a graph index."""
    N, C = starts.shape
    L = reads.shape[1]
    J1 = C * slots
    # 1. the probes: one search per (lane, candidate, side), then `slots`
    # consecutive rows
    x, fresh, ok = splice.known_probes(starts, valid, lens, rdids, tabs,
                                       slots)
    J = x.shape[1]
    jj = torch.arange(J)
    donor = (jj < J1)[None, :].expand(N, J)
    src = (jj % C)[None, :].expand(N, J)
    st = starts.gather(1, src)
    d1 = torch.where(donor, st, fresh)
    d2 = torch.where(donor, fresh, st)
    w32 = u32_to_tensor(words, "cpu")

    def char(p):
        return rk.ref_chars_block(w32, n_text, p, 1)[..., 0]

    jl = d1 + x                      # int32 adds wrap, as JAX's
    jr = d2 + x - 1
    c0, c1, c2, c3 = char(jl), char(jl + 1), char(jr - 1), char(jr)
    dl = torch.where((c0 < 4) & (c1 < 4), c0 * 16 + c1, 255)
    ar = torch.where((c2 < 4) & (c3 < 4), c2 * 16 + c3, 255)
    spldir, _ = splice._classify(dl, ar)
    out = dict(score=torch.full((N, J), -(1 << 30), dtype=torch.int32),
               d1=d1, d2=d2, x=x, kind=torch.zeros((N, J), dtype=torch.int32),
               spldir=spldir.to(torch.int32),
               clip_l=torch.zeros((N, J), dtype=torch.int32),
               clip_r=torch.zeros((N, J), dtype=torch.int32))
    # 2. the walk of each live slot
    n_i, j_i = torch.nonzero(ok, as_tuple=True)
    if n_i.numel() == 0:
        return out
    K = n_i.numel()
    xs, fr, s_ = x[n_i, j_i].long(), fresh[n_i, j_i].long(), st[n_i, j_i]
    c_i, dn = src[n_i, j_i], donor[n_i, j_i]
    ln = lens[n_i].long()
    col = torch.arange(L)[None, :].expand(K, L)
    lim = ln.clamp(max=L)[:, None]
    rd, q = reads[n_i].long(), quals[n_i].long()
    # the source diagonal's chars from its window, the fresh one's from
    # the packed planes
    win = ch[n_i, c_i, M:M + L].long()
    pos_s = s_.long()[:, None] + col
    oob_s = (pos_s < 0) | (pos_s >= n_text)
    pos_f = fr[:, None] + col
    oob_f = (col < ln[:, None]) & ((pos_f < 0) | (pos_f >= n_text))
    rc_f = rk.ref_chars_block(w32, n_text, pos_f[:, :1].to(torch.int32),
                              L)[:, 0].long()
    zero = torch.zeros_like(win)
    if snv is None:
        sv1 = sv2 = fv1 = fv2 = zero
    else:
        (p1, p2, s1w, s2w) = snv
        sv1, sv2 = (w[n_i, c_i, M:M + L].long() for w in (s1w, s2w))
        fv1, fv2 = (rk.ref_chars_block(u32_to_tensor(p, "cpu"), n_text,
                                       pos_f[:, :1].to(torch.int32), L)[
                                           :, 0].long() for p in (p1, p2))
    pen_s, _ = _col_pen(rd, q, win, sv1, sv2, torch.ones_like(oob_s), oob_s)
    pen_f, mi_f = _col_pen(rd, q, rc_f, fv1, fv2, col < ln[:, None], oob_f)
    cc = torch.from_numpy(CLIP_PEN).long()[q.clamp(max=63)]
    X = xs[:, None]
    cl_src, cr_src = clip_l[n_i, c_i].long(), clip_r[n_i, c_i].long()
    cl_d = torch.where(cl_src < xs, cl_src, 0)
    cr_a = torch.where((ln - cr_src) > xs, cr_src, 0)
    hi_cr = ln - cr_a
    below_x = col < torch.minimum(X, lim)
    # donor-keyed: source below x, fresh from x to the read's end
    clipped = (cl_d >= 0)[:, None] & (col < cl_d[:, None])
    d_r0 = _lane_sum(pen_s, below_x & ~clipped)
    d_r1 = _lane_sum(pen_s, below_x & (col >= X - 1))
    d_r2 = _lane_sum(cc, below_x & clipped)
    beyond = (col >= X) & (col < lim)
    d_fp, d_fm = _lane_sum(pen_f, beyond), _lane_sum(mi_f, beyond)
    # acceptor-keyed: fresh below x (and x - 1), source from x to the
    # right clip (or minus the source below x where that clip lies past
    # L), the clip cost below the clip
    a_fp, a_fm = _lane_sum(pen_f, below_x), _lane_sum(mi_f, below_x)
    a_fp1 = _lane_sum(pen_f, below_x & (col < (X - 1).clamp(min=0)))
    hi_in = hi_cr <= L
    a_r0 = torch.where(
        hi_in, _lane_sum(pen_s, (col >= X) & (col < torch.minimum(
            hi_cr[:, None], lim))), (-_lane_sum(pen_s, below_x)) & U32)
    a_r1 = torch.where((cr_a >= 0) & (cr_a <= L), _lane_sum(
        cc, col < torch.minimum(cr_a[:, None], lim)), 0)
    score = _s32(torch.where(dn, (-(d_r0 + d_r2 + d_fp)) & U32,
                             (-(a_fp + a_r0 + a_r1)) & U32))
    mm_new = torch.where(dn, d_fm, a_fm)
    lpad = _s32(torch.where(dn, d_r1, (a_fp - a_fp1) & U32))
    anchor = torch.where(dn, ln - xs, xs)
    o_cl = torch.where(dn, cl_d, 0)
    o_cr = torch.where(dn, 0, cr_a)
    D1, D2 = d1[n_i, j_i], d2[n_i, j_i]
    good = ((lpad == 0) & (xs >= 1) & (xs <= ln - 1) & (D2 > D1)
            & (mm_new <= torch.div(anchor, 4, rounding_mode="floor"))
            & (score >= minsc[n_i]) & (o_cl < xs) & (o_cr < ln - xs))
    out["score"][n_i, j_i] = torch.where(good, score, -(1 << 30)).to(
        torch.int32)
    out["kind"][n_i, j_i] = good.to(torch.int32)
    out["clip_l"][n_i, j_i] = torch.where(good, o_cl, 0).to(torch.int32)
    out["clip_r"][n_i, j_i] = torch.where(good, o_cr, 0).to(torch.int32)
    return out


def _tables(kd, ka, rdid, n, lob):
    """SpliceSiteDB.device_tables' layout of the sites (numpy)."""
    nn = len(kd)
    cap = 64
    while cap < nn + 1:
        cap *= 2
    o, o2 = np.lexsort((ka, kd)), np.lexsort((kd, ka))
    t = {}
    for nm, v, f in (("ss_kd", kd[o], SENT), ("ss_ka", ka[o], SENT),
                     ("ss_rdid", rdid[o], -1), ("ss_ka_s", ka[o2], SENT),
                     ("ss_kd_s", kd[o2], SENT), ("ss_rdid_a", rdid[o2], -1)):
        a = np.full(cap, f, np.int32)
        a[:nn] = v
        t[nm] = a
    if lob:
        shift = max(0, (n - 1).bit_length() - (1 << 19).bit_length() + 1)
        edges = np.arange((1 << 19) + 1, dtype=np.int64) << shift
        t["ss_kd_lob"] = np.searchsorted(t["ss_kd"][:nn], edges).astype(
            np.int32)
        t["ss_ka_lob"] = np.searchsorted(t["ss_ka_s"][:nn], edges).astype(
            np.int32)
        t["ss_shift"] = shift
    return t


def _world(seed, n, N, C, L, lob, snv):
    """N lanes of reads across planted GT-AG introns (a few with repeated
    keys and near-misses), their exon diagonals, decoys and a dead
    candidate, with inherited clips; sites from file and temp sites."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    introns = []
    s = 1000
    while s < n - 3000 and len(introns) < 40:
        ln = int(rng.choice([60, 300, 900, 2000]))
        g[s], g[s + 1], g[s + ln - 2], g[s + ln - 1] = 2, 3, 0, 2
        introns.append((s, ln))
        s += int(rng.integers(200, 400)) + ln // 4
    reads = np.full((N, L), 4, np.int32)
    starts = np.zeros((N, C), np.int32)
    valid = np.ones((N, C), bool)
    deltas = [np.where(rng.random(n) < 0.05, rng.integers(1, 4, n), 0)
              for _ in (0, 1)] if snv else None
    for i in range(N):
        d, D = introns[int(rng.integers(0, len(introns)))]
        x1 = int(rng.integers(3, L - 3))
        s0 = d - x1
        r = np.concatenate([g[s0:d], g[d + D:d + D + L - x1]]).astype(
            np.int32)
        if snv and i % 3 == 0:            # catalog alleles in the read
            for q in range(L):
                p = s0 + q if q < x1 else d + D + q - x1
                v = deltas[q % 2][p]
                if v:
                    r[q] = (g[p] + v) & 3
        for q in rng.choice(L, int(rng.integers(0, 3)), replace=False):
            r[q] = (r[q] + 1) % 4
        if i % 7 == 3:
            r[int(rng.integers(0, L))] = 4
        reads[i] = r
        row = [s0, s0 + D, s0 + int(rng.integers(-3, 4)),
               s0 + D + int(rng.integers(-2, 3)), int(rng.integers(0, n))]
        starts[i] = (row * C)[:C]
        valid[i, C - 1] = i % 4 != 0
    lens = np.full(N, L, np.int32)
    lens[::5] = L - 7
    for i in range(0, N, 5):
        reads[i, lens[i]:] = 4
    quals = rng.integers(5, 41, (N, L)).astype(np.int32)
    minsc = (-0.3 * lens).astype(np.int32)
    rdids = rng.integers(0, 3 * N, N).astype(np.int32)
    clip_l = np.where(rng.random((N, C)) < 0.3, rng.integers(1, 6, (N, C)),
                      0).astype(np.int32)
    clip_r = np.where(rng.random((N, C)) < 0.3, rng.integers(1, 6, (N, C)),
                      0).astype(np.int32)
    kd = np.array([d - 1 for d, _ in introns], np.int64)
    ka = np.array([d + D for d, D in introns], np.int64)
    # a repeated donor key with another acceptor, and temp sites
    kd = np.concatenate([kd, kd[:3]])
    ka = np.concatenate([ka, ka[:3] + 7])
    rdid = np.where(np.arange(len(kd)) % 2 == 0, -1,
                    rng.integers(0, 3 * N, len(kd)))
    return dict(g=g, n=n, words=_pack(g), reads=reads, quals=quals,
                lens=lens, starts=starts, valid=valid, minsc=minsc,
                rdids=rdids, clip_l=clip_l, clip_r=clip_r,
                tabs=_tables(kd, ka, rdid, n, lob),
                snv=None if deltas is None else [_pack(v) for v in deltas])


def _jax_and_split(w, slots=2):
    """JAX's inject_known and split_inject on one world."""
    n, L = w["n"], w["reads"].shape[1]
    N, C = w["starts"].shape
    mstart = np.where(w["valid"], w["starts"], -1).astype(np.int32)
    snv = w["snv"]
    z = jnp.zeros(1, jnp.uint32)
    sp = (z, z) if snv is None else tuple(jnp.asarray(p) for p in snv)

    @jax.jit
    def run(words, reads, quals, lens, mstart, starts, valid, rdids, ss,
            minsc, clip_l, clip_r, s1, s2):
        ch = j_splice.diag_chars(words, n, mstart, L, M)
        win = {} if snv is None else dict(
            snv_delta1=s1, snv_delta2=s2,
            snv1_win=j_splice.diag_chars(s1, n, mstart, L, M),
            snv2_win=j_splice.diag_chars(s2, n, mstart, L, M))
        pl = j_extend.pen_planes(words, n, reads, quals, lens, mstart,
                                 jnp.asarray(MM_PEN), 1, win_chars=ch,
                                 win_margin=M, **win)
        z3 = jnp.zeros((N, C, 1), jnp.int32)
        al3 = jnp.broadcast_to(lens[:, None, None], (N, C, 1))
        P = jnp.concatenate([z3, jnp.cumsum(pl.pen, axis=2)], axis=2)
        Pm = jnp.concatenate(
            [z3, jnp.cumsum(pl.mm_raw.astype(jnp.int32), axis=2)], axis=2)
        take = lambda A: jnp.take_along_axis(A, al3, axis=2)[:, :, 0]  # noqa
        out = j_splice.inject_known(
            words, n, reads, quals, lens, rdids, starts, valid, P, take(P),
            Pm, take(Pm), ss["ss_kd"], ss["ss_ka"], ss["ss_rdid"],
            ss["ss_ka_s"], ss["ss_kd_s"], ss["ss_rdid_a"],
            jnp.asarray(MM_PEN), 1, minsc, slots=slots, src_clip_l=clip_l,
            src_clip_r=clip_r, clip_pen=jnp.asarray(CLIP_PEN),
            snv_delta1=s1, snv_delta2=s2, kd_lob=ss.get("ss_kd_lob"),
            ka_lob=ss.get("ss_ka_lob"), ss_shift=ss.get("ss_shift"))
        return out, ch, win

    jt = {k: jnp.asarray(v) if k != "ss_shift" else jnp.int32(v)
          for k, v in w["tabs"].items()}
    want, ch, win = run(*(jnp.asarray(w[k]) for k in (
        "words", "reads", "quals", "lens")), jnp.asarray(mstart),
        *(jnp.asarray(w[k]) for k in ("starts", "valid", "rdids")), jt,
        *(jnp.asarray(w[k]) for k in ("minsc", "clip_l", "clip_r")), *sp)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa
    tabs = {k: t(v) if k != "ss_shift" else int(v)
            for k, v in w["tabs"].items()}
    got = split_inject(
        w["words"], n, *(t(w[k]) for k in ("reads", "quals", "lens",
                                            "rdids", "starts", "valid")),
        t(ch), tabs, t(w["minsc"]), slots, t(w["clip_l"]), t(w["clip_r"]),
        None if snv is None else (snv[0], snv[1], t(win["snv1_win"]),
                                  t(win["snv2_win"])))
    return want, got


def _same(want, got):
    for f in got:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]), err_msg=f)


@pytest.mark.parametrize("C,L,lob,snv", [(6, 80, True, False),
                                         (14, 37, False, True)])
def test_split_matches_jax(C, L, lob, snv):
    """The decomposition on planted-intron lanes: live and dead slots,
    repeated keys, temp sites, inherited clips, short reads."""
    w = _world(C * 100 + L, 60_000, 40, C, L, lob, snv)
    want, got = _jax_and_split(w)
    _same(want, got)
    live = np.asarray(want["score"]) > -2 ** 29
    assert live.sum() >= 5
    assert (np.asarray(want["clip_l"])[live] > 0).any() or \
        (np.asarray(want["clip_r"])[live] > 0).any()


def test_split_wraps_past_2_31():
    """A 22,050 bp lane whose candidate starts 21,700 bp before the text:
    the source diagonal's penalty below the site (100,000 a column out of
    the text) passes 2^31 and wraps in uint32 as JAX's int32 does, so the
    live slot scores a wrapped positive number and passes every gate.
    JAX's windows cost O(L^2) at this length (ops/rank.py:132, minutes on
    the CPU), so the lane is held against the port's plain twin, which the
    card's kernel is held against and which equals JAX at the shapes
    above and in test_torch_splice_sweep.py."""
    n, L = 30_000, 22_050
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, n).astype(np.uint8)
    st, x = -21_700, 21_800
    kd = np.array([st + x - 1, 500], np.int64)
    ka = np.array([1_000, 900], np.int64)
    N, C = 2, 2
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    reads[0, 21_700:x] = g[:100]           # in the text up to the site
    reads[0, x:22_000] = g[1_000:1_200]    # then the fresh exon
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa
    words = _pack(g)
    w32 = u32_to_tensor(words, "cpu")
    starts = t(np.array([[st, 200], [100, n - 30]], np.int32))
    valid = torch.ones((N, C), dtype=torch.bool)
    ch = splice.diag_chars_plain(w32, n, starts, L, M)
    tabs = {k: t(v) for k, v in _tables(kd, ka, np.array([-1, -1]), n,
                                          False).items()}
    args = dict(reads=t(reads),
                quals=t(rng.integers(5, 41, (N, L)).astype(np.int32)),
                lens=t(np.array([22_000, L], np.int32)),
                rdids=t(np.array([5, 9], np.int32)), starts=starts,
                valid=valid, ch=ch, tabs=tabs,
                minsc=t(np.full(N, -(2 ** 31), np.int32)), slots=1,
                clip_l=torch.zeros((N, C), dtype=torch.int32),
                clip_r=torch.zeros((N, C), dtype=torch.int32))
    want = splice.inject_known_ref(
        w32, n, args["reads"], args["quals"], args["lens"], args["rdids"],
        starts, valid, ch, M, tabs, t(MM_PEN), 1, args["minsc"], 1,
        args["clip_l"], args["clip_r"], t(CLIP_PEN))
    got = split_inject(words, n, **args)
    _same(want, got)
    assert int(want["x"][0, 0]) == x
    assert int(want["kind"][0, 0]) == 1
    assert int(want["score"][0, 0]) > 2 ** 30   # wrapped
