"""K10's decomposition (hisat2_tpu_torch/csrc/inject_indels.cu), emulated in
torch on the CPU and held against hisat2_tpu's inject_indels
(splice.py:838).

The kernel probes once per (lane, candidate, side): one lower-bound
search of the position-sorted (left-keyed) or end-sorted (right-keyed)
event table for start + 1, then `slots` consecutive rows, each giving a
slot's x, fresh diagonal and event, its bounds and, for an insertion, the
allele check.  Then a warp walks each live slot, its 32 lanes taking the
columns 32 apart, and the score is one sum over two runs of columns: on a
left-keyed slot the source diagonal's SNV-forgiving penalty below x (from
its windows) and the fresh diagonal's from x + I to the read's end (from
the packed planes); on a right-keyed slot the fresh diagonal below x and
the source from x + I.  The sum is the sum of 32 per-lane partial sums,
modulo 2^32.  `split_indels` below does exactly that, and must give JAX's
outputs bit for bit on graph lanes with deletions and insertions of up to
16 chars, at one and two slots a candidate; and, against the port's plain
twin, on a 22,050 bp lane whose fresh diagonal runs past the text's end,
so that its penalty sum passes 2^31 and wraps as JAX's int32 does.

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
MAX_INS = 16
OOB_PEN = 100_000
U32 = (1 << 32) - 1
LANES = 32
MM_PEN = np.array([2 + min(q, 40) * 4 // 40 for q in range(64)], np.int32)


def _pack(codes):
    n = len(codes)
    words = np.zeros((n + 15) // 16, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     codes.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    return np.concatenate([words, np.zeros((-len(words)) % 128, np.uint32)])


def _lane_sum(v, mask):
    """The kernel's reduction: lane l sums the columns l, l + 32, ... of
    its runs (`mask`) modulo 2^32, then the 32 partial sums are added
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
    """h2_col_pen: the penalty of each column (N penalty 1)."""
    rc = rc4.clamp(max=3)
    v1, v2 = v1.clamp(max=3), v2.clamp(max=3)
    isn = vp & (r >= 4)
    mm_raw = vp & (r < 4) & (r != rc) & ~oob
    snp_ok = mm_raw & (((v1 != 0) & (r == ((rc + v1) & 3)))
                       | ((v2 != 0) & (r == ((rc + v2) & 3))))
    mmp = torch.from_numpy(MM_PEN).long()[q.clamp(max=63)]
    return (torch.where(mm_raw & ~snp_ok, mmp, 0) + isn.long()
            + oob.long() * OOB_PEN)


def split_indels(planes, n_text, reads, quals, lens, starts, valid, wins,
                 tabs, minsc, slots):
    """K10 as the kernel decomposes it.  planes: the packed reference and
    SNV planes (u32 numpy); wins: the candidates' windows of the three
    (margin M); tabs: ip, ilen, ins_chars, rkey, r_ilen, r_row."""
    N, C = starts.shape
    L = reads.shape[1]
    J1 = C * slots
    # 1. the probes: one search per (lane, candidate, side), then `slots`
    # consecutive rows, their bounds and allele checks
    pr = splice.indel_probes(starts, valid, lens, reads, *tabs, slots)
    x, fresh, ok = pr["x"], pr["fresh"], pr["live"]
    J = x.shape[1]
    jj = torch.arange(J)
    left = (jj < J1)[None, :].expand(N, J)
    src = (jj % C)[None, :].expand(N, J)
    st = starts.gather(1, src)
    out = dict(score=torch.full((N, J), -(1 << 30), dtype=torch.int32),
               d1=torch.where(left, st, fresh),
               d2=torch.where(left, fresh, st), x=x,
               kind=torch.zeros((N, J), dtype=torch.int32),
               event=torch.full((N, J), -1, dtype=torch.int32),
               src=src.to(torch.int32).contiguous(),
               spldir=torch.zeros((N, J), dtype=torch.int32),
               splscore=torch.zeros((N, J), dtype=torch.float32))
    # 2. the walk of each live slot: one warp sum over two runs
    n_i, j_i = torch.nonzero(ok, as_tuple=True)
    if n_i.numel() == 0:
        return out
    K = n_i.numel()
    xs, fr, s_ = x[n_i, j_i].long(), fresh[n_i, j_i], st[n_i, j_i]
    c_i, lf = src[n_i, j_i], left[n_i, j_i]
    elen = pr["elen"][n_i, j_i].long()
    I = (-elen).clamp(min=0)
    xr = (xs + I).clamp(max=L)
    ln = lens[n_i].long()
    col = torch.arange(L)[None, :].expand(K, L)
    lim = ln.clamp(max=L)[:, None]
    rd, q = reads[n_i].long(), quals[n_i].long()
    # the source diagonal's chars from its windows, the fresh one's from
    # the packed planes
    sw = [w[n_i, c_i, M:M + L].long() for w in wins]
    pos_s = s_.long()[:, None] + col
    vp = col < ln[:, None]
    oob_s = vp & ((pos_s < 0) | (pos_s >= n_text))
    pos_f = fr.long()[:, None] + col
    oob_f = vp & ((pos_f < 0) | (pos_f >= n_text))
    fw = [rk.ref_chars_block(u32_to_tensor(p, "cpu"), n_text, fr[:, None],
                             L)[:, 0].long() for p in planes]
    pen_s = _col_pen(rd, q, *sw, vp, oob_s)
    pen_f = _col_pen(rd, q, *fw, vp, oob_f)
    below = col < torch.minimum(xs[:, None], lim)
    beyond = (col >= xr[:, None]) & (col < lim)
    # left-keyed: source below x, fresh from x + I; right-keyed: fresh
    # below x, source from x + I
    v = torch.where(lf[:, None], torch.where(below, pen_s, pen_f),
                    torch.where(below, pen_f, pen_s))
    score = _s32((-_lane_sum(v, below | beyond)) & U32)
    good = score >= minsc[n_i].long()
    out["score"][n_i, j_i] = torch.where(good, score, -(1 << 30)).to(
        torch.int32)
    out["kind"][n_i, j_i] = torch.where(
        good, torch.where(elen > 0, 2, 3), 0).to(torch.int32)
    out["event"][n_i, j_i] = torch.where(
        good, pr["event"][n_i, j_i], -1).to(torch.int32)
    return out


def _tables(events, max_ins=MAX_INS):
    """index/graph.py:indel_device_tables' layout of (pos, ilen, allele)
    events (numpy)."""
    ev = sorted(events, key=lambda e: e[0])
    n = len(ev)
    cap = 8
    while cap < n + 1:
        cap *= 2
    ip = np.full(cap, 2 ** 30, np.int32)
    il = np.zeros(cap, np.int32)
    ch = np.zeros((cap, max_ins), np.int32)
    for i, (p, ln, al) in enumerate(ev):
        ip[i], il[i] = p, ln
        ch[i, :len(al)] = al
    rkey = ip[:n].astype(np.int64) + il[:n]
    o2 = np.argsort(rkey, kind="stable")
    t_rkey = np.full(cap, 2 ** 30, np.int32)
    t_ril = np.zeros(cap, np.int32)
    t_rrow = np.zeros(cap, np.int32)
    t_rkey[:n], t_ril[:n], t_rrow[:n] = rkey[o2], il[:n][o2], o2
    return ip, il, ch, t_rkey, t_ril, t_rrow


def _world(seed, n, N, C, L):
    """N lanes of reads across catalog deletions (1-10 bp) and insertions
    (1-16 bp; one allele in three wrong in the read), some carrying SNV
    alleles, mismatches or an N, with the left and right diagonals of
    their event among decoys, a dead candidate and shortened reads."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    deltas = [np.where(rng.random(n) < 0.05, rng.integers(1, 4, n), 0)
              for _ in (0, 1)]
    events = []
    for p in np.sort(rng.choice(np.arange(300, n - 300), 60, replace=False)):
        if len(events) % 2:
            events.append((int(p), int(rng.integers(1, 11)), []))
        else:
            al = rng.integers(0, 4, int(rng.integers(1, MAX_INS + 1)))
            events.append((int(p), -len(al), list(al)))
    reads = np.full((N, L), 4, np.int32)
    starts = np.zeros((N, C), np.int32)
    valid = np.ones((N, C), bool)
    for i in range(N):
        p, ln, al = events[int(rng.integers(0, len(events)))]
        x = int(rng.integers(2, L - 20))
        s = p - x
        if ln > 0:
            r = np.concatenate([g[s:p], g[p + ln:p + ln + L]])
            right = s + ln
        else:
            al = np.asarray(al, np.uint8)
            if i % 3 == 2:
                al = (al + 1) % 4
            r = np.concatenate([g[s:p], al, g[p:p + L]])
            right = s + ln
        r = r[:L].astype(np.int32)
        if i % 3 == 0:                  # catalog SNV alleles in the read
            for k in range(L):
                v = deltas[k % 2][s + k]
                if v and k < x:
                    r[k] = (g[s + k] + v) & 3
        for k in rng.choice(L, int(rng.integers(0, 3)), replace=False):
            r[k] = (r[k] + 1) % 4
        if i % 7 == 3:
            r[int(rng.integers(0, L))] = 4
        reads[i] = r
        row = [s, right, s + int(rng.integers(-3, 4)),
               right + int(rng.integers(-2, 3)), int(rng.integers(0, n))]
        starts[i] = (row * C)[:C]
        valid[i, C - 1] = i % 4 != 0
    lens = np.full(N, L, np.int32)
    lens[::5] = L - 7
    for i in range(0, N, 5):
        reads[i, lens[i]:] = 4
    quals = rng.integers(5, 41, (N, L)).astype(np.int32)
    minsc = (-0.3 * lens).astype(np.int32)
    return dict(n=n, planes=[_pack(g)] + [_pack(d) for d in deltas],
                reads=reads, quals=quals, lens=lens, starts=starts,
                valid=valid, minsc=minsc, tabs=_tables(events))


def _jax_and_split(w, slots):
    """JAX's inject_indels and split_indels on one world."""
    n, L = w["n"], w["reads"].shape[1]
    N, C = w["starts"].shape
    mstart = np.where(w["valid"], w["starts"], -1).astype(np.int32)

    @jax.jit
    def run(words, s1, s2, reads, quals, lens, mstart, starts, valid,
            minsc, tabs):
        win = [j_splice.diag_chars(p, n, mstart, L, M)
               for p in (words, s1, s2)]
        pl = j_extend.pen_planes(
            words, n, reads, quals, lens, mstart, jnp.asarray(MM_PEN), 1,
            win_chars=win[0], win_margin=M, snv_delta1=s1, snv_delta2=s2,
            snv1_win=win[1], snv2_win=win[2])
        z3 = jnp.zeros((N, C, 1), jnp.int32)
        P = jnp.concatenate([z3, jnp.cumsum(pl.pen, axis=2)], axis=2)
        tot = jnp.take_along_axis(
            P, jnp.broadcast_to(lens[:, None, None], (N, C, 1)), axis=2)[
                :, :, 0]
        out = j_splice.inject_indels(
            words, n, reads, quals, lens, starts, valid, P, tot, *tabs,
            jnp.asarray(MM_PEN), 1, minsc, snv_delta1=s1, snv_delta2=s2,
            slots=slots)
        return out, win

    want, win = run(*(jnp.asarray(p) for p in w["planes"]),
                    *(jnp.asarray(w[k]) for k in ("reads", "quals", "lens")),
                    jnp.asarray(mstart),
                    *(jnp.asarray(w[k]) for k in ("starts", "valid",
                                                  "minsc")),
                    tuple(jnp.asarray(t) for t in w["tabs"]))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa
    got = split_indels(
        w["planes"], n, *(t(w[k]) for k in ("reads", "quals", "lens",
                                            "starts", "valid")),
        [t(x) for x in win], [t(x) for x in w["tabs"]], t(w["minsc"]),
        slots)
    return want, got


def _same(want, got):
    assert sorted(want) == sorted(got)
    for f in got:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]), err_msg=f)


@pytest.mark.parametrize("C,L,slots", [(5, 80, 2), (3, 37, 1)])
def test_split_matches_jax(C, L, slots):
    """The decomposition on catalog-indel lanes: live and dead slots,
    deletions and insertions (right and wrong alleles), SNV-forgiven
    mismatches, short reads."""
    w = _world(C * 100 + L, 40_000, 48, C, L)
    want, got = _jax_and_split(w, slots)
    _same(want, got)
    kind = np.asarray(want["kind"])
    assert (kind == 2).sum() >= 3 and (kind == 3).sum() >= 3


def test_split_wraps_past_2_31():
    """A 22,050 bp lane whose fresh diagonal leaves the text 500 bp after
    its start: its penalty from the deletion on (100,000 a column out of
    the text, over 21,550 columns) passes 2^31 and wraps in uint32 as
    JAX's int32 does, so the live slot scores a wrapped positive number
    and passes the minsc gate.  JAX's windows cost O(L^2) at this length
    (ops/rank.py:132), so the lane is held against the port's plain twin,
    which the card's kernel is held against and which equals JAX at the
    shapes above and in test_torch_graph.py."""
    n, L = 600, 22_050
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, n).astype(np.uint8)
    st, p, D = 100, 300, 5
    N, C = 2, 2
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    reads[0, :p - st] = g[st:p]                 # in the text up to the event
    reads[0, p - st:p - st + 200] = g[p + D:p + D + 200]
    planes = [_pack(g), _pack(np.zeros(n, np.uint8)),
              _pack(np.zeros(n, np.uint8))]
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa
    tabs = [t(a) for a in _tables([(p, D, []), (400, -3, [1, 2, 3])])]
    w32 = [u32_to_tensor(x, "cpu") for x in planes]
    starts = t(np.array([[st, 50], [100, n - 30]], np.int32))
    valid = torch.ones((N, C), dtype=torch.bool)
    wins = [splice.diag_chars_plain(x, n, starts, L, M) for x in w32]
    lens = t(np.array([L, L - 50], np.int32))
    quals = t(rng.integers(5, 41, (N, L)).astype(np.int32))
    minsc = t(np.full(N, -(2 ** 31), np.int32))
    want = splice.inject_indels_plain(
        w32[0], n, t(reads), quals, lens, starts, valid, *wins, M, *tabs,
        t(MM_PEN), 1, minsc, w32[1], w32[2], slots=1)
    got = split_indels(planes, n, t(reads), quals, lens, starts, valid,
                       wins, tabs, minsc, 1)
    _same(want, got)
    assert int(want["x"][0, 0]) == p - st
    assert int(want["kind"][0, 0]) == 2
    assert int(want["score"][0, 0]) > 2 ** 30   # wrapped
