"""Diagonal windows, the single-anchor indel sweep and known ALT indel
injection (counterpart of hisat2_tpu/ops/splice.py: constants,
SpliceParams, diag_chars :277, inject_indels :838 and self_indel_sweep
:952).

`diag_chars` launches kernel 2 (csrc/ref_window.cu) on CUDA tensors and
runs `diag_chars_plain` on CPU tensors; it serves the reference windows
and, on a graph index, the SNV-plane windows.  `self_indel_sweep`
launches kernel 4 (csrc/indel_sweep.cu, with the SNV windows) or runs
`self_indel_sweep_plain`; `inject_indels` launches kernel 7
(csrc/inject_indels.cu, with live_pen_prefix as a device function) or
runs `inject_indels_plain`.  The plain versions are line-by-line ports of
the JAX code.  The splice machinery (pair_sweep, select_pairs,
second_sweep, inject_known) belongs to the spliced slice (ROADMAP.md
Queue 2 K13-K18).

The splice-site PWM priors, `junction_prob_tables` and `probscore_host`
are numpy, copied from splice.py:42-107 for the host hybrid replay
(align/hybrid.py HybridAligner.probscore).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from . import compact as compact_ops
from . import rank as rk


# --- splice-site PWM priors -------------------------------------------------
# Published position-weight matrices used by the reference's probscore
# (splice_site.cpp:31-50; donor: Yeo & Burge 2004, acceptor: Solovyev,
# "Bioinformatics - From Genomes to Drugs" Vol I Ch 3).  Background base
# probabilities {A,C,G,T} = {.27,.23,.23,.27} (splice_site.h:66).
DONOR_LEN = 9            # 3 exonic + 6 intronic   (splice_site.h:49-51)
ACC_LEN = 15             # 14 intronic + 1 exonic  (splice_site.h:59-61)
ACC_LEN1 = ACC_LEN // 2  # table split halves      (splice_site.h:62-63)
ACC_LEN2 = ACC_LEN - ACC_LEN1

_DONOR_PROB = np.array([
    [0.340, 0.604, 0.092, 0.001, 0.001, 0.526, 0.713, 0.071, 0.160],
    [0.363, 0.129, 0.033, 0.001, 0.001, 0.028, 0.076, 0.055, 0.165],
    [0.183, 0.125, 0.803, 1.000, 0.001, 0.419, 0.118, 0.814, 0.209],
    [0.114, 0.142, 0.073, 0.001, 1.000, 0.025, 0.093, 0.059, 0.462],
], np.float64)
_ACC_PROB = np.array([
    [0.090, 0.084, 0.075, 0.068, 0.076, 0.080, 0.097, 0.092, 0.076, 0.078,
     0.237, 0.042, 1.000, 0.001, 0.239],
    [0.310, 0.310, 0.307, 0.293, 0.326, 0.330, 0.373, 0.385, 0.410, 0.352,
     0.309, 0.708, 0.001, 0.001, 0.138],
    [0.125, 0.115, 0.106, 0.104, 0.110, 0.113, 0.113, 0.085, 0.066, 0.064,
     0.212, 0.003, 0.001, 1.000, 0.520],
    [0.463, 0.440, 0.470, 0.494, 0.471, 0.463, 0.408, 0.429, 0.445, 0.504,
     0.240, 0.246, 0.001, 0.001, 0.104],
], np.float64)
_BACKGROUND = np.array([0.27, 0.23, 0.23, 0.27], np.float64)

SPL_UNKNOWN, SPL_FW, SPL_RC, SPL_SEMI_FW, SPL_SEMI_RC = 0, 1, 2, 3, 4
KIND_NONE, KIND_SPL, KIND_DEL, KIND_INS = 0, 1, 2, 3
_BIG = 2 ** 30


class SpliceParams(NamedTuple):
    """Static splice/gap policy (same fields and defaults as the JAX one)."""
    min_intron: int = 20
    max_intron: int = 500000
    pen_can: int = 0
    pen_noncan: int = 12
    lenpen_const: float = -8.0
    lenpen_coef: float = 1.0
    lenpen_nc_const: float = -8.0
    lenpen_nc_coef: float = 1.0
    min_anchor: int = 7
    min_anchor_noncan: int = 14
    rd_gap_open: int = 5
    rd_gap_ext: int = 3
    rf_gap_open: int = 5
    rf_gap_ext: int = 3
    max_gap: int = 10
    allow_spliced: bool = True


def junction_prob_tables():
    """Precompute the reference's summed PWM tables (init_junction_prob,
    splice_site.cpp:52-105): donor_sum[4^9], acc1[4^7], acc2[4^8], float32.
    probscore(d, a1, a2) = 1 / (1 + donor_sum[d]*acc1[a1]*acc2[a2])."""
    dlog = np.log(_DONOR_PROB / _BACKGROUND[:, None])     # [4, 9]
    alog = np.log(_ACC_PROB / _BACKGROUND[:, None])       # [4, 15]

    def summed(logp, ncols, col0):
        n = 1 << (2 * ncols)
        idx = np.arange(n, dtype=np.int64)
        s = np.zeros(n, np.float64)
        for j in range(ncols):
            base = (idx >> (2 * j)) & 3
            s += logp[base, col0 + ncols - j - 1]
        return np.exp(-s).astype(np.float32)

    donor_sum = summed(dlog, DONOR_LEN, 0)
    acc1 = summed(alog, ACC_LEN1, 0)
    acc2 = summed(alog, ACC_LEN2, ACC_LEN1)
    return donor_sum, acc1, acc2


def probscore_host(donor9: int, acc15: int, tables=None) -> float:
    """Host-side probscore for tests (splice_site.cpp:788-850, non-NEW
    model): sigmoid of the summed PWM log-odds."""
    if tables is None:
        tables = junction_prob_tables()
    d, a1t, a2t = tables
    a1 = acc15 >> (2 * ACC_LEN2)
    a2 = acc15 & ((1 << (2 * ACC_LEN2)) - 1)
    return float(1.0 / (1.0 + d[donor9] * a1t[a1] * a2t[a2]))


def diag_chars_plain(ref_words, n_text: int, starts, L: int, margin: int):
    """out[b, c, m] = ref[starts[b, c] + m - margin], 4 out of text."""
    return rk.ref_chars_block(ref_words, n_text, starts - margin,
                              L + 2 * margin)


def diag_chars(ref_words, n_text: int, starts, L: int, margin: int):
    """Kernel 2 on CUDA tensors, diag_chars_plain on CPU tensors."""
    if not starts.is_cuda:
        return diag_chars_plain(ref_words, n_text, starts, L, margin)
    i32 = torch.int32
    kernels.check_cuda("ref_words", ref_words, i32)
    kernels.check_cuda("starts", starts, i32)
    W = L + 2 * margin
    out = torch.empty(tuple(starts.shape) + (W,), dtype=i32,
                      device=starts.device)
    kernels.KERNELS["ref_window"].launch(
        ref_words.data_ptr(), ref_words.shape[0], n_text, starts.data_ptr(),
        starts.numel(), W, margin, out.data_ptr(),
        stream=kernels.stream_of(starts))
    return out


def _sweep_meta(G):
    """cid -> (o1, o2, kind) for the 4 combos of every g = 1..G, plus the
    'none' entry at index 4G (splice.py:1040-1083)."""
    o1, o2, kd = [], [], []
    for g in range(1, G + 1):
        o1 += [-g, 0, g, 0]
        o2 += [0, g, 0, -g]
        kd += [KIND_DEL, KIND_DEL, KIND_INS, KIND_INS]
    return o1 + [0], o2 + [0], kd + [0]


def self_indel_sweep_plain(ch, reads, quals, lens, starts, valid, minsc,
                           mm_pen, n_pen: int, prm: SpliceParams,
                           max_gap: int = None, snv1_w=None, snv2_w=None):
    """Plain torch twin of kernel 4 (splice.py:952 line by line).
    snv1_w / snv2_w: the SNV-plane windows of the same diagonals on a
    graph index (known SNVs are forgiven in the gap joins)."""
    i32 = torch.int32
    dev = ch.device
    N, C, W = ch.shape
    L = reads.shape[1]
    M = (W - L) // 2
    G = int(min(M, max_gap if max_gap else prm.max_gap))
    rd = reads[:, None, :]
    mmq = mm_pen[torch.clamp(quals, max=63).to(torch.int64)][:, None, :]
    ln = lens[:, None]
    colL = torch.arange(L, device=dev, dtype=i32)[None, None, :]
    vp = colL < ln[:, :, None]
    isn_pen = torch.where(vp & (rd >= 4), n_pen, 0)
    zero3 = torch.zeros((N, C, 1), dtype=i32, device=dev)

    def prefix(delta):
        chs = ch[:, :, M + delta:M + delta + L]
        mm = vp & (rd < 4) & (chs < 4) & (rd != chs)
        raw = torch.cat([zero3, torch.cumsum(mm.to(i32), 2).to(i32)], 2)
        if snv1_w is not None:
            v1 = snv1_w[:, :, M + delta:M + delta + L]
            v2 = snv2_w[:, :, M + delta:M + delta + L]
            mm = mm & ~(((v1 != 0) & (rd == ((chs + v1) & 3)))
                        | ((v2 != 0) & (rd == ((chs + v2) & 3))))
        pen = (torch.where(mm, mmq, 0) + isn_pen
               + torch.where(vp & (chs > 3), 100000, 0))
        return (torch.cat([zero3, torch.cumsum(pen, 2).to(i32)], 2), raw)

    def shifted(P, g, tot):
        tail = tot[:, :, None].expand(N, C, g)
        return torch.cat([P[:, :, g:], tail], dim=2)

    ln2b = ln.expand(N, C)
    P0, R0 = prefix(0)
    T0 = compact_ops.take_last(P0, ln2b)
    TR0 = compact_ops.take_last(R0, ln2b)
    xs = torch.arange(L + 1, device=dev, dtype=i32)[None, None, :]
    _PCAP = 1 << 19
    BIGP = 2 ** 31 - 1
    run_s = torch.full((N, C, L + 1), BIGP, dtype=torch.int64, device=dev)
    run_w = torch.full((N, C, L + 1), BIGP, dtype=torch.int64, device=dev)
    A = prm.min_anchor
    lnx = ln[:, :, None]
    cid = 0
    for g in range(1, G + 1):
        Pm, Rm = prefix(-g)
        Pp, Rp = prefix(+g)
        Tm = compact_ops.take_last(Pm, ln2b)
        Tp = compact_ops.take_last(Pp, ln2b)
        TRm = compact_ops.take_last(Rm, ln2b)
        TRp = compact_ops.take_last(Rp, ln2b)
        cdel = int(prm.rd_gap_open + prm.rd_gap_ext * g)
        cins = int(prm.rf_gap_open + prm.rf_gap_ext * g)
        okw_d = (xs >= 1) & (xs <= lnx - 1)
        okw_i = (xs >= 1) & (xs + g <= lnx - 1)
        oks_d = (xs >= A) & (xs <= lnx - A)
        oks_i = (xs >= A) & (xs + g <= lnx - A)
        combos = (
            (Pm + (T0[:, :, None] - P0) + cdel,
             Rm + (TR0[:, :, None] - R0), oks_d, okw_d),
            (P0 + (Tp[:, :, None] - Pp) + cdel,
             R0 + (TRp[:, :, None] - Rp), oks_d, okw_d),
            (Pp + (T0[:, :, None] - shifted(P0, g, T0)) + cins,
             Rp + (TR0[:, :, None] - shifted(R0, g, TR0)), oks_i, okw_i),
            (P0 + (Tm[:, :, None] - shifted(Pm, g, Tm)) + cins,
             R0 + (TRm[:, :, None] - shifted(Rm, g, TRm)), oks_i, okw_i),
        )
        for pen, raw, oks, okw in combos:
            packed = ((torch.clamp(pen.to(torch.int64), max=_PCAP - 1) * 64
                       + torch.clamp(raw.to(torch.int64), max=63)) * 64
                      + cid)
            run_s = torch.minimum(run_s, torch.where(oks, packed, BIGP))
            run_w = torch.minimum(run_w, torch.where(okw, packed, BIGP))
            cid += 1
    o1, o2, kd = _sweep_meta(G)
    o1_t = torch.tensor(o1, dtype=i32, device=dev)
    o2_t = torch.tensor(o2, dtype=i32, device=dev)
    kd_t = torch.tensor(kd, dtype=i32, device=dev)
    src = torch.arange(C, device=dev, dtype=i32)[None, :].expand(N, C)

    def pack(running, pfx=""):
        am = running.argmin(dim=2).to(i32)
        val = running.min(dim=2).values
        c = torch.clamp(val & 63, max=4 * G)
        score = -(val >> 12)
        ok = (valid & (score >= minsc[:, None])
              & (val < (_PCAP - 1) * 4096))
        c = torch.where(ok, c, 4 * G)
        return {pfx + "score": torch.where(ok, score, -_BIG).to(i32),
                pfx + "d1": starts + o1_t[c],
                pfx + "d2": starts + o2_t[c],
                pfx + "x": torch.where(ok, am, 0).to(i32),
                pfx + "kind": torch.where(ok, kd_t[c], KIND_NONE).to(i32),
                pfx + "spldir": torch.zeros((N, C), dtype=i32, device=dev),
                pfx + "splscore": torch.zeros((N, C), dtype=torch.float32,
                                              device=dev)}

    out = pack(run_s)
    out.update(pack(run_w, "w_"))
    out["src"] = src
    return out


def self_indel_sweep(ch, reads, quals, lens, starts, valid, minsc, mm_pen,
                     n_pen: int, prm: SpliceParams, max_gap: int = None,
                     snv1_w=None, snv2_w=None):
    """Kernel 4 on CUDA tensors, self_indel_sweep_plain on CPU tensors."""
    if not ch.is_cuda:
        return self_indel_sweep_plain(ch, reads, quals, lens, starts, valid,
                                      minsc, mm_pen, n_pen, prm, max_gap,
                                      snv1_w, snv2_w)
    i32 = torch.int32
    N, C, W = ch.shape
    L = reads.shape[1]
    M = (W - L) // 2
    G = int(min(M, max_gap if max_gap else prm.max_gap))
    for nm, t, shp in (("ch", ch, (N, C, W)), ("reads", reads, (N, L)),
                       ("quals", quals, (N, L)), ("lens", lens, (N,)),
                       ("starts", starts, (N, C)), ("minsc", minsc, (N,)),
                       ("mm_pen", mm_pen, (64,))):
        kernels.check_cuda(nm, t, i32, shp)
    kernels.check_cuda("valid", valid, torch.bool, (N, C))
    use_snv = snv1_w is not None
    if use_snv:
        kernels.check_cuda("snv1_w", snv1_w, i32, (N, C, W))
        kernels.check_cuda("snv2_w", snv2_w, i32, (N, C, W))
    if L > 1024:
        raise ValueError("indel_sweep: read length above 1024")
    dev = ch.device
    res = torch.empty((10, N, C), dtype=i32, device=dev)
    kernels.KERNELS["indel_sweep"].launch(
        ch.data_ptr(), reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), minsc.data_ptr(),
        mm_pen.data_ptr(), N * C, C, L, W, G, n_pen, prm.min_anchor,
        prm.rd_gap_open, prm.rd_gap_ext, prm.rf_gap_open, prm.rf_gap_ext,
        res.data_ptr(), (snv1_w if use_snv else ch).data_ptr(),
        (snv2_w if use_snv else ch).data_ptr(), int(use_snv),
        stream=kernels.stream_of(ch))
    zi = torch.zeros((N, C), dtype=i32, device=dev)
    zf = torch.zeros((N, C), dtype=torch.float32, device=dev)
    out = {}
    for w, pfx in ((0, ""), (1, "w_")):
        for f, k in enumerate(("score", "d1", "d2", "x", "kind")):
            out[pfx + k] = res[5 * w + f]
        out[pfx + "spldir"] = zi
        out[pfx + "splscore"] = zf
    out["src"] = torch.arange(C, device=dev, dtype=i32)[None, :].expand(N, C)
    return out


MAX_INS = 16     # longest known insertion handled by the injection kernel


def _searchsorted_left(tab, v):
    """jnp.searchsorted(tab, v) (side='left') for a sorted 1-D tab."""
    return torch.searchsorted(tab, v.contiguous(), right=False).to(
        torch.int32)


def inject_indels_plain(ref_words, n_text: int, reads, quals, lens, starts,
                        valid, ch, snv1_w, snv2_w, margin: int, ip, ilen,
                        ins_chars, rkey, r_ilen, r_row, mm_pen, n_pen: int,
                        minsc, snv_delta1, snv_delta2, slots: int = 2):
    """Plain torch twin of kernel 7: splice.py:838 inject_indels, line by
    line, after building the source diagonals' SNV-forgiving penalty
    prefixes P_snv [N, C, L+1] / tot_snv [N, C] from their windows, as
    pipeline.py:1143-1145 does from the pen_planes."""
    from . import extend as extend_ops
    i32 = torch.int32
    dev = reads.device
    N, C = starts.shape
    L = reads.shape[1]
    E = ip.shape[0]
    planes = extend_ops.pen_planes(
        n_text, reads, quals, lens, torch.where(valid, starts, -1), mm_pen,
        n_pen, ch, margin, snv1_w, snv2_w)
    zero3 = torch.zeros((N, C, 1), dtype=i32, device=dev)
    P_snv = torch.cat([zero3, torch.cumsum(planes.pen, 2).to(i32)], 2)
    tot_snv = compact_ops.take_last(P_snv, lens[:, None].expand(N, C))
    lens2 = lens[:, None]
    srcC = torch.arange(C, device=dev, dtype=i32)[None, :].expand(N, C)

    xs_, d2_, ok_, src_, ev_, ln_ = [], [], [], [], [], []
    # left-keyed: src diagonal is the LEFT side; x = ip - d
    lo = _searchsorted_left(ip, starts + 1)
    for t in range(slots):
        idx = torch.clamp(lo + t, max=E - 1).to(torch.int64)
        okd = ((lo + t < E) & valid & (ip[idx] >= starts + 1)
               & (ip[idx] <= starts + lens2 - 1))
        xs_.append(torch.where(okd, ip[idx] - starts, 1))
        d2_.append(starts + ilen[idx])
        ok_.append(okd)
        ev_.append(idx.to(i32))
        ln_.append(ilen[idx])
        src_.append(srcC)
    # right-keyed: src diagonal is the RIGHT side; x = (ip + ilen) - d
    lo2 = _searchsorted_left(rkey, starts + 1)
    for t in range(slots):
        idx = torch.clamp(lo2 + t, max=E - 1).to(torch.int64)
        okd = ((lo2 + t < E) & valid & (rkey[idx] >= starts + 1)
               & (rkey[idx] <= starts + lens2 - 1))
        xs_.append(torch.where(okd, rkey[idx] - starts, 1))
        d2_.append(starts - r_ilen[idx])   # = d1, the LEFT diagonal
        ok_.append(okd)
        ev_.append(r_row[idx])
        ln_.append(r_ilen[idx])
        src_.append(srcC)
    J1 = C * slots
    x_all = torch.cat(xs_, dim=1).to(i32)
    fresh = torch.cat(d2_, dim=1).to(i32)
    ok_all = torch.cat(ok_, dim=1)
    event = torch.cat(ev_, dim=1).to(i32)
    elen = torch.cat(ln_, dim=1).to(i32)      # +del / -ins
    src = torch.cat(src_, dim=1)
    J = x_all.shape[1]
    is_left = torch.arange(J, device=dev)[None, :] < J1
    I = torch.clamp(-elen, min=0)

    # prefix scalars of the fresh-diagonal planes over LIVE columns only
    # (left side uses the prefix at x, right side at x + inslen)
    xr = torch.clamp(x_all + I, max=L)
    tot_f, _, ppfx = extend_ops.live_pen_prefix_plain(
        ref_words, n_text, reads, quals, lens, mm_pen, n_pen,
        fresh, ok_all, [x_all, xr],
        snv_delta1=snv_delta1, snv_delta2=snv_delta2)
    (pf_x, _), (pf_xr, _) = ppfx
    src64 = src.to(torch.int64)
    P_src = P_snv.gather(1, src64[:, :, None].expand(N, J, P_snv.shape[2]))
    ps_x = P_src.gather(2, x_all[:, :, None].to(torch.int64))[:, :, 0]
    ps_xr = P_src.gather(2, xr[:, :, None].to(torch.int64))[:, :, 0]
    tot_src = tot_snv.gather(1, src64)
    src_start = starts.gather(1, src64)
    # left-keyed: left = src prefix at x, right = fresh suffix from x+I
    score_l = -(ps_x + (tot_f - pf_xr))
    # right-keyed: left = fresh prefix at x, right = src suffix from x+I
    score_r = -(pf_x + (tot_src - ps_xr))
    score = torch.where(is_left, score_l, score_r)
    d1 = torch.where(is_left, src_start, fresh)
    d2 = torch.where(is_left, fresh, src_start)

    # insertions: the skipped read bases must equal the variant allele
    ins_ok = torch.ones((N, J), dtype=torch.bool, device=dev)
    if E > 0:
        col = torch.arange(MAX_INS, device=dev, dtype=i32)[None, None, :]
        rpos = x_all[:, :, None] + col                   # [N, J, MAX_INS]
        rb = reads[:, None, :].expand(N, J, L).gather(
            2, torch.clamp(rpos, max=L - 1).to(torch.int64))
        ev_chars = ins_chars[torch.clamp(event, min=0).to(torch.int64)]
        need = col < I[:, :, None]
        ins_ok = torch.where(need, rb == ev_chars, True).all(dim=2)
        ins_ok = ins_ok | (elen > 0)

    ok_all = ok_all & (x_all >= 1) & (x_all + I <= lens2 - 1) & ins_ok
    ok_all = ok_all & (score >= minsc[:, None])
    score = torch.where(ok_all, score, -_BIG).to(i32)
    return dict(score=score, d1=d1.to(i32), d2=d2.to(i32), x=x_all,
                kind=torch.where(ok_all,
                                 torch.where(elen > 0, KIND_DEL, KIND_INS),
                                 KIND_NONE).to(i32),
                spldir=torch.zeros_like(score),
                splscore=torch.zeros(score.shape, dtype=torch.float32,
                                     device=dev),
                event=torch.where(ok_all, event, -1).to(i32),
                src=src.to(i32))


def inject_indels(ref_words, n_text: int, reads, quals, lens, starts, valid,
                  ch, snv1_w, snv2_w, margin: int, ip, ilen, ins_chars, rkey,
                  r_ilen, r_row, mm_pen, n_pen: int, minsc, snv_delta1,
                  snv_delta2, slots: int = 2):
    """Kernel 7 on CUDA tensors, inject_indels_plain on CPU tensors.
    starts/valid: the core candidates [N, C]; ch, snv1_w, snv2_w: their
    windows (diag_chars with margin); ip .. r_row: the padded indel event
    tables (index/format.py:graph_to_device)."""
    if not reads.is_cuda:
        return inject_indels_plain(
            ref_words, n_text, reads, quals, lens, starts, valid, ch, snv1_w,
            snv2_w, margin, ip, ilen, ins_chars, rkey, r_ilen, r_row, mm_pen,
            n_pen, minsc, snv_delta1, snv_delta2, slots)
    i32 = torch.int32
    N, L = reads.shape
    C = starts.shape[1]
    W = ch.shape[2]
    E = ip.shape[0]
    for nm, t, shp in (("ref_words", ref_words, None),
                       ("snv_delta1", snv_delta1, None),
                       ("snv_delta2", snv_delta2, None),
                       ("reads", reads, (N, L)), ("quals", quals, (N, L)),
                       ("lens", lens, (N,)), ("starts", starts, (N, C)),
                       ("ch", ch, (N, C, W)), ("snv1_w", snv1_w, (N, C, W)),
                       ("snv2_w", snv2_w, (N, C, W)), ("ip", ip, (E,)),
                       ("ilen", ilen, (E,)),
                       ("ins_chars", ins_chars, (E, MAX_INS)),
                       ("rkey", rkey, (E,)), ("r_ilen", r_ilen, (E,)),
                       ("r_row", r_row, (E,)), ("mm_pen", mm_pen, (64,)),
                       ("minsc", minsc, (N,))):
        kernels.check_cuda(nm, t, i32, shp)
    kernels.check_cuda("valid", valid, torch.bool, (N, C))
    if snv_delta1.shape != snv_delta2.shape or W < L + 2 * margin:
        raise ValueError("inject_indels: SNV planes differ in size or the "
                         "windows are narrower than L + 2*margin")
    J = 2 * slots * C
    res = torch.empty((7, N, J), dtype=i32, device=reads.device)
    kernels.KERNELS["inject_indels"].launch(
        ref_words.data_ptr(), snv_delta1.data_ptr(), snv_delta2.data_ptr(),
        reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), ch.data_ptr(),
        snv1_w.data_ptr(), snv2_w.data_ptr(), ip.data_ptr(), ilen.data_ptr(),
        ins_chars.data_ptr(), rkey.data_ptr(), r_ilen.data_ptr(),
        r_row.data_ptr(), mm_pen.data_ptr(), minsc.data_ptr(), n_text,
        ref_words.shape[0], snv_delta1.shape[0], N, C, L, W, margin, E,
        slots, n_pen, *(res[i].data_ptr() for i in range(7)),
        stream=kernels.stream_of(reads))
    out = dict(zip(("score", "d1", "d2", "x", "kind", "event", "src"),
                   res.unbind(0)))
    out["spldir"] = torch.zeros((N, J), dtype=i32, device=reads.device)
    out["splscore"] = torch.zeros((N, J), dtype=torch.float32,
                                  device=reads.device)
    return out
