"""Batched ungapped extension with closed-form soft clips (counterpart of
hisat2_tpu/ops/extend.py: PenPlanes, ExtendResult, pen_planes :72,
live_pen_prefix :124 and extend_grouped :225).

`extend_grouped` is the wrapper the pipeline calls: on CUDA tensors it
launches kernel 3 (csrc/extend_ungapped.cu), which fuses pen_planes, with
its SNV branch, into the extension (nothing else on the port's path
consumes the planes, so none goes to device memory); on CPU tensors it
runs `extend_grouped_plain`, which is `pen_planes` + `extend_from_planes`,
ports of the JAX code line by line.  `live_pen_prefix_plain` is the plain
twin of the device function in csrc/live_prefix.cuh that kernel 7
(inject_indels, ops/splice.py) calls per live column.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from . import compact as compact_ops
from . import rank as rk

_OOB_PEN = 100000  # out-of-text column: forces the optimizer to clip it
NO_ALT = -(2 ** 30)  # alt_score when no alternate representation exists


class ExtendResult(NamedTuple):
    score: torch.Tensor      # int32 [B, C]
    n_mm: torch.Tensor       # int32 [B, C]
    n_n: torch.Tensor        # int32 [B, C]
    n_snp: torch.Tensor      # int32 [B, C] (always 0 without SNV planes)
    clip_l: torch.Tensor     # int32 [B, C]
    clip_r: torch.Tensor     # int32 [B, C]
    ok: torch.Tensor         # bool  [B, C]
    alt_score: torch.Tensor  # int32 [B, C]


class PenPlanes(NamedTuple):
    pen: torch.Tensor       # int32 [B, C, L]
    pen_raw: torch.Tensor   # int32 [B, C, L]
    mm: torch.Tensor        # bool  [B, C, L]
    mm_raw: torch.Tensor    # bool  [B, C, L]
    isn: torch.Tensor       # bool  [B, C, L]
    snp_ok: torch.Tensor    # bool  [B, C, L]
    vp: torch.Tensor        # bool  [B, C, L]


def pen_planes(n_text: int, reads, quals, lens, cand_start, mm_pen,
               n_pen: int, win_chars, win_margin: int = 0, snv1_win=None,
               snv2_win=None) -> PenPlanes:
    """Per-column penalty planes from a candidate's reference window
    (extend.py:72).  win_chars (and, on a graph index, the SNV-plane
    windows snv1_win / snv2_win): diag_chars output [B, C, L + 2*margin]."""
    i32 = torch.int32
    L = reads.shape[1]
    rd = reads[:, None, :]
    q = torch.clamp(quals, max=63)[:, None, :].to(torch.int64)
    ln = lens[:, None]
    col = torch.arange(L, device=reads.device, dtype=i32)[None, None, :]
    pos = cand_start[:, :, None].to(torch.int64) + col
    vp = (col < ln[:, :, None]).expand(pos.shape)
    oob = vp & ((pos < 0) | (pos >= n_text))
    rc4 = win_chars[:, :, win_margin:win_margin + L]
    rc = torch.clamp(rc4, max=3)
    isn = vp & (rd >= 4)
    mm_raw = vp & (rd < 4) & (rd != rc) & ~oob
    if snv1_win is not None:
        v1 = torch.clamp(snv1_win[:, :, win_margin:win_margin + L], max=3)
        v2 = torch.clamp(snv2_win[:, :, win_margin:win_margin + L], max=3)
        snp_ok = mm_raw & (((v1 != 0) & (rd == ((rc + v1) & 3)))
                           | ((v2 != 0) & (rd == ((rc + v2) & 3))))
        mm = mm_raw & ~snp_ok
    else:
        snp_ok = torch.zeros_like(mm_raw)
        mm = mm_raw
    base = (torch.where(isn, n_pen, 0) + torch.where(oob, _OOB_PEN, 0))
    mmq = mm_pen[q]
    pen = (torch.where(mm, mmq, 0) + base).to(i32)
    pen_raw = (torch.where(mm_raw, mmq, 0) + base).to(i32)
    return PenPlanes(pen=pen, pen_raw=pen_raw, mm=mm, mm_raw=mm_raw,
                     isn=isn, snp_ok=snp_ok, vp=vp)


def live_pen_prefix_plain(ref_words, n_text: int, reads, quals, lens,
                          mm_pen, n_pen: int, fresh, live, pos_list,
                          snv_delta1=None, snv_delta2=None,
                          chunk: int = 4096):
    """extend.py:124 live_pen_prefix, line by line: penalty / raw-mismatch
    prefix scalars along the LIVE fresh diagonals [N, J] only, at each
    position of pos_list.  Returns (pen_total, mm_total, [(pen_at_p,
    mm_at_p), ...]), int32 [N, J], zeros on dead columns.  Both JAX paths
    are kept: dense when N*J <= chunk, else live columns compacted and
    walked `chunk` at a time (the results are the same)."""
    i32 = torch.int32
    dev = reads.device
    N, J = fresh.shape
    L = reads.shape[1]
    M = N * J
    nP = len(pos_list)
    S = 2 + 2 * nP
    fresh_f = fresh.reshape(-1)
    pos_f = [p.reshape(-1) for p in pos_list]

    def scalars(colids):
        colids = colids.to(torch.int64)
        lane = colids // J
        rd = reads[lane]
        q = torch.clamp(quals[lane], max=63).to(torch.int64)
        ln = lens[lane]
        st = fresh_f[colids]
        colL = torch.arange(L, device=dev, dtype=i32)[None, :]
        posg = st[:, None].to(torch.int64) + colL
        vp = colL < ln[:, None]
        oob = vp & ((posg < 0) | (posg >= n_text))
        rc4 = rk.ref_chars_block(ref_words, n_text, st[:, None], L)[:, 0]
        rc = torch.clamp(rc4, max=3)
        isn = vp & (rd >= 4)
        mm_raw = vp & (rd < 4) & (rd != rc) & ~oob
        if snv_delta1 is not None:
            v1 = torch.clamp(rk.ref_chars_block(
                snv_delta1, n_text, st[:, None], L)[:, 0], max=3)
            v2 = torch.clamp(rk.ref_chars_block(
                snv_delta2, n_text, st[:, None], L)[:, 0], max=3)
            snp_ok = mm_raw & (((v1 != 0) & (rd == ((rc + v1) & 3)))
                               | ((v2 != 0) & (rd == ((rc + v2) & 3))))
            mm = mm_raw & ~snp_ok
        else:
            mm = mm_raw
        pen = (torch.where(mm, mm_pen[q], 0)
               + torch.where(isn, n_pen, 0)
               + torch.where(oob, _OOB_PEN, 0)).to(i32)
        mint = mm_raw.to(i32)
        outs = [pen.sum(dim=1, dtype=i32), mint.sum(dim=1, dtype=i32)]
        for pf in pos_f:
            m = colL < pf[colids][:, None]
            outs.append(torch.where(m, pen, 0).sum(dim=1, dtype=i32))
            outs.append(torch.where(m, mint, 0).sum(dim=1, dtype=i32))
        return torch.stack(outs, dim=1)                       # [K, S]

    def unpack(rows):
        outs = [rows[:, i].reshape(N, J) for i in range(S)]
        return outs[0], outs[1], [(outs[2 + 2 * i], outs[3 + 2 * i])
                                  for i in range(nP)]

    lv = live.reshape(-1)
    if M <= chunk:
        vals = torch.where(lv[:, None], scalars(torch.arange(M, device=dev)),
                           0)
        return unpack(vals)
    lvi = lv.to(torch.int64)
    posc = torch.cumsum(lvi, 0) - lvi              # exclusive prefix sum
    total = int(posc[-1] + lvi[-1])
    src = torch.sort(1 - lvi, stable=True).indices
    nch = (M + chunk - 1) // chunk
    Mp = nch * chunk
    srcp = torch.zeros(Mp, dtype=torch.int64, device=dev)
    srcp[:M] = src
    buf = torch.zeros((Mp, S), dtype=i32, device=dev)
    k = 0
    while k * chunk < total:
        buf[k * chunk:(k + 1) * chunk] = scalars(
            srcp[k * chunk:(k + 1) * chunk])
        k += 1
    rows = buf[torch.clamp(posc, max=Mp - 1)]
    return unpack(torch.where(lv[:, None], rows, 0))


def _argmax_last(v):
    """Index of the LAST maximum along the last axis (argmax of the
    reversed axis, as extend.py does) and the maximum itself."""
    n = v.shape[-1]
    idx = (n - 1 - v.flip(-1).argmax(dim=-1)).to(torch.int32)
    return idx, v.max(dim=-1).values


def extend_from_planes(n_text: int, reads, quals, lens, cand_start,
                       mm_pen, clip_pen, n_pen: int,
                       allow_softclip: bool = True,
                       planes: PenPlanes = None,
                       uniform_len: bool = False,
                       minsc=None, mm_min: int = 1) -> ExtendResult:
    """extend.py:225 extend_grouped, line by line, on given planes."""
    i32 = torch.int32
    dev = reads.device
    B, L = reads.shape
    C = cand_start.shape[1]
    q = torch.clamp(quals, max=63)[:, None, :].to(torch.int64)
    ln = lens[:, None]
    col = torch.arange(L, device=dev, dtype=i32)[None, None, :]
    pen, mm, isn, snp_ok, vp = (planes.pen, planes.mm, planes.isn,
                                planes.snp_ok, planes.vp)
    total_pen = pen.sum(dim=-1, dtype=i32)
    lnc = ln.expand(B, C)
    if allow_softclip:
        ccost = torch.where(vp, clip_pen[q], 0).to(i32)
        zeros = torch.zeros((B, C, 1), dtype=i32, device=dev)
        P = torch.cat([zeros, torch.cumsum(pen, -1).to(i32)], dim=-1)
        Cc = torch.cat([zeros, torch.cumsum(ccost, -1).to(i32)], dim=-1)
        brange = torch.arange(L + 1, device=dev, dtype=i32)[None, None, :]
        in_read = brange <= lnc[:, :, None]
        pencol = (pen > 0) & vp
        colg = col
        lastpen = torch.cummax(torch.where(pencol, colg, -1), dim=2).values
        nextpen = torch.cummax(
            torch.where(pencol, L - 1 - colg, -1).flip(-1), dim=2
        ).values.flip(-1)
        nextpen = torch.where(nextpen >= 0, L - 1 - nextpen,
                              lnc[:, :, None]).to(i32)
        run_l = torch.cat([torch.minimum(nextpen, lnc[:, :, None]) - colg,
                           zeros], dim=-1)
        run_r = torch.cat([zeros, colg - lastpen], dim=-1)
        MINA = 7
        lgs = torch.where(in_read & ((brange == 0) | (run_l >= MINA)),
                          P - Cc, -1)
        clip_l, gl = _argmax_last(lgs)
        if uniform_len:
            p_at = P.flip(-1)
            r_at = run_r.flip(-1)
        else:
            bsel = torch.clamp(lnc[:, :, None] - brange, min=0)
            p_at = P.gather(-1, bsel.to(torch.int64))
            r_at = run_r.gather(-1, bsel.to(torch.int64))
        p_len = compact_ops.take_last(P, lnc)[:, :, None]
        rgs = torch.where(in_read & ((brange == 0) | (r_at >= MINA)),
                          p_len - p_at - Cc, -1)
        clip_r, gr = _argmax_last(rgs)
        gl = torch.clamp(gl, min=0)
        gr = torch.clamp(gr, min=0)
        clip_l = torch.where(gl > 0, clip_l, 0).to(i32)
        clip_r = torch.where(gr > 0, clip_r, 0).to(i32)
        score = -(total_pen - gl - gr)
        lgs_u = torch.where(in_read, P - Cc, -1)
        clip_lu, glu = _argmax_last(lgs_u)
        rgs_u = torch.where(in_read, p_len - p_at - Cc, -1)
        clip_ru, gru = _argmax_last(rgs_u)
        ok = (torch.where(glu > 0, clip_lu, 0)
              + torch.where(gru > 0, clip_ru, 0)) < lnc
        alt = torch.full((B, C), NO_ALT, dtype=i32, device=dev)
        if minsc is not None:
            T = torch.div(-minsc.to(torch.int64), max(mm_min, 1),
                          rounding_mode="floor")[:, None]
            TW = int(min(L, 64))
            aw = torch.arange(TW, device=dev)[None, None, :]
            pen_w = pencol[..., :TW]
            a_colw = torch.cat([torch.ones((B, C, 1), dtype=torch.bool,
                                           device=dev),
                                pen_w[..., :TW - 1]], dim=-1)
            a_okw = (a_colw & (run_l[..., :TW] >= MINA)
                     & (aw < lnc[:, :, None]))
            a1_w = torch.minimum(nextpen[..., :TW], lnc[:, :, None])
            Tl = T[:, :, None]
            cl_w = torch.where((aw > 0) & (aw <= Tl), aw, 0)
            crw_raw = lnc[:, :, None] - a1_w
            cr_w = torch.where((crw_raw > 0) & (crw_raw <= Tl - 1),
                               crw_raw, 0)
            maskL = (aw > 0) & (aw <= Tl)
            maskR = (crw_raw > 0) & (crw_raw <= Tl - 1)
            P_a = P[..., :TW]
            C_a = Cc[..., :TW]
            KCR = int(min(TW, 32))
            C_cr = torch.zeros_like(cr_w)
            for b in range(1, KCR):
                C_cr = torch.where(cr_w == b, Cc[..., b:b + 1], C_cr)
            maskR = maskR & (crw_raw < KCR)
            P_cl_e = torch.where(maskL, P_a, 0)
            C_cl_e = torch.where(maskL, C_a, 0)
            P_hi_e = torch.where(maskR, P_a, p_len)
            C_cr_e = torch.where(maskR, C_cr, 0)
            f_b = -(P_hi_e - P_cl_e) - C_cl_e - C_cr_e
            f_l = -(p_len - P_cl_e) - C_cl_e
            f_r_w = -P_hi_e - C_cr_e
            z3 = torch.zeros_like(cl_w)
            ms3 = minsc[:, None, None]
            sel_cl = clip_l[:, :, None]
            sel_cr = clip_r[:, :, None]

            def loser(ok_f, sc_f, cl_f, cr_f):
                is_sel = (cl_f == sel_cl) & (cr_f == sel_cr)
                okf = (ok_f & ((cl_f > 0) | (cr_f > 0)) & ~is_sel
                       & (sc_f >= ms3))
                return torch.where(okf, sc_f, NO_ALT)

            Tmax = int(min(L, 64))
            bw = torch.arange(Tmax, device=dev)[None, None, :]
            pa = p_at[..., :Tmax]
            pa_m1 = torch.cat([p_len[..., :1], p_at[..., :Tmax - 1]], -1)
            pen_b = torch.cat([torch.zeros((B, C, 1), dtype=i32,
                                           device=dev),
                               (pa_m1 - pa)[..., 1:]], dim=-1)
            ok_b = ((bw > 0) & (bw <= Tl - 1) & (pen_b > 0)
                    & (r_at[..., :Tmax] >= MINA) & (bw < lnc[:, :, None]))
            f_r_b = -pa - Cc[..., :Tmax]
            l_rb = loser(ok_b, f_r_b,
                         torch.zeros((B, C, Tmax), dtype=i32, device=dev),
                         bw.expand(B, C, Tmax))
            best_any = torch.maximum(
                torch.maximum(
                    torch.maximum(loser(a_okw, f_b, cl_w, cr_w),
                                  loser(a_okw, f_l, cl_w, z3)),
                    loser(a_okw, f_r_w, z3, cr_w)).max(dim=-1).values,
                l_rb.max(dim=-1).values)
            own = (((cl_w == sel_cl) & (sel_cl > 0))
                   | ((cr_w == sel_cr) & (sel_cr > 0)))
            best_own_b = torch.where(
                own, loser(a_okw, f_b, cl_w, cr_w), NO_ALT
            ).max(dim=-1).values
            sel_full = (clip_l == 0) & (clip_r == 0)
            sel_both = (clip_l > 0) & (clip_r > 0)
            alt = torch.where(sel_full, best_any,
                              torch.where(sel_both, NO_ALT, best_own_b))
    else:
        clip_l = torch.zeros((B, C), dtype=i32, device=dev)
        clip_r = torch.zeros((B, C), dtype=i32, device=dev)
        score = -total_pen
        ok = torch.ones((B, C), dtype=torch.bool, device=dev)
        alt = torch.full((B, C), NO_ALT, dtype=i32, device=dev)
    ok = ok & (cand_start >= 0)
    ok = ok & (score > -(_OOB_PEN // 2))
    keep = ((col >= clip_l[:, :, None])
            & (col < (lnc - clip_r)[:, :, None]))
    return ExtendResult(score.to(i32),
                        (mm & keep).sum(dim=-1, dtype=i32),
                        (isn & keep).sum(dim=-1, dtype=i32),
                        (snp_ok & keep).sum(dim=-1, dtype=i32),
                        clip_l, clip_r, ok, alt.to(i32))


def extend_grouped_plain(n_text: int, reads, quals, lens, cand_start,
                         mm_pen, clip_pen, n_pen: int, win_chars,
                         win_margin: int = 0, allow_softclip: bool = True,
                         uniform_len: bool = False, minsc=None,
                         mm_min: int = 1, snv1_win=None,
                         snv2_win=None) -> ExtendResult:
    """Plain torch twin of kernel 3: pen_planes + extend_from_planes."""
    planes = pen_planes(n_text, reads, quals, lens, cand_start, mm_pen,
                        n_pen, win_chars, win_margin, snv1_win, snv2_win)
    return extend_from_planes(n_text, reads, quals, lens, cand_start,
                              mm_pen, clip_pen, n_pen, allow_softclip,
                              planes, uniform_len, minsc, mm_min)


def extend_grouped(n_text: int, reads, quals, lens, cand_start, mm_pen,
                   clip_pen, n_pen: int, win_chars, win_margin: int = 0,
                   allow_softclip: bool = True, uniform_len: bool = False,
                   minsc=None, mm_min: int = 1, snv1_win=None,
                   snv2_win=None) -> ExtendResult:
    """Kernel 3 on CUDA tensors, extend_grouped_plain on CPU tensors.
    win_chars: the candidates' reference windows (splice.diag_chars with
    margin win_margin); snv1_win / snv2_win: the SNV-plane windows of the
    same diagonals on a graph index (None: no SNV forgiveness)."""
    if not reads.is_cuda:
        return extend_grouped_plain(
            n_text, reads, quals, lens, cand_start, mm_pen, clip_pen, n_pen,
            win_chars, win_margin, allow_softclip, uniform_len, minsc,
            mm_min, snv1_win, snv2_win)
    i32 = torch.int32
    B, L = reads.shape
    C = cand_start.shape[1]
    W = win_chars.shape[2]
    for nm, t, shp in (("reads", reads, (B, L)), ("quals", quals, (B, L)),
                       ("lens", lens, (B,)), ("cand_start", cand_start,
                                           (B, C)),
                       ("win_chars", win_chars, (B, C, W)),
                       ("mm_pen", mm_pen, (64,)),
                       ("clip_pen", clip_pen, (64,))):
        kernels.check_cuda(nm, t, i32, shp)
    if minsc is not None:
        kernels.check_cuda("minsc", minsc, i32, (B,))
    use_snv = snv1_win is not None
    if use_snv:
        kernels.check_cuda("snv1_win", snv1_win, i32, (B, C, W))
        kernels.check_cuda("snv2_win", snv2_win, i32, (B, C, W))
    if L > 1024 or W < L + 2 * win_margin:
        raise ValueError("extend_ungapped: read length above 1024 or a "
                         "window narrower than L + 2*margin")
    dev = reads.device
    e = lambda: torch.empty((B, C), dtype=i32, device=dev)  # noqa: E731
    score, n_mm, n_n, n_snp, clip_l, clip_r, alt = (e(), e(), e(), e(), e(),
                                                    e(), e())
    ok = torch.empty((B, C), dtype=torch.bool, device=dev)
    kernels.KERNELS["extend_ungapped"].launch(
        reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        cand_start.data_ptr(), win_chars.data_ptr(), mm_pen.data_ptr(),
        clip_pen.data_ptr(),
        (minsc if minsc is not None else lens).data_ptr(),
        (snv1_win if use_snv else win_chars).data_ptr(),
        (snv2_win if use_snv else win_chars).data_ptr(),
        B * C, C, L, W, win_margin, n_text, n_pen, int(allow_softclip),
        int(uniform_len), int(minsc is not None), mm_min, int(use_snv),
        score.data_ptr(), n_mm.data_ptr(), n_n.data_ptr(),
        n_snp.data_ptr(), clip_l.data_ptr(), clip_r.data_ptr(),
        ok.data_ptr(), alt.data_ptr(), stream=kernels.stream_of(reads))
    return ExtendResult(score, n_mm, n_n, n_snp, clip_l, clip_r, ok, alt)
