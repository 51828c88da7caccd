"""Bigram double-step FM partial search (counterpart of
hisat2_tpu/ops/search.py: partial_search2 :409 and _finish_events :326).

`partial_search2` is the wrapper the pipeline calls: on CUDA tensors it
launches kernel 1 (csrc/fm_search2.cu), which folds the event finish into
the scan; on CPU tensors it runs the plain version, `partial_search2_plain`
(a step loop emitting the per-position event stream, then
`_finish_events`), which is a line-by-line port of the JAX scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..utils.intops import cumsum_i32, wrap_i32
from . import rank as rk


class PartialHits(NamedTuple):
    rounds: torch.Tensor   # int32 [B, RW] byte-packed round log (4/word)
    nrounds: torch.Tensor  # int32 [B]
    top: torch.Tensor      # int32 [B, H]
    bot: torch.Tensor      # int32 [B, H]
    lo: torch.Tensor       # int32 [B, H] leftmost read pos covered
    hi: torch.Tensor       # int32 [B, H] one past rightmost read pos
    nh: torch.Tensor       # int32 [B]
    abefore: torch.Tensor  # int32 [B, H] non-unique rounds before the hit
    uniq: torch.Tensor     # bool  [B, H]
    post: torch.Tensor     # bool  [B, H]
    stopped: torch.Tensor  # bool  [B]


def _finish_events(lens, H, min_hit_len, f_top, f_bot, f_rb, f_stopped,
                   ev, ev_top, ev_bot, ev_stop):
    """PartialHits from a per-position event stream (search.py:326)."""
    B, L = ev.shape
    dev = ev.device
    i32 = torch.int32
    srange = torch.arange(L, device=dev, dtype=i32)[None, :]
    pos = lens[:, None] - 1 - srange
    is_ev = ev > 0
    evpos = torch.where(is_ev, pos, 2 ** 30)
    prev = torch.cat([torch.full((B, 1), 2 ** 30, dtype=i32, device=dev),
                      torch.cummin(evpos, dim=1).values[:, :-1]], dim=1)
    rb_ev = torch.where(prev < 2 ** 29, prev, lens[:, None])
    seg = torch.where(ev == 2, rb_ev - pos, rb_ev - pos - 1)
    term_seg = f_rb
    rec = (ev == 2) | ((ev == 1) & (seg >= min_hit_len))
    na_inc = ((ev == 1) & (seg >= 1)).to(i32)
    na_before = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                           cumsum_i32(na_inc, 1)[:, :-1]], dim=1)
    nrec = rec.to(i32).sum(dim=1, dtype=i32)
    rrank = cumsum_i32(rec.to(i32), 1) - 1
    hsel = rec[:, None, :] & (
        rrank[:, None, :]
        == torch.arange(H, device=dev, dtype=i32)[None, :, None])

    def gsel(a):
        return torch.where(hsel, a[:, None, :], 0).sum(dim=2, dtype=i32)

    ht = gsel(ev_top)
    hb = gsel(ev_bot)
    hl = gsel(pos + (ev == 1).to(i32))
    hh = gsel(rb_ev)
    ha = gsel(na_before)
    hu = torch.any(hsel & (ev == 2)[:, None, :], dim=2)
    hp = torch.any(hsel & ev_stop[:, None, :], dim=2)
    term_ok = term_seg >= min_hit_len
    tslot = torch.clamp(nrec, max=H - 1)[:, None]
    tsel = ((torch.arange(H, device=dev, dtype=i32)[None, :] == tslot)
            & term_ok[:, None] & (nrec < H)[:, None])
    ht = torch.where(tsel, f_top[:, None], ht)
    hb = torch.where(tsel, f_bot[:, None], hb)
    hl = torch.where(tsel, 0, hl).to(i32)
    hh = torch.where(tsel, f_rb[:, None], hh)
    na_total = na_inc.sum(dim=1, dtype=i32)
    ha = torch.where(tsel, na_total[:, None], ha)
    hu = torch.where(tsel, True, hu)
    hp = torch.where(tsel, f_stopped[:, None], hp)
    nh = torch.clamp(nrec + term_ok.to(i32), max=H)
    round_ev = is_ev & ~ev_stop
    val = torch.clamp(seg, max=126) * 2 + (ev == 2).to(i32)
    R = L // 2 + 2
    rrank_r = cumsum_i32(round_ev.to(i32), 1) - 1
    rsel = round_ev[:, None, :] & (
        rrank_r[:, None, :]
        == torch.arange(R, device=dev, dtype=i32)[None, :, None])
    rl = torch.where(rsel, val[:, None, :], 0).sum(dim=2, dtype=i32)
    nround = round_ev.to(i32).sum(dim=1, dtype=i32)
    term_round = (term_seg > 0) & ~f_stopped
    trslot = torch.clamp(nround, max=R - 1)[:, None]
    trsel = ((torch.arange(R, device=dev, dtype=i32)[None, :] == trslot)
             & term_round[:, None] & (nround < R)[:, None])
    rl = torch.where(trsel, torch.clamp(term_seg, max=126)[:, None] * 2 + 1,
                     rl)
    rn = torch.clamp(nround + term_round.to(i32), max=R)
    RW = (R + 3) // 4
    pad = torch.zeros((B, RW * 4 - R), dtype=i32, device=dev)
    rl4 = torch.cat([rl, pad], dim=1).reshape(B, RW, 4).to(torch.int64)
    sh = torch.arange(4, device=dev)[None, None, :] * 8
    rwords = wrap_i32((rl4 << sh).sum(dim=2))
    return PartialHits(rwords, rn.to(i32), ht, hb, hl, hh, nh.to(i32), ha,
                       hu, hp, f_stopped)


def partial_search2_plain(blocked, fchr, ftab2_top, zrow: int, zrow2: int,
                          rows: int, reads, lens, max_hits: int = 8,
                          min_hit_len: int = 16, min_k: int = 16,
                          uniform: bool = False,
                          anchor_stop: bool = True) -> PartialHits:
    """Plain torch twin of kernel 1 (search.py:409 line by line)."""
    B, L = reads.shape
    dev = reads.device
    i32 = torch.int32
    H = max_hits
    lens = lens.to(i32)
    reads = reads.to(i32)
    a_stop_len = min_k + 12 if anchor_stop else 2 ** 30
    a_cancel_len = min_k + 8
    S = (L + 1) // 2
    if uniform:
        rrev = reads.flip(1)
    else:
        colL = torch.arange(L, device=dev, dtype=i32)[None, :]
        ridx = lens[:, None] - 1 - colL
        rrev = torch.where(
            ridx >= 0,
            reads.gather(1, ridx.clamp(min=0).to(torch.int64)), 4)
    if L % 2:
        rrev = torch.cat([rrev, torch.full((B, 1), 4, dtype=i32,
                                           device=dev)], dim=1)
    fchr64 = fchr.to(torch.int64)
    ftab64 = ftab2_top.to(torch.int64)

    def phase(state, pos, c, t_new, b_new):
        top, bot, rb, arm, stopped = state
        active = pos >= 0
        valid_c = (c < 4) & active
        ok = valid_c & (b_new > t_new)
        seg = rb - pos
        width = b_new - t_new
        arm = arm & ~(ok & (seg - 1 >= a_cancel_len) & (width >= 4))
        astop = ok & arm & active & (seg >= a_stop_len) & (width == 1)
        fail = active & ~ok
        ev = torch.where(astop, 2, torch.where(fail, 1, 0)).to(i32)
        ev_top = torch.where(astop, t_new, top)
        ev_bot = torch.where(astop, b_new, bot)
        top_n = torch.where(ok, t_new, 0)
        bot_n = torch.where(ok, b_new, rows)
        rb_n = torch.where(ok, rb, pos)
        top_n = torch.where(astop, 0, top_n)
        bot_n = torch.where(astop, rows, bot_n)
        rb_n = torch.where(astop, pos, rb_n)
        arm = torch.where(fail | astop, True, arm)
        top = torch.where(active, top_n, top).to(i32)
        bot = torch.where(active, bot_n, bot).to(i32)
        rb = torch.where(active, rb_n, rb).to(i32)
        stopped_out = stopped
        stopped = stopped | astop
        return ((top, bot, rb, arm, stopped),
                (ev, ev_top.to(i32), ev_bot.to(i32), stopped_out),
                fail | astop)

    state = (torch.zeros(B, dtype=i32, device=dev),
             torch.full((B,), rows, dtype=i32, device=dev), lens.clone(),
             torch.ones(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    ev1s, ev2s = [], []
    for s in range(S):
        c1 = rrev[:, 2 * s]
        c2 = rrev[:, 2 * s + 1]
        top, bot = state[0], state[1]
        pos1 = lens - 1 - 2 * s
        pos2 = pos1 - 1
        i2 = torch.cat([top, bot]).to(torch.int64)
        rws = rk.gather_rows(blocked, i2)
        cc1 = torch.clamp(c1, max=3).to(torch.int64)
        r1 = rk.rank_from_rows(rws, i2, torch.cat([cc1, cc1]), zrow)
        lf1 = fchr64[cc1]
        t1 = (lf1 + r1[:B]).to(i32)
        b1 = (lf1 + r1[B:]).to(i32)
        state, ev1, restart1 = phase(state, pos1, c1, t1, b1)
        cc2 = torch.clamp(c2, max=3).to(torch.int64)
        sym = cc2 * 4 + cc1
        r2 = rk.rank2_from_rows(rws, i2, torch.cat([sym, sym]), zrow, zrow2)
        base2 = ftab64[sym]
        t2b = base2 + r2[:B]
        b2b = base2 + r2[B:]
        t2 = torch.where(restart1, fchr64[cc2], t2b).to(i32)
        b2 = torch.where(restart1, fchr64[cc2 + 1], b2b).to(i32)
        state, ev2, _ = phase(state, pos2, c2, t2, b2)
        ev1s.append(ev1)
        ev2s.append(ev2)
    f_top, f_bot, f_rb, _, f_stopped = state

    def interleave(k):
        # [S] x [B] pairs -> [B, L] in original per-char order
        a1 = torch.stack([e[k] for e in ev1s], dim=1)
        a2 = torch.stack([e[k] for e in ev2s], dim=1)
        return torch.stack([a1, a2], dim=2).reshape(B, 2 * S)[:, :L]

    return _finish_events(lens, H, min_hit_len, f_top, f_bot, f_rb,
                          f_stopped, interleave(0), interleave(1),
                          interleave(2), interleave(3))


def partial_search2(blocked, fchr, ftab2_top, zrow: int, zrow2: int,
                    rows: int, reads, lens, max_hits: int = 8,
                    min_hit_len: int = 16, min_k: int = 16,
                    uniform: bool = False,
                    anchor_stop: bool = True, lanes=None) -> PartialHits:
    """Kernel 1 on CUDA tensors, the plain version on CPU tensors.

    `uniform` only promises lens == L (the kernel reads read[len-1-t]
    either way, which is what the uniform path reads then).  lanes: an
    int32 list of lane ids (kernel 1's lane-list mode, K17): only those
    lanes are searched and every other lane's row is zeros."""
    if not reads.is_cuda:
        if lanes is not None:
            raise ValueError("the lane-list mode is a kernel mode; the "
                             "plain twin is search_lanes_live_plain")
        return partial_search2_plain(
            blocked, fchr, ftab2_top, zrow, zrow2, rows, reads, lens,
            max_hits, min_hit_len, min_k, uniform, anchor_stop)
    B, L = reads.shape
    H = max_hits
    i32 = torch.int32
    kernels.check_cuda("reads", reads, i32)
    kernels.check_cuda("lens", lens, i32, (B,))
    kernels.check_cuda("blocked", blocked, i32)
    if blocked.dim() != 2 or blocked.shape[1] not in (44, 49):
        raise ValueError("fm_search2 needs the 44-column fused table (49 "
                         "with the mark columns of a sampled SA)")
    if L > 512:
        raise ValueError(f"fm_search2: read length {L} exceeds the "
                         f"kernel's bound of 512")
    R = L // 2 + 2
    RW = (R + 3) // 4
    dev = reads.device
    z = lambda *s: torch.zeros(s, dtype=i32, device=dev)  # noqa: E731
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)  # noqa
    out = PartialHits(z(B, RW), z(B), z(B, H), z(B, H), z(B, H), z(B, H),
                      z(B), z(B, H), zb(B, H), zb(B, H), zb(B))
    a_stop_len = min_k + 12 if anchor_stop else 2 ** 30
    K = B
    name = "fm_search2"
    if lanes is not None:
        kernels.check_cuda("lanes", lanes, i32)
        K = lanes.shape[0]
        name = "search_lanes_live"
        if K == 0:              # no live lane: every row stays zero
            return out
    kernels.KERNELS[name].launch(
        blocked.data_ptr(), fchr.data_ptr(), ftab2_top.data_ptr(),
        reads.data_ptr(), lens.data_ptr(),
        lanes.data_ptr() if lanes is not None else reads.data_ptr(),
        int(lanes is not None), K, L, zrow, zrow2, rows,
        a_stop_len, min_k + 8, min_hit_len, H, blocked.shape[1],
        out.top.data_ptr(), out.bot.data_ptr(), out.lo.data_ptr(),
        out.hi.data_ptr(), out.abefore.data_ptr(), out.uniq.data_ptr(),
        out.post.data_ptr(), out.rounds.data_ptr(), out.nrounds.data_ptr(),
        out.nh.data_ptr(), out.stopped.data_ptr(),
        stream=kernels.stream_of(reads))
    return out


def search_lanes_live_plain(search_fn, reads, lens, min_hit_len: int,
                            chunk: int = 2048) -> PartialHits:
    """Plain twin of K17 (search.py:267 search_lanes_live, line by line):
    run search_fn over only the lanes with lens >= min_hit_len, compacted
    (stable) and searched `chunk` at a time; dead lanes are zeros.  With
    at most `chunk` lanes the dense search runs, as in JAX.  search_fn:
    (reads [K, L], lens [K]) -> PartialHits."""
    B, L = reads.shape
    if B <= chunk:
        return search_fn(reads, lens)
    dev = reads.device
    lv = lens >= min_hit_len
    lvi = lv.to(torch.int64)
    pos = torch.cumsum(lvi, 0) - lvi
    total = int(pos[-1] + lvi[-1])
    src = torch.sort(1 - lvi, stable=True).indices
    nch = (B + chunk - 1) // chunk
    Bp = nch * chunk
    srcp = torch.zeros(Bp, dtype=torch.int64, device=dev)
    srcp[:B] = src
    bufs = None
    k = 0
    while k * chunk < total:
        ids = srcp[k * chunk:(k + 1) * chunk]
        ph = search_fn(reads[ids], lens.to(torch.int32)[ids])
        if bufs is None:
            bufs = [torch.zeros((Bp,) + tuple(v.shape[1:]), dtype=v.dtype,
                                device=dev) for v in ph]
        for b, v in zip(bufs, ph):
            b[k * chunk:(k + 1) * chunk] = v
        k += 1
    if bufs is None:            # no live lane: the shapes of one chunk
        ph = search_fn(reads[srcp[:chunk]], lens.to(torch.int32)[
            srcp[:chunk]])
        bufs = [torch.zeros((Bp,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=dev) for v in ph]
    posc = torch.clamp(pos, max=Bp - 1)
    outs = []
    for b in bufs:
        v = b[posc]
        m = lv.reshape((B,) + (1,) * (v.dim() - 1))
        outs.append(torch.where(m, v, torch.zeros((), dtype=b.dtype,
                                                  device=dev)))
    return PartialHits(*outs)


def search_lanes_live_ref(blocked, fchr, ftab2_top, zrow: int, zrow2: int,
                          rows: int, reads, cut, max_hits: int,
                          min_hit_len: int, min_k: int,
                          chunk: int = 2048) -> PartialHits:
    """K17 in plain torch with the wrapper's arguments:
    search_lanes_live_plain over partial_search2_plain."""
    def fn(rr, ll):
        return partial_search2_plain(blocked, fchr, ftab2_top, zrow, zrow2,
                                     rows, rr, ll, max_hits, min_hit_len,
                                     min_k)
    return search_lanes_live_plain(fn, reads, cut, min_hit_len, chunk)


def search_lanes_live(blocked, fchr, ftab2_top, zrow: int, zrow2: int,
                      rows: int, reads, cut, max_hits: int,
                      min_hit_len: int, min_k: int,
                      chunk: int = 2048) -> PartialHits:
    """The spliced prefix re-search (pipeline.py:846-860): kernel 1 over
    reads [N, L] with per-lane lengths `cut`.  On CUDA tensors with more
    than `chunk` lanes it is K17, kernel 1's lane-list mode over the live
    lanes (cut >= min_hit_len, a stable compaction); with fewer, the
    dense kernel 1, as JAX runs it.  On CPU tensors it is
    search_lanes_live_plain over partial_search2_plain."""
    if not reads.is_cuda:
        return search_lanes_live_ref(blocked, fchr, ftab2_top, zrow, zrow2,
                                     rows, reads, cut, max_hits, min_hit_len,
                                     min_k, chunk)
    if reads.shape[0] <= chunk:
        return partial_search2(blocked, fchr, ftab2_top, zrow, zrow2, rows,
                               reads, cut, max_hits, min_hit_len, min_k)
    lanes = torch.nonzero(cut >= min_hit_len)[:, 0].to(torch.int32)
    return partial_search2(blocked, fchr, ftab2_top, zrow, zrow2, rows,
                           reads, cut, max_hits, min_hit_len, min_k,
                           lanes=lanes.contiguous())
