"""Small-axis gathers and stable ranks (counterpart of
hisat2_tpu/ops/compact.py), and the two compaction kernels of the device
step.

The JAX versions are one-hot masked reductions, a TPU workaround for its
descriptor-bound gathers.  Here they index directly (gather, stable sort);
the results are the same, including the edge rule that an out-of-range
index yields 0 / False.

`compact_cands` (K3 + K4: full-SA resolve, dedup and candidate compaction,
pipeline.py:772-998) launches kernel 5 (csrc/compact_cands.cu) on CUDA
tensors and runs `compact_candidates_plain` on CPU tensors; on a
sampled-SA index both take the rows' offsets resolved by the walk
(ops/resolve.py, K19+K20) on the live slots that `resolve_live` marks;
`pack_slots` (K9: top-Mdev slot selection, flags and the spill layout,
pipeline.py:1278-1371) launches kernel 6 (csrc/pack_slots.cu) or runs
`pack_slots_plain`.  The plain versions are line-by-line ports of the JAX
code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..utils.intops import wrap_i32
from .resolve import resolve_consecutive

_I32 = torch.int32
BIG = 2 ** 30
SHORTBIT = 2 ** 30
SENT = 2 ** 31 - 2


def _gather_or_zero(v, idx):
    n = v.shape[-1]
    ok = (idx >= 0) & (idx < n)
    g = v.gather(-1, torch.where(ok, idx, 0).to(torch.int64))
    return torch.where(ok, g, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def take_cols(v, idx):
    """take_along_axis(v, idx, axis=1) for v [B, J], idx [B, M]."""
    return _gather_or_zero(v, idx)


def take_last(v, idx):
    """v[..., idx] per row for v [B, C, W], idx [B, C]."""
    return _gather_or_zero(v, idx[..., None])[..., 0]


def stable_rank_asc(key):
    """rank[b, j] = position of j in the stable ascending sort of key[b]."""
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(key.shape[1], device=key.device)
                  .expand_as(order).contiguous())
    return rank.to(torch.int32)


def select_ranked(sel, v, fill=0):
    """Gather v[b, j] into slot m where sel[b, m, j] (at most one j per
    (b, m)); empty slots get `fill`.  sel: [B, M, J] bool, v: [B, J]."""
    hit = sel.any(dim=-1)
    j = sel.to(torch.uint8).argmax(dim=-1)
    g = v.gather(1, j)
    empty = torch.full((), fill if v.dtype != torch.bool else False,
                       dtype=v.dtype, device=v.device)
    return torch.where(hit, g, empty)


class Cands(NamedTuple):
    """The compacted candidate pool of a batch: core slots [N, CC], extra
    slots [N, C - CC], and per-lane metadata ([N], or None)."""
    cstart: torch.Tensor       # int32
    cvalid: torch.Tensor       # bool
    cvalid_long: torch.Tensor  # bool
    cab: torch.Tensor          # int32
    cpost: torch.Tensor        # bool
    xstart: torch.Tensor       # int32
    xvalid: torch.Tensor       # bool
    xab: torch.Tensor          # int32
    xpost: torch.Tensor        # bool
    h_minw: Optional[torch.Tensor]       # int32 (lane_meta)
    h_alignable: Optional[torch.Tensor]  # bool (lane_meta)
    h_sat: Optional[torch.Tensor]        # int32 (lite)


def resolve_live(top, bot, lo, hi, nh, P: int, min_k: int, maxsize: int,
                 short_rows: int, lite_cap: int = 0):
    """(hv [N, H], cval [N, H, P]): the hits that resolve and their live
    rows (pipeline.py:772-801), the gates of the full or the lite pass."""
    H = top.shape[1]
    w = bot - top
    hv = torch.arange(H, device=top.device)[None, :] < nh[:, None]
    islong_h = (hi - lo) > min_k + 2
    if lite_cap:
        maxsize = min(maxsize, lite_cap)
        hv = hv & islong_h
    hv = hv & torch.where(islong_h, w <= maxsize, w <= short_rows)
    j = torch.arange(P, device=top.device)
    return hv, hv[:, :, None] & (j[None, None, :] < w[:, :, None])


def research_live(top2, bot2, nh2, P2: int):
    """(hv2 [N, H2], cval2 [N, H2, P2]) of the spliced prefix re-search's
    hits (pipeline.py:868-874)."""
    H2 = top2.shape[1]
    w2 = bot2 - top2
    hv2 = ((torch.arange(H2, device=top2.device)[None, :] < nh2[:, None])
           & (w2 <= P2))
    j2 = torch.arange(P2, device=top2.device)
    return hv2, hv2[:, :, None] & (j2[None, None, :] < w2[:, :, None])


def compact_candidates_plain(sa, top, bot, lo, hi, nh, abefore, post,
                             stopped, P: int, C: int, CC: int, min_k: int,
                             maxsize: int, short_rows: int,
                             lite_cap: int = 0,
                             lane_meta: bool = False, top2=None, bot2=None,
                             lo2=None, nh2=None, P2: int = 0,
                             max_intron: int = 0, offs=None,
                             offs2=None) -> Cands:
    """Plain torch twin of kernel 5: the hit gates, the full-SA resolve
    and the dedup + compaction of pipeline.py:772-998, line by line.
    hits: [N, H] (nh, stopped: [N]); lite_cap > 0 selects the lite tier's
    caps (pipeline.py:781-798) and its h_sat.  Spliced mode, when the
    prefix re-search's hits top2/bot2/lo2 [N, H2] and nh2 [N] are given:
    their P2 rows per hit join as sweep-only slots (:846-883), short slots
    must lie within max_intron of one of the lane's 8 lowest align-capable
    starts (:905-916) and rank by that distance (:923-933).  offs [N, H, P]
    (and offs2 [N, H2, P2]): the rows' offsets resolved on a sampled-SA
    index (0 on dead rows); without them the rows gather the full SA."""
    N, H = top.shape
    dv = top.device
    ar_ = torch.arange
    w = bot - top                                                # [N, H]
    hv0 = ar_(H, device=dv)[None, :] < nh[:, None]
    islong_h = (hi - lo) > min_k + 2
    lite_wide = hv_meta = None
    if lite_cap:
        lite_wide = torch.any(hv0 & islong_h & (w > min(maxsize, lite_cap))
                              & (w <= maxsize), dim=1)
        hv_meta = hv0 & torch.where(islong_h, w <= maxsize,
                                    w <= short_rows)
    hv, cval = resolve_live(top, bot, lo, hi, nh, P, min_k, maxsize,
                            short_rows, lite_cap)
    if offs is None:
        offs = resolve_consecutive(sa, 0, torch.where(hv, top, 0), P)
    starts = (offs - lo[:, :, None]).reshape(N, H * P)
    cv = cval.reshape(N, H * P)
    hlen = (hi - lo)[:, :, None]
    hlen_flat = hlen.expand(N, H, P).reshape(N, H * P)
    w_flat = w[:, :, None].expand(N, H, P).reshape(N, H * P)
    align_slot = ((hlen_flat > min_k + 2)
                  & ((w_flat == 1) | ~stopped[:, None]))
    spliced = top2 is not None
    HP2 = 0
    if spliced:
        H2 = top2.shape[1]
        hv2, cval2 = research_live(top2, bot2, nh2, P2)
        if offs2 is None:
            offs2 = resolve_consecutive(sa, 0, torch.where(hv2, top2, 0), P2)
        starts2 = (offs2 - lo2[:, :, None]).reshape(N, H2 * P2)
        HP2 = H2 * P2
        starts = torch.cat([starts, starts2.to(starts.dtype)], 1)
        cv = torch.cat([cv, cval2.reshape(N, HP2)], 1)
        align_slot = torch.cat([align_slot, torch.zeros(
            (N, HP2), dtype=torch.bool, device=dv)], 1)
        # local-search proximity (:910-916), int32 wrapping as in JAX
        lkey = torch.where(cv & align_slot, starts, SENT).to(_I32)
        lsort = torch.sort(lkey, dim=1).values[:, :8]
        dd = wrap_i32(starts[:, :, None].to(torch.int64)
                      - lsort[:, None, :].to(torch.int64))
        adist = torch.where(dd == -2 ** 31, dd, dd.abs()).min(2).values
        cv = cv & (align_slot | (adist <= max_intron))
    is_short = ~align_slot
    ident = torch.where(cv, starts + torch.where(is_short, SHORTBIT, 0),
                        SENT).to(_I32)
    Jk = ident.shape[1]
    kj = ident[:, :, None]
    kk = ident[:, None, :]
    tril = torch.ones((Jk, Jk), dtype=torch.bool,
                      device=dv).tril(-1)[None]                  # k < j
    kept = (ident != SENT) & ~torch.any((kk == kj) & tril, dim=2)
    if spliced:
        # short slots rank by distance to the nearest align-capable
        # diagonal (:923-933)
        skey = torch.where(cv, torch.where(
            is_short, SHORTBIT + torch.clamp(adist, max=SHORTBIT - 1),
            starts), SENT).to(_I32)
        sj, sk = skey[:, :, None], skey[:, None, :]
    else:
        # DNA mode: the compaction key is the identity itself
        sj, sk = kj, kk
    krank = torch.where(
        kept,
        (((sk < sj) | ((sk == sj) & tril)) & kept[:, None, :]
         ).sum(dim=2, dtype=_I32), Jk)
    csel = ((krank[:, None, :]
             == ar_(C, device=dv, dtype=_I32)[None, :, None])
            & kept[:, None, :])
    cvalid = torch.any(csel, dim=2)
    cstart = select_ranked(csel, starts)
    cshort = select_ranked(csel, is_short)
    dup_short = cshort & torch.any(
        (cstart[:, :, None] == cstart[:, None, :])
        & ~cshort[:, None, :] & cvalid[:, None, :], dim=2)
    cvalid = cvalid & ~dup_short
    ab_flat = abefore[:, :, None].expand(N, H, P).reshape(N, H * P)
    post_flat = post[:, :, None].expand(N, H, P).reshape(N, H * P)
    if HP2:
        # the re-search rows inherit the lane's last hit's provenance
        ilast = torch.clamp(nh - 1, min=0)[:, None]
        ab_flat = torch.cat([ab_flat, take_cols(abefore, ilast).expand(
            N, HP2)], 1)
        post_flat = torch.cat([post_flat, take_cols(post, ilast).expand(
            N, HP2)], 1)
    same = (cstart[:, :, None] == starts[:, None, :]) & cv[:, None, :]
    cab = torch.where(same, ab_flat[:, None, :], BIG).min(dim=2).values
    cpost = ~torch.any(same & ~post_flat[:, None, :], dim=2)
    cvalid_long = cvalid & torch.any(same & align_slot[:, None, :], dim=2)
    h_minw = h_alignable = h_sat = None
    if lane_meta:
        wpos = torch.where((hv_meta if lite_cap else hv) & (w > 0), w,
                           2 ** 30)
        h_minw = wpos.min(dim=1).values.to(_I32)
        h_alignable = torch.any(align_slot, dim=1)
    if lite_cap:
        n_long = (kept & ~is_short).sum(dim=1, dtype=_I32)
        h_sat = (torch.clamp(n_long, max=63)
                 + 64 * lite_wide.to(_I32)).to(_I32)
    return Cands(cstart[:, :CC].contiguous(), cvalid[:, :CC].contiguous(),
                 cvalid_long[:, :CC].contiguous(),
                 cab[:, :CC].to(_I32).contiguous(),
                 cpost[:, :CC].contiguous(),
                 cstart[:, CC:].contiguous(),
                 cvalid_long[:, CC:].contiguous(),
                 cab[:, CC:].to(_I32).contiguous(),
                 cpost[:, CC:].contiguous(), h_minw, h_alignable, h_sat)


def compact_cands(sa, top, bot, lo, hi, nh, abefore, post, stopped,
                  P: int, C: int, CC: int, min_k: int, maxsize: int,
                  short_rows: int, lite_cap: int = 0,
                  lane_meta: bool = False, top2=None, bot2=None, lo2=None,
                  nh2=None, P2: int = 0, max_intron: int = 0, offs=None,
                  offs2=None) -> Cands:
    """Kernel 5 on CUDA tensors, compact_candidates_plain on CPU tensors.
    sa: the device full SA (int32, padded to a multiple of 8); top2 ..
    nh2: the spliced prefix re-search's hits (spliced mode); offs / offs2:
    the resolved offsets of a sampled-SA index (the kernel then reads them
    in place of the SA)."""
    if not top.is_cuda:
        return compact_candidates_plain(sa, top, bot, lo, hi, nh, abefore,
                                        post, stopped, P, C, CC, min_k,
                                        maxsize, short_rows, lite_cap,
                                        lane_meta, top2, bot2, lo2, nh2, P2,
                                        max_intron, offs, offs2)
    N, H = top.shape
    for nm, t, shp in (("sa", sa, None), ("top", top, (N, H)),
                       ("bot", bot, (N, H)), ("lo", lo, (N, H)),
                       ("hi", hi, (N, H)), ("nh", nh, (N,)),
                       ("abefore", abefore, (N, H))):
        kernels.check_cuda(nm, t, _I32, shp)
    kernels.check_cuda("post", post, torch.bool, (N, H))
    kernels.check_cuda("stopped", stopped, torch.bool, (N,))
    if not 0 <= CC <= C:
        raise ValueError("compact_cands: need 0 <= CC <= C")
    spliced = top2 is not None
    H2 = 0
    if spliced:
        H2 = top2.shape[1]
        for nm, t, shp in (("top2", top2, (N, H2)), ("bot2", bot2, (N, H2)),
                           ("lo2", lo2, (N, H2)), ("nh2", nh2, (N,))):
            kernels.check_cuda(nm, t, _I32, shp)
    if offs is not None:
        kernels.check_cuda("offs", offs, _I32, (N, H, P))
        if spliced:
            kernels.check_cuda("offs2", offs2, _I32, (N, H2, P2))
    dev = top.device
    X = C - CC

    def e(w, dt=_I32):
        return torch.empty((N, w), dtype=dt, device=dev)

    b = torch.bool
    out = Cands(e(CC), e(CC, b), e(CC, b), e(CC), e(CC, b),
                e(X), e(X, b), e(X), e(X, b),
                torch.empty(N, dtype=_I32, device=dev) if lane_meta else None,
                torch.empty(N, dtype=b, device=dev) if lane_meta else None,
                torch.empty(N, dtype=_I32, device=dev) if lite_cap else None)
    ptr = [t.data_ptr() if t is not None else None for t in out]
    kernels.KERNELS["compact_cands"].launch(
        sa.data_ptr(), top.data_ptr(), bot.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), nh.data_ptr(), abefore.data_ptr(), post.data_ptr(),
        stopped.data_ptr(),
        *((top2.data_ptr(), bot2.data_ptr(), lo2.data_ptr(), nh2.data_ptr())
          if spliced else (top.data_ptr(),) * 4),
        offs.data_ptr() if offs is not None else None,
        offs2.data_ptr() if offs is not None and spliced else None,
        N, H, P, C, CC, min_k, min(maxsize, 2 ** 31 - 1),
        short_rows, lite_cap, int(lane_meta), H2, P2, max_intron, *ptr,
        stream=kernels.stream_of(top))
    return out


# the unified slot schema (pipeline.py:1221-1277), in the order of the
# [F, N, K] tensor that pack_slots takes; "event" only on indexes with
# known ALT indels
SLOT_FIELDS = ("score", "d1", "d2", "x", "kind", "spldir", "known", "ab",
               "post", "selfgap", "n_mm", "n_n", "clip_l", "clip_r", "alt",
               "valid", "event")
# the dense per-slot outputs, in kernel 6's output order
_DENSE_OUT = ("score", "d1", "x", "ab", "n_mm", "n_n", "clip_l", "clip_r",
              "flags", "dd", "event")


def pack_slots_plain(uni, Mdev: int, use_spill: bool,
                     spliced: bool = False) -> dict:
    """Plain torch twin of kernel 6 (pipeline.py:1278-1371): uni int32
    [F, N, K] in SLOT_FIELDS order -> the u_* outputs (and the sp_*
    spill rows).  DNA mode ships d2 - d1 as a byte; spliced mode (a
    spliced or site-injecting pass, :1313-1318, :1351-1355) keeps the
    full d2 and spills 5 words."""
    F, N, Ktot = uni.shape
    dv = uni.device
    uni = dict(zip(SLOT_FIELDS[:F], uni.unbind(0)))
    if Mdev < Ktot or use_spill:
        skey = torch.where(uni["valid"] > 0, -uni["score"], 2 ** 31 - 1)
        order = torch.sort(skey, dim=1, stable=True).indices[:, :Mdev]
        uni = {k2: v2.gather(1, order) for k2, v2 in uni.items()}
    bslot = torch.where(uni["valid"] > 0, uni["score"],
                        -2 ** 30).argmax(dim=1)
    uni["alt"] = take_cols(uni["alt"], bslot[:, None])
    cs = torch.where(uni["spldir"] > 0, 3 + uni["spldir"], uni["kind"])
    uni["flags"] = (uni["valid"] | (uni["post"] << 1)
                    | (uni["selfgap"] << 2) | (uni["known"] << 3)
                    | (cs << 4))
    for k2 in ("valid", "post", "selfgap", "known", "kind", "spldir"):
        del uni[k2]
    if not spliced:
        uni["dd"] = uni["d2"] - uni["d1"]
        del uni["d2"]
    out = {}
    if use_spill:
        # SPILL layout (:1319-1369): slots 0-1 dense, the remaining
        # valid slots compacted into S = 2B rows of 4 packed words
        Msp = Mdev - 2
        S = N
        spmask = (uni["flags"][:, 2:] & 1) > 0
        flatm = spmask.reshape(-1)
        fidx = torch.arange(N * Msp, device=dv, dtype=_I32)
        BIGI = 2 ** 30
        src = torch.sort(torch.where(flatm, fidx, BIGI)).values
        if src.shape[0] >= S:
            src = src[:S]
        else:
            src = torch.cat([src, torch.full((S - src.shape[0],), BIGI,
                                             dtype=_I32, device=dv)])
        n_sp = flatm.sum()
        src = torch.where(src >= BIGI, -1, src).to(_I32)
        src[S - 1] = torch.where(n_sp > S, -2, src[S - 1])
        gidx = src.clamp(min=0).to(torch.int64)

        def tk(a):
            return a[:, 2:].reshape(-1)[gidx].to(torch.int64)

        sc16 = uni["score"].clamp(-32768, 32767)
        w0 = tk(uni["d1"])
        w1 = ((tk(sc16) & 0xFFFF) | ((tk(uni["flags"]) & 0x7F) << 16)
              | (tk(uni["ab"]).clamp(0, 127) << 24))
        w2 = ((tk(uni["clip_l"]).clamp(0, 255) & 0xFF)
              | ((tk(uni["clip_r"]).clamp(0, 255) & 0xFF) << 8)
              | ((tk(uni["n_mm"]).clamp(0, 255) & 0xFF) << 16)
              | (tk(uni["n_n"]).clamp(0, 127) << 24))
        if spliced:
            words = [w0, w1, w2, tk(uni["x"]).clamp(0, 255) & 0xFF,
                     tk(uni["d2"])]
        else:
            words = [w0, w1, w2, ((tk(uni["x"]).clamp(0, 255) & 0xFF)
                                  | ((tk(uni["dd"]) & 0xFF) << 8))]
        out["sp_src"] = src
        out["sp_w"] = wrap_i32(torch.stack(words, dim=1))
        if "event" in uni:
            out["sp_ev"] = tk(uni["event"]).to(_I32)
        for k2 in list(uni):
            if k2 != "alt":
                uni[k2] = uni[k2][:, :2]
    for k2, v2 in uni.items():
        out["u_" + k2] = v2
    return out


def pack_slots(uni, Mdev: int, use_spill: bool,
               spliced: bool = False) -> dict:
    """Kernel 6 on CUDA tensors, pack_slots_plain on CPU tensors.  uni:
    int32 [F, N, K], the unified slot schema in SLOT_FIELDS order (F = 16,
    or 17 with the event row)."""
    if not uni.is_cuda:
        return pack_slots_plain(uni, Mdev, use_spill, spliced)
    F, N, K = uni.shape
    kernels.check_cuda("uni", uni, _I32)
    if F not in (16, 17):
        raise ValueError("pack_slots: uni must hold 16 or 17 fields")
    has_event = F == 17
    do_select = Mdev < K or use_spill
    Wd = 2 if use_spill else Mdev
    dev = uni.device
    dense = torch.empty((len(_DENSE_OUT), N, Wd), dtype=_I32, device=dev)
    alt = torch.empty((N, 1), dtype=_I32, device=dev)
    z = torch.empty(0, dtype=_I32, device=dev)
    Msp = Mdev - 2
    words = (torch.empty((N * Msp, 6), dtype=_I32, device=dev)
             if use_spill else z)
    cnt = torch.empty(N, dtype=_I32, device=dev) if use_spill else z
    offs = torch.empty(N, dtype=_I32, device=dev) if use_spill else z
    src = torch.empty(N, dtype=_I32, device=dev) if use_spill else z
    nw = 5 if spliced else 4
    sp_w = torch.empty((N, nw), dtype=_I32, device=dev) if use_spill else z
    sp_ev = (torch.empty(N, dtype=_I32, device=dev)
             if use_spill and has_event else z)
    kernels.KERNELS["pack_slots"].launch(
        uni.data_ptr(), N, K, Mdev, int(do_select), int(use_spill),
        int(has_event), int(spliced), dense.data_ptr(), alt.data_ptr(),
        words.data_ptr(),
        cnt.data_ptr(), offs.data_ptr(), src.data_ptr(), sp_w.data_ptr(),
        sp_ev.data_ptr(), stream=kernels.stream_of(uni))
    out = {("u_d2" if k == "dd" and spliced else "u_" + k): dense[i]
           for i, k in enumerate(_DENSE_OUT) if k != "event" or has_event}
    out["u_alt"] = alt
    if use_spill:
        out["sp_src"] = src
        out["sp_w"] = sp_w
        if has_event:
            out["sp_ev"] = sp_ev
    return out
