"""The kernels' work counts: a frozen copy of chip_smoke.py's `work` and
the helpers it calls (nbytes, _union, _search_rows, indel_work,
flat_outputs, extend_groups), as of the commit that added this
benchmark, with the plain live-slot logic those counts read from the
program (ops/compact.py's resolve_live and research_live and its
SLOT_FIELDS, ops/splice.py's indel_sweep_gap and indel_probes) copied
here too, so that no change to the program moves a bound.

work(torch, name, kw, out) gives one kernel call's least time on the
card, in ms, and what bounds it: the bytes it must move at the HBM rate,
or its operations at the rate of the units that run them.  It counts the
kernels whose count is of distinct bytes or of operations; the FM
searches (K1, K17), the reference windows (K5), the sampled-SA walk
(K19+K20) and the site injection (K16) have none yet (roofline.py
leaves them out).
"""

import math

from .peaks import CUDA_CORE, HBM, INT8

def nbytes(torch, *ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def work(torch, name, kw, out):
    """(bytes, operations, peak rate, what bounds it) of one kernel call
    on these inputs.  Bytes: the dense inputs read once, the outputs
    written once, and of a large table only what these inputs touch.
    Operations: the kernel's per-element work at the CUDA-core rate,
    except K12, whose JAX original is a one-hot product (2 * 4 * W * L
    operations per job), at the int8 tensor-core rate its kernel runs it
    at (rescue_bf16_bound: the same count at the bf16 rate)."""
    ob = nbytes(torch, *flat_outputs(out))
    dense = nbytes(torch, *(v for k, v in kw.items() if k not in (
        "blocked", "sa", "sa_marked", "ref_words", "snv_delta1",
        "snv_delta2", "ip",
        "ilen", "ins_chars", "rkey", "r_ilen", "r_row")))
    rate = CUDA_CORE
    if name == "compact_cands":
        # the rows of the live hits (and of the spliced re-search's live
        # hits), each resolved once from the SA or read from the walk's
        # offsets (so offs / offs2 count by those rows, not in full); the
        # sorts' J log2 J compares a lane over its J slots
        N, H = kw["top"].shape
        P = kw["P"]
        hv, _ = resolve_live(torch, kw["top"], kw["bot"], kw["lo"],
                             kw["hi"], kw["nh"], P, kw["min_k"],
                             kw["maxsize"], kw["short_rows"],
                             kw["lite_cap"])
        rows = int(torch.where(hv, (kw["bot"] - kw["top"]).clamp(0, P),
                               0).sum())
        J = H * P
        if kw.get("top2") is not None:
            P2 = kw["P2"]
            hv2, _ = research_live(torch, kw["top2"], kw["bot2"],
                                   kw["nh2"], P2)
            rows += int(torch.where(hv2, (kw["bot2"] - kw["top2"]).clamp(
                0, P2), 0).sum())
            J += kw["top2"].shape[1] * P2
        dense -= nbytes(torch, kw.get("offs"), kw.get("offs2"))
        extra = rows * 4
        ops = N * J * max(1, (J - 1).bit_length())
    elif name == "extend_ungapped":
        # what the result needs: each lane's read and quals, the len
        # columns [margin, margin + len) of each distinct (lane, start)
        # group's window (and SNV windows), the window of the dead start
        # -1 once (it is the same for every lane), the starts, lens, minsc
        # and tables, the eight output planes; ~30 integer ops per column
        # of each group
        st, lens = kw["cand_start"], kw["lens"].long()
        B, C = st.shape
        nwin = 1 if kw.get("snv1_win") is None else 3
        live_g, dead_g = extend_groups(st)
        cols = int((live_g * lens).sum())
        dense = (int(lens.sum()) * 2 * 4 + (cols + int(lens.max())) * 4
                 * nwin + B * C * 4 + B * 8 + 2 * 64 * 4)
        extra, ob = 0, B * C * (7 * 4 + 1)
        ops = int(((live_g + dead_g) * lens).sum()) * 30
    elif name == "indel_sweep":
        # a dead candidate's row needs only its start: the read and quals
        # of each lane with a live candidate, the len + 2G columns
        # [M - G, M + G + len) of each live window (and SNV window) that
        # some shift reads, valid, starts, lens and minsc, the ten output
        # planes; 8 integer ops for each of the 4G combos at each of the
        # len + 1 split points of a live candidate
        N, C, W = kw["ch"].shape
        G = indel_sweep_gap(kw["reads"].shape[1], W, kw["max_gap"],
                            kw["prm"])
        valid, lens = kw["valid"], kw["lens"].long()
        live = int(valid.sum())
        live_cols = int((valid.sum(1) * lens).sum())
        nwin = 1 if kw.get("snv1_w") is None else 3
        dense = ((live_cols + 2 * G * live) * 4 * nwin
                 + int(lens[valid.any(1)].sum()) * 8 + N * C * 5 + N * 8)
        extra, ob = 0, 10 * N * C * 4
        ops = (live_cols + live) * G * 4 * 8
    elif name == "pack_slots":
        # the schema's planes read once, whatever reads them: each
        # distinct tensor once (a plane that fills two fields, as d1 and
        # d2 of the ungapped slots, is read once), by the elements it
        # spans (a broadcast plane reads one row); a constant or absent
        # field, or a block's key outside the schema, reads nothing; ~4
        # integer ops per slot key and ~40 per selected slot (a round of
        # the selection, its field loads and the packing)
        blocks = kw["blocks"]
        fields = SLOT_FIELDS[:17 if kw.get("has_event") else 16]
        planes = {(v.data_ptr(), tuple(v.shape), v.stride(), v.dtype): v
                  for b in blocks for f in fields
                  if torch.is_tensor(v := b.get(f))}
        dense = sum(math.prod(n for n, s in zip(v.shape, v.stride()) if s)
                    * v.element_size() for v in planes.values())
        N = blocks[0]["score"].shape[0]
        K = sum(b["score"].shape[1] for b in blocks)
        extra, ops = 0, N * (4 * K + 40 * kw["Mdev"])
    elif name == "inject_indels":
        # only what the call must read: indel_work
        dense, ops = indel_work(torch, kw)
        extra = 0
    elif name == "rescue_window":
        R, L = kw["reads"].shape
        extra = R * ((kw["W"] + L - 1 + 15) // 16) * 4   # 2-bit windows
        ops, rate = 2 * 4 * kw["W"] * L * R, INT8
    elif name == "pair_sweep":
        # planes (48 PWM factors + prefixes per column), then ~25 integer
        # ops per (pair, x)
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        extra = 0
        ops = N * C * (Lr + 1) * 60 + N * C * C * (Lr + 2) * 25
    elif name == "second_sweep":
        # one plane prologue, then four sides (two base pairs), ~30
        # integer ops per cell each
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        extra = 0
        ops = N * C * (Lr + 1) * (60 + 4 * 30)
    elif name == "merge_sites":
        extra, ops = 0, kw["kd"].shape[0] * 6 * 10
    else:
        raise KeyError(name)
    by = dense + extra + ob
    t_b, t_o = by / HBM * 1e3, ops / rate * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _union(torch, lo, hi):
    """The count of integers in the union of the intervals [lo, hi)."""
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    if lo.numel() == 0:
        return 0
    lo, order = lo.sort()
    hi = hi[order]
    # each interval adds what lies past the furthest end before it
    reach = hi.cummax(0).values
    before = torch.cat([lo[:1], reach[:-1]])
    return int((hi - lo.maximum(before)).clamp(min=0).sum())


def _search_rows(torch, tab, key):
    """Per row of the sorted table tab [E], whether a lower-bound search
    for any of the keys reads it, and each key's result."""
    E = tab.shape[0]
    lo = torch.zeros_like(key, dtype=torch.int64)
    hi = torch.full_like(lo, E)
    seen = torch.zeros(E, dtype=torch.bool, device=tab.device)
    while True:
        act = lo < hi
        if not bool(act.any()):
            return seen, lo
        mid = (lo + hi) >> 1
        seen[mid[act]] = True
        less = tab[mid.clamp(max=E - 1)] < key
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)


def indel_work(torch, kw):
    """K10's input bytes and integer operations on these arguments, by
    what the call must read.  Each candidate's start and valid flag, each
    lane's len, the 64-entry table, minsc of a lane with a live slot.  Of
    the event tables, the rows the probes touch, each once: each search's
    keys and, of a valid candidate, its slots' keys (ip / rkey); each
    slot's length (ilen / r_ilen, which d1 and d2 need dead or live); a
    live right-keyed slot's r_row; the I allele chars of each insertion an
    in-read slot checks.  Of the reads, qualities and windows what the
    walks and the allele checks read, each column once: a lane's read
    over the union of its live slots' runs and checked alleles, its
    qualities over its live slots' runs, each (lane, candidate) source
    window and its SNV windows over its live slots' source runs, the
    packed words (ref and SNV) of the live slots' fresh runs.  A live
    slot's two runs: left-keyed, the source window below x and the fresh
    diagonal from x + I to the read's end; right-keyed, the reverse.
    Operations: ~40 integer ops a slot, ~30 a walked column."""
    pr = indel_probes(torch, *(kw[k] for k in (
        "starts", "valid", "lens", "reads", "ip", "ilen", "ins_chars",
        "rkey", "r_ilen", "r_row")), kw["slots"])
    i64 = torch.int64
    starts, valid = kw["starts"], kw["valid"]
    N, C = starts.shape
    L = kw["reads"].shape[1]
    E = kw["ip"].shape[0]
    slots = kw["slots"]
    dev = starts.device
    x, fresh, ev, elen = (pr[k].to(i64) for k in ("x", "fresh", "event",
                                                   "elen"))
    live, J = pr["live"], pr["x"].shape[1]
    I = (-elen).clamp(min=0)
    ln = kw["lens"].to(i64)[:, None].expand(N, J)
    lim = ln.clamp(max=L)
    xr = (x + I).clamp(max=L)
    j = torch.arange(J, device=dev)
    left = (j < slots * C)[None, :].expand(N, J)
    n = torch.arange(N, device=dev)[:, None].expand(N, J)
    c = j % C
    by = N * C * 5 + N * 4 + 64 * 4 + int(live.any(1).sum()) * 4
    # an insertion an in-read slot checks the allele of
    chk = (pr["okd"] & (x >= 1) & (x + I <= ln - 1) & (elen < 0))
    for side, tab in ((0, kw["ip"]), (1, kw["rkey"])):
        seen, lo = _search_rows(torch, tab, starts + 1)
        used = torch.zeros(E, dtype=torch.bool, device=dev)
        keyed, event = torch.zeros_like(used), torch.zeros_like(used)
        for t in range(slots):
            idx = (lo + t).clamp(max=E - 1)
            used[idx.reshape(-1)] = True
            keyed[idx[valid & (lo + t < E)]] = True
            if side:                    # r_row, the event of a slot
                at = slice((slots + t) * C, (slots + t + 1) * C)
                event[idx[live[:, at] | chk[:, at]]] = True
        by += 4 * int((seen | keyed).sum() + used.sum() + event.sum())
    allele = torch.zeros(E, dtype=i64, device=dev)
    allele[ev[chk].clamp(min=0)] = I[chk].clamp(max=MAX_INS)
    by += int(allele.sum()) * 4
    # the runs of the live slots: below x, and from x + I to the read's end
    lv = live
    below = (torch.zeros_like(x[lv]), torch.minimum(x, lim)[lv])
    after = (xr.clamp(min=0)[lv], lim[lv])
    lf = left[lv]
    key = n[lv] * (L + 1)
    quals = _union(torch, torch.cat([key + below[0], key + after[0]]),
                   torch.cat([key + below[1], key + after[1]]))
    ck, cx = n[chk] * (L + 1), x[chk]
    reads = _union(torch, torch.cat([key + below[0], key + after[0],
                                     ck + cx]),
                   torch.cat([key + below[1], key + after[1],
                              ck + cx + I[chk]]))
    src = [torch.where(lf, b, a) for b, a in zip(below, after)]
    frs = [torch.where(lf, a, b) for b, a in zip(below, after)]
    wkey = (n * C + c)[lv] * (L + 1)
    wins = _union(torch, wkey + src[0], wkey + src[1])
    nwin = 1 if kw.get("snv1_w") is None else 3
    # the fresh runs' packed words (positions past the text read none)
    tl = min(int(kw["n_text"]), 16 * kw["ref_words"].shape[0])
    p0 = (fresh[lv] + frs[0]).clamp(0, tl)
    p1 = (fresh[lv] + frs[1]).clamp(0, tl)
    on = p1 > p0
    words = _union(torch, p0[on] // 16, (p1[on] - 1) // 16 + 1)
    nsnv = 2 if kw["snv_delta1"].numel() > 0 else 0
    by += ((reads + quals) * 4 + wins * 4 * nwin
           + words * 4 * (1 + nsnv))
    walked = int((below[1] - below[0]).clamp(min=0).sum()
                 + (after[1] - after[0]).clamp(min=0).sum())
    return by, live.numel() * 40 + walked * 30


def flat_outputs(x):
    """A kernel's outputs as a flat list of tensors (named tuples, dicts
    by sorted key, tuples; nested)."""
    if hasattr(x, "_fields"):
        return [getattr(x, f) for f in x._fields]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat_outputs(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in flat_outputs(e)]
    return [x]


def extend_groups(st):
    """Per lane of K6+K7's starts [B, C]: its count of distinct live
    starts, and 1 where it has a dead slot (start < 0).  The kernel
    evaluates each distinct (lane, start) once; every dead slot of a lane
    has start -1."""
    srt = st.sort(1).values
    first = srt.new_ones(srt.shape, dtype=bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return ((srt >= 0) & first).sum(1), (srt < 0).any(1).long()



# -- the program's plain live-slot logic, copied (see the module's note) ---

# the unified slot schema's fields, in the order of its [F, N, K] tensor
# (ops/compact.py); "event" only on indexes with known ALT indels
SLOT_FIELDS = ("score", "d1", "d2", "x", "kind", "spldir", "known", "ab",
               "post", "selfgap", "n_mm", "n_n", "clip_l", "clip_r", "alt",
               "valid", "event")
MAX_INS = 16     # longest known insertion K10 handles (ops/splice.py)


def resolve_live(torch, top, bot, lo, hi, nh, P, min_k, maxsize,
                 short_rows, lite_cap=0):
    """(hv [N, H], cval [N, H, P]): the hits that resolve and their live
    rows, by the gates of the full or the lite pass (ops/compact.py)."""
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


def research_live(torch, top2, bot2, nh2, P2):
    """(hv2 [N, H2], cval2 [N, H2, P2]) of the spliced prefix
    re-search's hits (ops/compact.py)."""
    H2 = top2.shape[1]
    w2 = bot2 - top2
    hv2 = ((torch.arange(H2, device=top2.device)[None, :] < nh2[:, None])
           & (w2 <= P2))
    j2 = torch.arange(P2, device=top2.device)
    return hv2, hv2[:, :, None] & (j2[None, None, :] < w2[:, :, None])


def indel_sweep_gap(L, W, max_gap, prm):
    """K8's gap budget G for reads of L columns in windows of W: the
    window margin, or less where max_gap (else prm.max_gap) asks
    (ops/splice.py)."""
    return int(min((W - L) // 2, max_gap if max_gap else prm.max_gap))


def indel_probes(torch, starts, valid, lens, reads, ip, ilen, ins_chars,
                 rkey, r_ilen, r_row, slots):
    """K10's probes (ops/splice.py): per injected slot [N, J] (J = 2 *
    slots * C, the left-keyed slots first, slot t*C + c the t-th event at
    or after start + 1), its junction position x, fresh diagonal, event
    row (of the left-sorted table) and signed length (+del / -ins), `okd`
    (an in-read event on a valid candidate) and `live`: okd, inside the
    read's bounds and, for an insertion, the skipped read chars equal to
    the allele."""
    i32 = torch.int32
    dev = reads.device
    N, C = starts.shape
    L = reads.shape[1]
    E = ip.shape[0]
    lens2 = lens[:, None]
    xs_, d2_, ok_, ev_, ln_ = [], [], [], [], []
    for tab, left in ((ip, True), (rkey, False)):
        lo = torch.searchsorted(tab, (starts + 1).contiguous(),
                                right=False).to(i32)
        for t in range(slots):
            idx = torch.clamp(lo + t, max=E - 1).to(torch.int64)
            okd = ((lo + t < E) & valid & (tab[idx] >= starts + 1)
                   & (tab[idx] <= starts + lens2 - 1))
            xs_.append(torch.where(okd, tab[idx] - starts, 1))
            if left:            # src diagonal LEFT; x = ip - d
                d2_.append(starts + ilen[idx])
                ev_.append(idx.to(i32))
                ln_.append(ilen[idx])
            else:               # src diagonal RIGHT; x = (ip + ilen) - d
                d2_.append(starts - r_ilen[idx])
                ev_.append(r_row[idx])
                ln_.append(r_ilen[idx])
            ok_.append(okd)
    x_all = torch.cat(xs_, dim=1).to(i32)
    event = torch.cat(ev_, dim=1).to(i32)
    elen = torch.cat(ln_, dim=1).to(i32)
    J = x_all.shape[1]
    I = torch.clamp(-elen, min=0)
    ins_ok = torch.ones((N, J), dtype=torch.bool, device=dev)
    if E > 0:
        col = torch.arange(MAX_INS, device=dev, dtype=i32)[None, None, :]
        rpos = x_all[:, :, None] + col
        rb = reads[:, None, :].expand(N, J, L).gather(
            2, torch.clamp(rpos, max=L - 1).to(torch.int64))
        ev_chars = ins_chars[torch.clamp(event, min=0).to(torch.int64)]
        need = col < I[:, :, None]
        ins_ok = torch.where(need, rb == ev_chars, True).all(dim=2)
        ins_ok = ins_ok | (elen > 0)
    okd = torch.cat(ok_, dim=1)
    live = okd & (x_all >= 1) & (x_all + I <= lens2 - 1) & ins_ok
    return dict(x=x_all, fresh=torch.cat(d2_, dim=1).to(i32), event=event,
                elen=elen, okd=okd, live=live)
