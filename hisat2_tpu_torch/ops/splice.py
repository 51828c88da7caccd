"""Diagonal windows, the indel sweep, known ALT indel injection and the
splice machinery (counterpart of hisat2_tpu/ops/splice.py).

`diag_chars_multi` launches kernel 2 (K5, csrc/ref_window.cu) on CUDA
tensors and runs `diag_chars_multi_plain` on CPU tensors: in one launch
the windows of up to two start sets (the core candidates with a margin,
the extra slots without) on up to three packed planes (the reference and,
on a graph index, the SNV planes); `diag_chars` is its one-plane,
one-set case.  `self_indel_sweep`
launches kernel 4 (csrc/indel_sweep.cu) or runs `self_indel_sweep_plain`;
`inject_indels` launches K10+K11 (csrc/inject_indels.cu, with
live_pen_prefix as warp sums over runs of columns) or runs
`inject_indels_plain`.

The spliced slice (splice.py:192-626, :1107-1331):
  pair_sweep     K13 + K14 (csrc/pair_sweep.cu): the junction pair sweep
                 (:300), its top pairs (select_pairs :1318) and the two
                 raw-argmax base pairs of the second sweeps
  second_sweep   K15 (csrc/second_sweep.cu, :1107), both base pairs of a
                 step in one launch
  inject_known   K16 (csrc/inject_known.cu, :629)
  table_searchsorted  the sorted site-table lookup (:192); on the card a
                 device function of K15 and K16 (csrc/site_search.cuh)
Each wrapper takes the windows, reads and quals (the kernels build the
penalty planes themselves and never write them to device memory), and on
a graph index K13 and K16 also the SNV-plane windows (K16 the packed SNV
planes too); its `*_ref` twin takes the same arguments, builds the planes
with ops/extend.py:pen_planes and runs the `*_plain` port of the JAX
function, line by line.  The intron-length penalty is a host-built step table
(`lenpen_table`), so that no device `logf` decides a step.

The PWM priors, `junction_prob_tables` and `probscore_host` are numpy,
copied from splice.py:42-107 (the host hybrid replay uses them).
"""

from __future__ import annotations

import ctypes
import functools
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


def diag_chars_multi_plain(planes, n_text: int, starts, margins, L: int):
    """out[s][p] = diag_chars_plain(planes[p], n_text, starts[s], L,
    margins[s]): the windows of every start set on every packed plane."""
    return [[diag_chars_plain(w, n_text, st, L, m) for w in planes]
            for st, m in zip(starts, margins)]


class _RwCall(ctypes.Structure):
    """Kernel 2's one argument, field for field csrc/ref_window.cu's
    RwCall (8 bytes each): the planes and their word counts, the counts
    of planes, text chars and start sets, then each set's starts, count,
    window width and margin and its windows on planes 0-2."""
    _fields_ = ([(f"plane{p}", ctypes.c_void_p) for p in range(3)]
                + [(f"n_words{p}", ctypes.c_longlong) for p in range(3)]
                + [(k, ctypes.c_longlong) for k in ("n_planes", "n_text",
                                                    "n_sets")]
                + [(f"{k}{s}", t) for s in range(2) for k, t in (
                    ("starts", ctypes.c_void_p), ("n", ctypes.c_longlong),
                    ("W", ctypes.c_longlong), ("margin", ctypes.c_longlong),
                    ("out0_", ctypes.c_void_p), ("out1_", ctypes.c_void_p),
                    ("out2_", ctypes.c_void_p))])


def diag_chars_multi(planes, n_text: int, starts, margins, L: int):
    """Kernel 2 (K5) on CUDA tensors, diag_chars_multi_plain on CPU
    tensors: one launch for 1-3 packed planes (the reference and, on a
    graph index, the two SNV planes) and 1-2 start sets (int32 [..., C]
    each, with its own margin); out[s][p] is int32 [..., C, L +
    2*margins[s]]."""
    if not starts[0].is_cuda:
        return diag_chars_multi_plain(planes, n_text, starts, margins, L)
    i32 = torch.int32
    P, S = len(planes), len(starts)
    if not (1 <= P <= 3 and 1 <= S <= 2 and len(margins) == S):
        raise ValueError("diag_chars_multi: 1-3 planes and 1-2 start sets")
    # _RwCall's fields in order; a second set left out stays zero
    vals = [None, None, None, 0, 0, 0, P, n_text, S]
    for p, w in enumerate(planes):
        kernels.check_cuda("planes", w, i32)
        vals[p], vals[3 + p] = w.data_ptr(), w.shape[0]
    outs = []
    for st, m in zip(starts, margins):
        kernels.check_cuda("starts", st, i32)
        W = L + 2 * m
        n = st.numel()
        if m < 0 or W < 1 or n >= 2 ** 31:
            raise ValueError("diag_chars_multi: a negative margin, an "
                             "empty window or 2^31 starts in one set")
        shape = (*st.shape, W)
        if P > 1 and n * W % 4 == 0:
            # one allocation for the set's planes: each window still
            # starts 16-byte aligned, as the kernel's stores need
            row = list(torch.empty((P, *shape), dtype=i32,
                                   device=st.device).unbind(0))
        else:
            row = [torch.empty(shape, dtype=i32, device=st.device)
                   for _ in planes]
        outs.append(row)
        vals += [st.data_ptr(), n, W, m, *(o.data_ptr() for o in row)]
        vals += [None] * (3 - P)
    kernels.KERNELS["ref_window"].launch(
        ctypes.byref(_RwCall(*vals)), stream=kernels.stream_of(starts[0]))
    return outs


def diag_chars(ref_words, n_text: int, starts, L: int, margin: int):
    """diag_chars_multi's one-plane, one-set case: kernel 2 on CUDA
    tensors, diag_chars_plain on CPU tensors."""
    return diag_chars_multi([ref_words], n_text, [starts], [margin], L)[0][0]


def _sweep_meta(G):
    """cid -> (o1, o2, kind) for the 4 combos of every g = 1..G, plus the
    'none' entry at index 4G (splice.py:1040-1083)."""
    o1, o2, kd = [], [], []
    for g in range(1, G + 1):
        o1 += [-g, 0, g, 0]
        o2 += [0, g, 0, -g]
        kd += [KIND_DEL, KIND_DEL, KIND_INS, KIND_INS]
    return o1 + [0], o2 + [0], kd + [0]


def indel_sweep_gap(L: int, W: int, max_gap, prm: SpliceParams) -> int:
    """Kernel 4's gap budget G for reads of L columns in windows of W: the
    window margin, or less where max_gap (else prm.max_gap) asks."""
    return int(min((W - L) // 2, max_gap if max_gap else prm.max_gap))


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
    G = indel_sweep_gap(L, W, max_gap, prm)
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
            # JAX packs in int32: past G = 16 a saturated key wraps
            # negative (and decodes as a +524288 row), so wrap it too
            packed = ((packed + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31
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


def _indel_sweep_scratch(L: int, W: int, G: int, snv: bool, NC: int, dev):
    """K8's global staging at these shapes (csrc/indel_sweep.cu:
    h2_indel_sweep_scratch): None where its warps stage in shared memory,
    else the buffer the kernel asks for."""
    return kernels.scratch("h2_indel_sweep_scratch",
                           [ctypes.c_int] * 4 + [ctypes.c_longlong], L, W, G,
                           int(snv), NC, dev=dev)


def self_indel_sweep(ch, reads, quals, lens, starts, valid, minsc, mm_pen,
                     n_pen: int, prm: SpliceParams, max_gap: int = None,
                     snv1_w=None, snv2_w=None):
    """Kernel 4 on CUDA tensors, self_indel_sweep_plain on CPU tensors.
    Dead candidates get their constant row without a sweep; the kernel's
    shared memory is O(L) per warp, so every gap budget launches, and
    where one warp's buffers outgrow a block's shared memory (reads above
    ~5,800 bp) it stages them in a global scratch allocated here."""
    if not ch.is_cuda:
        return self_indel_sweep_plain(ch, reads, quals, lens, starts, valid,
                                      minsc, mm_pen, n_pen, prm, max_gap,
                                      snv1_w, snv2_w)
    i32 = torch.int32
    N, C, W = ch.shape
    L = reads.shape[1]
    G = indel_sweep_gap(L, W, max_gap, prm)
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
    dev = ch.device
    res = torch.empty((10, N, C), dtype=i32, device=dev)
    scratch = _indel_sweep_scratch(L, W, G, use_snv, N * C, dev)
    kernels.KERNELS["indel_sweep"].launch(
        ch.data_ptr(), reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), minsc.data_ptr(),
        mm_pen.data_ptr(), N * C, C, L, W, G, n_pen, prm.min_anchor,
        prm.rd_gap_open, prm.rd_gap_ext, prm.rf_gap_open, prm.rf_gap_ext,
        res.data_ptr(), (snv1_w if use_snv else ch).data_ptr(),
        (snv2_w if use_snv else ch).data_ptr(), int(use_snv),
        *kernels.scratch_args(scratch), stream=kernels.stream_of(ch))
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


def indel_probes(starts, valid, lens, reads, ip, ilen, ins_chars, rkey,
                 r_ilen, r_row, slots: int):
    """K10's probes (splice.py:874-944 up to the prefix scalars): per
    injected slot [N, J] (J = 2 * slots * C, the left-keyed slots first,
    slot t*C + c the t-th event at or after start + 1), its junction
    position x, fresh diagonal, event row (of the left-sorted table) and
    signed length (+del / -ins), `okd` (an in-read event on a valid
    candidate) and `live`: okd, inside the read's bounds and, for an
    insertion, the skipped read chars equal to the allele.  Only the live
    slots walk the read, and only they can score."""
    i32 = torch.int32
    dev = reads.device
    N, C = starts.shape
    L = reads.shape[1]
    E = ip.shape[0]
    lens2 = lens[:, None]
    xs_, d2_, ok_, ev_, ln_ = [], [], [], [], []
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
    x_all = torch.cat(xs_, dim=1).to(i32)
    event = torch.cat(ev_, dim=1).to(i32)
    elen = torch.cat(ln_, dim=1).to(i32)      # +del / -ins
    J = x_all.shape[1]
    I = torch.clamp(-elen, min=0)
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
    okd = torch.cat(ok_, dim=1)
    live = okd & (x_all >= 1) & (x_all + I <= lens2 - 1) & ins_ok
    return dict(x=x_all, fresh=torch.cat(d2_, dim=1).to(i32), event=event,
                elen=elen, okd=okd, live=live)


def inject_indels_plain(ref_words, n_text: int, reads, quals, lens, starts,
                        valid, ch, snv1_w, snv2_w, margin: int, ip, ilen,
                        ins_chars, rkey, r_ilen, r_row, mm_pen, n_pen: int,
                        minsc, snv_delta1, snv_delta2, slots: int = 2):
    """Plain torch twin of K10+K11: splice.py:838 inject_indels, line by
    line (its probes in indel_probes), after building the source
    diagonals' SNV-forgiving penalty prefixes P_snv [N, C, L+1] / tot_snv
    [N, C] from their windows, as pipeline.py:1143-1145 does from the
    pen_planes."""
    from . import extend as extend_ops
    i32 = torch.int32
    dev = reads.device
    N, C = starts.shape
    L = reads.shape[1]
    planes = extend_ops.pen_planes(
        n_text, reads, quals, lens, torch.where(valid, starts, -1), mm_pen,
        n_pen, ch, margin, snv1_w, snv2_w)
    zero3 = torch.zeros((N, C, 1), dtype=i32, device=dev)
    P_snv = torch.cat([zero3, torch.cumsum(planes.pen, 2).to(i32)], 2)
    tot_snv = compact_ops.take_last(P_snv, lens[:, None].expand(N, C))
    pr = indel_probes(starts, valid, lens, reads, ip, ilen, ins_chars, rkey,
                      r_ilen, r_row, slots)
    x_all, fresh, event, elen = pr["x"], pr["fresh"], pr["event"], pr["elen"]
    J = x_all.shape[1]
    src = torch.arange(C, device=dev, dtype=i32)[None, :].repeat(
        N, 2 * slots)
    is_left = torch.arange(J, device=dev)[None, :] < C * slots
    I = torch.clamp(-elen, min=0)

    # prefix scalars of the fresh-diagonal planes over LIVE columns only
    # (left side uses the prefix at x, right side at x + inslen)
    xr = torch.clamp(x_all + I, max=L)
    tot_f, _, ppfx = extend_ops.live_pen_prefix_plain(
        ref_words, n_text, reads, quals, lens, mm_pen, n_pen,
        fresh, pr["okd"], [x_all, xr],
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

    ok_all = pr["live"] & (score >= minsc[:, None])
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


def _inject_indels_out(N: int, J: int, dev):
    """K10's output planes [9, N, J]: score d1 d2 x kind event src spldir
    splscore (the kernel writes every plane)."""
    return torch.empty((9, N, J), dtype=torch.int32, device=dev)


def inject_indels(ref_words, n_text: int, reads, quals, lens, starts, valid,
                  ch, snv1_w, snv2_w, margin: int, ip, ilen, ins_chars, rkey,
                  r_ilen, r_row, mm_pen, n_pen: int, minsc, snv_delta1,
                  snv_delta2, slots: int = 2):
    """K10+K11 (csrc/inject_indels.cu) on CUDA tensors,
    inject_indels_plain on CPU tensors.  starts/valid: the core
    candidates [N, C]; ch, snv1_w, snv2_w: their windows (diag_chars with
    margin); ip .. r_row: the padded indel event tables
    (index/format.py:graph_to_device)."""
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
    res = _inject_indels_out(N, J, reads.device)
    kernels.KERNELS["inject_indels"].launch(
        ref_words.data_ptr(), snv_delta1.data_ptr(), snv_delta2.data_ptr(),
        reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), ch.data_ptr(),
        snv1_w.data_ptr(), snv2_w.data_ptr(), ip.data_ptr(), ilen.data_ptr(),
        ins_chars.data_ptr(), rkey.data_ptr(), r_ilen.data_ptr(),
        r_row.data_ptr(), mm_pen.data_ptr(), minsc.data_ptr(), n_text,
        ref_words.shape[0], snv_delta1.shape[0], N, C, L, W, margin, E,
        slots, n_pen, *(res[i].data_ptr() for i in range(9)),
        stream=kernels.stream_of(reads))
    out = dict(zip(("score", "d1", "d2", "x", "kind", "event", "src",
                    "spldir"), res[:8].unbind(0)))
    out["splscore"] = res[8].view(torch.float32)
    return out


# ---------------------------------------------------------------------------
# The spliced slice: site tables, the junction pair sweep (K13 + K14), the
# second-junction sweep (K15) and known/temp splice-site injection (K16).

# bucket-index geometry for the sorted site tables (splice.py:181-189):
# NB bins of 2^shift joined bases each; lob[b] = first table row with key
# >= b << shift, and a query binary-searches its bin's span in SS_SB steps
SS_NBINS = 1 << 19
SS_SB = 12
SS_MERGE_HEADROOM = 1024

# per-position PWM factors, table[kmer] = prod_j BACKGROUND[b_j]/PROB[b_j, j]
# (splice.py:218-219)
_F_DONOR = (_BACKGROUND[:, None] / _DONOR_PROB).astype(np.float32)  # [4, 9]
_F_ACC = (_BACKGROUND[:, None] / _ACC_PROB).astype(np.float32)      # [4,15]
# the same factors as one f32 vector for the kernels: donor [4, 9], then
# acceptor [4, 15], row-major
PWM_FACTORS = np.concatenate([_F_DONOR.reshape(-1), _F_ACC.reshape(-1)])

_F32 = torch.float32
_PTH = (0.99, 0.97, 0.94, 0.91, 0.88, 0.8)


def table_searchsorted(tab, q, lob=None, shift=None):
    """searchsorted(tab, q, side='left'), bucket-accelerated when a bucket
    index (lob [SS_NBINS + 1], shift an int) is given (splice.py:192).
    The plain version of csrc/site_search.cuh."""
    if lob is None:
        return torch.searchsorted(tab, q.contiguous()).to(torch.int32)
    NB = lob.shape[0] - 1
    b = torch.clamp(q >> int(shift), 0, NB - 1).to(torch.int64)
    lo = lob[b]
    hi = lob[b + 1]
    Sm1 = tab.shape[0] - 1
    for _ in range(SS_SB):
        mid = (lo + hi) >> 1
        v = tab[torch.clamp(mid, 0, Sm1).to(torch.int64)]
        act = lo < hi
        go = v < q
        lo = torch.where(act & go, mid + 1, lo)
        hi = torch.where(act & ~go, mid, hi)
    return lo.to(torch.int32)


def lenpen_table(const: float, coef: float, max_d: int):
    """The intron-length penalty trunc(max(0, const + coef * ln D)) over
    D = 1..max_d as a step table (breakpoints, values), int32.

    JAX evaluates it in f32 with its own `log` (splice.py:614-619); a
    device `logf` can sit one ulp off it, which moves a step (at D =
    442,413 the f32 log is one ulp under 13).  So the steps are found once
    on the host, from the correctly rounded log, and the sweeps look D up
    in them; tests/test_torch_splice_sites.py holds the table against JAX
    for every D in [20, 500000]."""
    d = np.arange(1, max(int(max_d), 1) + 1, dtype=np.float64)
    logd = np.log(d).astype(np.float32)
    v = (np.float32(const) + np.float32(coef) * logd).astype(np.int32)
    v = np.maximum(v, 0)
    brk = np.concatenate([[0], np.flatnonzero(np.diff(v)) + 1])
    return (d[brk].astype(np.int32), v[brk].astype(np.int32))


def lenpen_lookup(D, tab):
    """lenpen of int32 D under a lenpen_table (D < 1 reads D = 1, as
    JAX's max(D, 1))."""
    brk, val = tab
    i = torch.searchsorted(brk, D.contiguous(), right=True) - 1
    return torch.where(i >= 0, val[torch.clamp(i, min=0)], val[0])


def max_intron_len(anchor, min_anchor):
    """MaxIntronLen (splice.py:110)."""
    a = torch.clamp(anchor, min=2)
    shift = torch.clamp((a << 1) - 4, 13, 30)
    return torch.where(anchor >= min_anchor, torch.ones_like(a) << shift, 0)


def max_intron_len_noncan(anchor, min_anchor):
    """MaxIntronLen_noncan (splice.py:118)."""
    a = torch.clamp(anchor, min=5)
    shift = torch.clamp((a << 1) - 10, max=30)
    return torch.where(anchor >= min_anchor, torch.ones_like(a) << shift, 0)


def _intron_len_prob(anchor, intron_len, max_intron, cut, add):
    """intronLen_prob (splice.py:125, cut 14, add 4) and its noncanonical
    twin (:135, cut 16, add 0).  Negative shifts (anchors of dead pairs)
    read as JAX's: a shift outside [0, 32) gives 0."""
    sh = torch.clamp((anchor << 1) + add, max=30)
    one = torch.ones_like(anchor)
    p2 = torch.where(sh >= 0, one << torch.clamp(sh, min=0), 0)
    exp_len = torch.where(anchor < cut, p2, max_intron)
    exp_len = torch.clamp(exp_len, max=max_intron)
    return torch.clamp(intron_len.to(_F32) / exp_len.to(_F32),
                       max=torch.tensor(1.0, dtype=_F32,
                                        device=anchor.device))


def _pwm_prod(ch, M, offs, fmat, rc=False, out_len=None):
    """splice.py:222 line by line: the product of the PWM factors over a
    rolling window, t ascending."""
    L1 = out_len if out_len is not None else ch.shape[2] - 2 * M
    k = len(offs)
    fm = torch.from_numpy(fmat).to(ch.device)
    acc = None
    for t, off in enumerate(offs):
        c = ch[:, :, M + off:M + off + L1]
        c = torch.where(c > 3, 0, c)
        if rc:
            c = 3 - c
            f = fm[:, k - 1 - t]
        else:
            f = fm[:, t]
        term = f[c.to(torch.int64)]
        acc = term if acc is None else acc * term
    return acc


def _pwm_planes(ch, M, L):
    """(dsum_fw, dsum_rc, asum_fw, asum_rc) at every x (splice.py:246)."""
    return (_pwm_prod(ch, M, range(-3, 6), _F_DONOR, out_len=L + 1),
            _pwm_prod(ch, M, range(-6, 3), _F_DONOR, rc=True, out_len=L + 1),
            _pwm_prod(ch, M, range(-14, 1), _F_ACC, out_len=L + 1),
            _pwm_prod(ch, M, range(-1, 14), _F_ACC, rc=True, out_len=L + 1))


def _codes(ch, M, L):
    """(dcode, acode) [N, C, L+1]: the donor / acceptor dinucleotides."""
    d0 = ch[:, :, M:M + L + 1]
    d1 = ch[:, :, M + 1:M + L + 2]
    a0 = ch[:, :, M - 2:M - 2 + L + 1]
    a1 = ch[:, :, M - 1:M - 1 + L + 1]
    dcode = torch.where((d0 < 4) & (d1 < 4), d0 * 16 + d1, 255)
    acode = torch.where((a0 < 4) & (a1 < 4), a0 * 16 + a1, 255)
    return dcode, acode


def _classify(dl, ar):
    """(spldir, canonical) from the donor / acceptor codes (hi_aligner.h
    :1454-1458 constants, splice.py:1146)."""
    can_fw = (dl == 0x23) & (ar == 0x02)
    can_rc = (dl == 0x13) & (ar == 0x01)
    semi_fw = ((dl == 0x21) & (ar == 0x02)) | ((dl == 0x03) & (ar == 0x01))
    semi_rc = ((dl == 0x13) & (ar == 0x21)) | ((dl == 0x20) & (ar == 0x03))
    spldir = torch.where(
        can_fw, SPL_FW, torch.where(
            can_rc, SPL_RC, torch.where(
                semi_fw, SPL_SEMI_FW,
                torch.where(semi_rc, SPL_SEMI_RC, SPL_UNKNOWN))))
    return spldir.to(torch.int32), can_fw | can_rc


def _pth(D):
    """The PWM probability threshold by intron length (splice.py:602)."""
    t = torch.tensor(_PTH, dtype=_F32, device=D.device)
    return torch.where(D >= (1 << 16), t[0], torch.where(
        D >= (1 << 15), t[1], torch.where(
            D >= (1 << 14), t[2], torch.where(
                D >= (1 << 13), t[3], torch.where(D >= (1 << 12), t[4],
                                                  t[5])))))


def _prefix(plane, lens):
    """[N, C, L] int plane -> (prefix [N, C, L+1] int32, total at lens)."""
    N, C, _ = plane.shape
    z = torch.zeros((N, C, 1), dtype=torch.int32, device=plane.device)
    P = torch.cat([z, torch.cumsum(plane.to(torch.int32), 2).to(torch.int32)],
                  2)
    return P, compact_ops.take_last(P, lens[:, None].expand(N, C))


def _pad_cols(P, tot, pad):
    N, C, _ = P.shape
    return torch.cat([P, tot[:, :, None].expand(N, C, pad)], 2)


def pair_sweep_plain(ch, pen_spl, pen_ind, ismm, starts, valid, lens, minsc,
                     prm: SpliceParams, lp_can, lp_nc, max_gap: int = None,
                     chunk: int = 256):
    """Plain twin of K13 (splice.py:300 pair_sweep, spliced branch).

    The JAX sweep scans x in blocks of 32 and folds each block's best into
    a carry with the order (dir-and-score key desc, PWM probability desc,
    tie key asc); that order is lexicographic, so here every x is taken at
    once.  The x range is 0..L+1: the JAX blocks reach past L, and a dead
    indel pair can take x = L+1 (its padded columns tie every suffix to
    0), which no later column can beat.  lp_can / lp_nc: lenpen_table of
    the canonical / noncanonical penalty.  Lanes go `chunk` at a time to
    bound the [n, C, C, L+2] temporaries.  Returns the PairResult fields
    as a dict of [N, C, C] tensors."""
    assert prm.allow_spliced
    N = pen_spl.shape[0]
    parts = [_pair_sweep_lanes(
        ch[a:a + chunk], pen_spl[a:a + chunk], pen_ind[a:a + chunk],
        ismm[a:a + chunk], starts[a:a + chunk], valid[a:a + chunk],
        lens[a:a + chunk], minsc[a:a + chunk], prm, lp_can, lp_nc, max_gap)
        for a in range(0, N, chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _pair_sweep_lanes(ch, pen_spl, pen_ind, ismm, starts, valid, lens,
                      minsc, prm, lp_can, lp_nc, max_gap):
    i32 = torch.int32
    dev = ch.device
    N, C, L = pen_spl.shape
    M = (ch.shape[2] - L) // 2
    gcap = max_gap if max_gap else prm.max_gap
    V = min(prm.max_gap, L - 1, gcap)
    X = L + 2                       # x = 0..L+1
    pad = V + 1
    Ps, tot_s = _prefix(pen_spl, lens)
    Pi, tot_i = _prefix(pen_ind, lens)
    Pm, tot_m = _prefix(ismm, lens)
    Pr, tot_r = _prefix(pen_spl > 0, lens)
    Pi_p, Ps_p, Pr_p = (_pad_cols(P, t, pad) for P, t in
                        ((Pi, tot_i), (Ps, tot_s), (Pr, tot_r)))
    SSi = tot_i[:, :, None] - Pi_p
    SSs = tot_s[:, :, None] - Ps_p
    SSr = tot_r[:, :, None] - Pr_p
    dcode, acode = _codes(ch, M, L)
    dsum_fw, dsum_rc, asum_fw, asum_rc = _pwm_planes(ch, M, L)
    # budget-scan base planes (splice.py:389-419)
    mmc = pen_spl > 0
    colL = torch.arange(L, device=dev, dtype=i32)[None, None, :]
    lastmm = torch.cummax(torch.where(mmc, colL, -1), 2).values
    nxt = torch.cummax(torch.where(mmc.flip(2), colL, -1), 2).values.flip(2)
    nextmm = torch.where(nxt >= 0, (L - 1) - nxt, L)
    runlen = nextmm - (lastmm + 1)
    qual_col = ~mmc & (runlen >= 8)
    PsL = Ps[:, :, :L]
    SSsL = tot_s[:, :, None] - PsL
    z3 = torch.zeros((N, C, 1), dtype=i32, device=dev)
    base_l = torch.cat([z3, torch.cummax(torch.where(qual_col, PsL, 0),
                                         2).values], 2)
    base_r = torch.cat([torch.cummax(torch.where(qual_col, SSsL, 0).flip(2),
                                     2).values.flip(2), z3], 2)
    # the planes past x = L (only x = L+1 is read): totals / 0 / no motif
    ext = lambda P: torch.cat([P, P[:, :, -1:]], 2)  # noqa: E731
    base_l, base_r = ext(base_l), ext(base_r)
    zf = torch.zeros((N, C, 1), dtype=_F32, device=dev)
    zc = torch.full((N, C, 1), 255, dtype=i32, device=dev)
    dcode_x, acode_x = torch.cat([dcode, zc], 2), torch.cat([acode, zc], 2)
    dsf, dsr, asf, asr = (torch.cat([p, zf], 2) for p in
                          (dsum_fw, dsum_rc, asum_fw, asum_rc))

    D = starts[:, None, :] - starts[:, :, None]                  # [N, i, j]
    is_spl = (D >= prm.min_intron) & (D <= prm.max_intron)
    is_del = (D >= 1) & (D < prm.min_intron)
    is_ins = (D <= -1) & (D >= -gcap)
    pmask = valid[:, :, None] & valid[:, None, :] & (is_spl | is_del | is_ins)
    I = torch.clamp(-D, min=0)
    gap_pen = torch.where(is_del, prm.rd_gap_open + prm.rd_gap_ext * D,
                          torch.where(is_ins,
                                      prm.rf_gap_open + prm.rf_gap_ext * (-D),
                                      0))
    xs = torch.arange(X, device=dev, dtype=i32)
    x4 = xs[None, None, None, :]
    lens4 = lens[:, None, None, None]
    vx = (x4 >= 1) & (x4 + I[..., None] <= lens4 - 1) & (x4 <= L)

    def li(P):                       # left diagonal i at x: [N, C, 1, X]
        return P[:, :, None, :X]

    def rj(P, off=0):                # right diagonal j at x + off
        return P[:, None, :, off:off + X]

    Pl_i, Pl_r = li(Pi_p), li(Pr_p)
    score_ind = -(Pl_i + rj(SSi))
    raw4 = Pl_r + rj(SSr)
    for v in range(1, V + 1):
        isv = (is_ins & (I == v))[..., None]
        score_ind = torch.where(isv, -(Pl_i + rj(SSi, v)), score_ind)
        raw4 = torch.where(isv, Pl_r + rj(SSr, v), raw4)
    score_ind = score_ind - gap_pen[..., None]
    lp4 = li(Ps_p)
    rp4 = rj(SSs)
    s_spl = -(lp4 + rp4)
    m4 = minsc[:, None, None, None]
    budget4 = ((lp4 - li(base_l) <= -m4) & (rp4 - rj(base_r) <= -m4))
    dl = li(dcode_x)
    ar = rj(acode_x)
    can_fw = (dl == 0x23) & (ar == 0x02)
    can_rc = (dl == 0x13) & (ar == 0x01)
    semi_fw = ((dl == 0x21) & (ar == 0x02)) | ((dl == 0x03) & (ar == 0x01))
    semi_rc = ((dl == 0x13) & (ar == 0x21)) | ((dl == 0x20) & (ar == 0x03))
    canonical = can_fw | can_rc
    has_dir = canonical | semi_fw | semi_rc
    prod = torch.where(can_fw, li(dsf) * rj(asf), rj(dsr) * li(asr))
    one = torch.tensor(1.0, dtype=_F32, device=dev)
    splsc = torch.where(canonical, one / (one + prod),
                        torch.zeros((), dtype=_F32, device=dev))
    sp4 = is_spl[..., None]
    score = torch.where(
        sp4, s_spl - torch.where(canonical, prm.pen_can, prm.pen_noncan),
        score_ind)
    hd = (sp4 & has_dir).to(i32)
    ssc = torch.where(sp4, splsc, torch.zeros((), dtype=_F32, device=dev))
    valid4 = vx & pmask[..., None] & (~sp4 | budget4)
    k1 = torch.where(valid4, (hd << 23) + torch.clamp(score, min=-(2 ** 21))
                     + 2 ** 21, -1)
    m1 = k1.max(3).values
    tie1 = k1 == m1[..., None]
    neg1 = torch.tensor(-1.0, dtype=_F32, device=dev)
    sv = torch.where(tie1, ssc, neg1)
    s2 = sv.max(3).values
    tie2 = tie1 & (sv == s2[..., None])
    tkey4 = torch.where(sp4, x4.expand_as(raw4), raw4 * (L + 2) + x4)
    xtk = torch.where(tie2, tkey4, _BIG).min(3).values
    bx = torch.where(is_spl, xtk, xtk % (L + 2)).to(i32)
    bs = torch.where(m1 >= 0, (m1 & ((1 << 23) - 1)) - 2 ** 21, -_BIG)
    bp = torch.clamp(s2, min=torch.tensor(0.0, dtype=_F32, device=dev))

    # spldir / kind at the chosen x (0 codes past x = L, as the one-hot
    # take of splice.py:286-297 gives)
    def take_i(P, x):                # P[n, i, x], 0 out of range
        W_ = P.shape[2]
        ok = x < W_
        g = P[:, :, None, :].expand(N, C, C, W_).gather(
            3, torch.clamp(x, max=W_ - 1)[..., None].to(torch.int64))[..., 0]
        return torch.where(ok, g, 0)

    def take_j(P, x):                # P[n, j, x]
        W_ = P.shape[2]
        ok = x < W_
        g = P[:, None, :, :].expand(N, C, C, W_).gather(
            3, torch.clamp(x, max=W_ - 1)[..., None].to(torch.int64))[..., 0]
        return torch.where(ok, g, 0)

    spldir, canonical = _classify(take_i(dcode, bx), take_j(acode, bx))
    spldir = torch.where(is_spl, spldir, SPL_UNKNOWN).to(i32)
    canonical = (spldir == SPL_FW) | (spldir == SPL_RC)
    kind = torch.where(is_spl, KIND_SPL, torch.where(
        is_del, KIND_DEL, torch.where(is_ins, KIND_INS, KIND_NONE))).to(i32)
    lens2 = lens[:, None, None]
    x = bx
    mm_l = take_i(Pm, x)
    xr = torch.clamp(x + I, max=L)
    mm_r = tot_m[:, None, :] - take_j(Pm, xr)
    ok = bs > -_BIG // 2
    shorter_raw = torch.minimum(x, lens2 - x)
    thr = torch.tensor(0.01, dtype=_F32, device=dev)
    pre_can = (shorter_raw < prm.min_anchor) & (_intron_len_prob(
        shorter_raw, D, prm.max_intron, 14, 4) > thr)
    pre_non = (shorter_raw < prm.min_anchor_noncan) & (_intron_len_prob(
        shorter_raw, D, prm.max_intron, 16, 0) > thr)
    spl_ok = torch.where(canonical, ~pre_can, ~pre_non)
    adj_l = x - 2 * mm_l
    adj_r = (lens2 - x) - 2 * mm_r
    shorter = torch.clamp(torch.minimum(adj_l, adj_r), min=1)
    thresh = torch.where(canonical,
                         max_intron_len(shorter, prm.min_anchor),
                         max_intron_len_noncan(shorter, prm.min_anchor_noncan))
    gated = thresh < prm.max_intron
    spl_ok = spl_ok & ~(gated & (D > thresh))
    spl_ok = spl_ok & ~(gated & canonical & (bp < _pth(D)))
    mm_short = torch.where(adj_l <= adj_r, mm_l, mm_r)
    spl_ok = spl_ok & ~(gated & (mm_short > 0))
    lenpen = torch.where(canonical, lenpen_lookup(D, lp_can),
                         lenpen_lookup(D, lp_nc))
    score = torch.where(kind == KIND_SPL, bs - lenpen, bs)
    ok = ok & torch.where(kind == KIND_SPL, spl_ok, True)
    raw = torch.where(ok, score, -_BIG)
    ok = ok & (score >= minsc[:, None, None])
    score = torch.where(ok, score, -_BIG)
    return dict(score=score.to(i32), x=x, kind=kind, spldir=spldir,
                splscore=bp, raw=raw.to(i32))


def select_pairs_plain(res, starts, top: int = 4):
    """Plain twin of K14 (splice.py:1318): the `top` best of the C*C pair
    scores per lane, ties to the lower flat index (lax.top_k's order)."""
    N, C, _ = res["score"].shape
    flat = res["score"].reshape(N, C * C)
    idx = torch.sort(flat, dim=1, descending=True, stable=True).indices[
        :, :top]
    i = (idx // C).to(torch.int32)
    j = (idx % C).to(torch.int32)
    g = lambda a: a.reshape(N, C * C).gather(1, idx)  # noqa: E731
    return dict(score=g(res["score"]), i=i, j=j,
                d1=starts.gather(1, i.to(torch.int64)),
                d2=starts.gather(1, j.to(torch.int64)),
                x=g(res["x"]), kind=g(res["kind"]),
                spldir=g(res["spldir"]), splscore=g(res["splscore"]))


def raw_base_pairs(raw):
    """The two base pairs of the second-junction sweeps
    (pipeline.py:1389-1396): the first argmax of the raw pair scores, then
    the first argmax with that pair masked to -2^30.  [N, 2] flat ids."""
    N = raw.shape[0]
    rawf = raw.reshape(N, -1)
    b0 = rawf.argmax(1)              # torch: the first maximum, as jnp
    rawf = rawf.scatter(1, b0[:, None], -(2 ** 30))
    return torch.stack([b0, rawf.argmax(1)], 1).to(torch.int32)


def second_sweep_plain(ch, pen_spl, mm_raw, starts, valid, lens, minsc,
                       prm: SpliceParams, lp_can, lp_nc, b_i, b_j, b_x,
                       b_score, b_valid, ss=None, rdids=None):
    """Plain twin of K15 (splice.py:1107 second_sweep, line by line; the
    intron-length penalty through the lenpen tables).  ss: the site
    tables of SpliceSiteDB.device_tables.  Returns {"right": {...},
    "left": {...}}, each with score/d/x/dir and the ungated uscore/ud/ux/
    udir, [N]."""
    i32 = torch.int32
    dev = ch.device
    N, C, L = pen_spl.shape
    M = (ch.shape[2] - L) // 2
    Ps, tot = _prefix(pen_spl, lens)
    Pm, tot_m = _prefix(mm_raw, lens)
    dcode, acode = _codes(ch, M, L)
    dsum_fw, dsum_rc, asum_fw, asum_rc = _pwm_planes(ch, M, L)
    ar_n = torch.arange(N, device=dev)
    bi64, bj64 = b_i.to(torch.int64), b_j.to(torch.int64)

    def row(a, idx):
        return a[ar_n, idx]

    def at_x(a, x):                  # a[n, x] with JAX's int fill out of range
        ok = (x >= 0) & (x < a.shape[1])
        g = a.gather(1, torch.clamp(x, 0, a.shape[1] - 1)[:, None]
                     .to(torch.int64))[:, 0]
        return torch.where(ok, g, -2 ** 31)

    xs = torch.arange(L + 1, device=dev, dtype=i32)[None, None, :]
    xs1 = xs[:, 0]
    lens4 = lens[:, None, None]
    one = torch.tensor(1.0, dtype=_F32, device=dev)
    zf = torch.zeros((), dtype=_F32, device=dev)
    outs = {}
    for side in ("right", "left"):
        if side == "right":
            inner = bj64
            tot_in = tot[ar_n, inner]
            Pc = row(Ps, inner)[:, None, :] - (b_score + tot_in)[:, None, None]
            Sd = tot[:, :, None] - Ps
            score = -(Pc + Sd)
            dl = row(dcode, inner)[:, None, :]
            ar = acode
            dsf, dsr = row(dsum_fw, inner)[:, None, :], dsum_rc
            asf, asr = asum_fw, row(asum_rc, inner)[:, None, :]
            D = starts - starts[ar_n, inner][:, None]
            vx = (xs > b_x[:, None, None]) & (xs <= lens4 - 1)
            mm_in = row(Pm, inner)
            anchor_l = (xs - b_x[:, None, None]) - 2 * (
                mm_in[:, None, :] - at_x(mm_in, b_x)[:, None, None])
            anchor_r = (lens4 - xs) - 2 * (tot_m[:, :, None] - Pm)
        else:
            inner = bi64
            Sc = -(b_score[:, None, None] + row(Ps, inner)[:, None, :])
            score = -(Ps + Sc)
            dl = dcode
            ar = row(acode, inner)[:, None, :]
            dsf, dsr = dsum_fw, row(dsum_rc, inner)[:, None, :]
            asf, asr = row(asum_fw, inner)[:, None, :], asum_rc
            D = starts[ar_n, inner][:, None] - starts
            vx = (xs >= 1) & (xs < b_x[:, None, None])
            anchor_l = xs - 2 * Pm
            in_mm = row(Pm, inner)
            anchor_r = (b_x[:, None, None] - xs) - 2 * (
                at_x(in_mm, b_x)[:, None, None] - in_mm[:, None, :])
        spldir4, canonical = _classify(dl, ar)
        is_spl2 = ((D >= prm.min_intron) & (D <= prm.max_intron) & valid
                   & b_valid[:, None])
        pen2 = torch.where(canonical, prm.pen_can, prm.pen_noncan)
        prod = torch.where((dl == 0x23) & (ar == 0x02), dsf * asf, dsr * asr)
        splsc = torch.where(canonical, one / (one + prod), zf)
        known4 = torch.zeros((N, 1, L + 1), dtype=torch.bool, device=dev)
        if ss is not None:
            inner_start = starts[ar_n, inner][:, None]            # [N, 1]
            if side == "right":
                kt, vt, rt, lob = "ss_kd", "ss_ka", "ss_rdid", "ss_kd_lob"
                pos = inner_start + xs1 - 1
                tgt = starts[:, :, None] + xs1[None, :, :]
            else:
                kt, vt, rt, lob = "ss_ka_s", "ss_kd_s", "ss_rdid_a", \
                    "ss_ka_lob"
                pos = inner_start + xs1
                tgt = starts[:, :, None] + xs1[None, :, :] - 1
            S = ss[kt].shape[0]
            lo = table_searchsorted(ss[kt], pos, ss.get(lob),
                                    ss.get("ss_shift"))
            known_c = torch.zeros((N, C, L + 1), dtype=torch.bool,
                                  device=dev)
            for t in range(2):
                ii = torch.clamp(lo + t, max=S - 1).to(torch.int64)
                m = (lo + t < S) & (ss[kt][ii] == pos)
                if rdids is not None:
                    srd = ss[rt][ii]
                    m = m & ((srd < 0) | (srd < rdids[:, None]))
                known_c = known_c | (m[:, None, :]
                                     & (ss[vt][ii][:, None, :] == tgt))
            known4 = known_c
        pen2 = torch.where(known4, 0, pen2)
        sc2 = score - pen2
        valid4 = vx & is_spl2[:, :, None]
        sh = torch.clamp(torch.minimum(anchor_l, anchor_r), min=1)
        thresh = torch.where(canonical, max_intron_len(sh, prm.min_anchor),
                             max_intron_len_noncan(sh, prm.min_anchor_noncan))
        gated = thresh < prm.max_intron
        D3 = D[:, :, None]
        ok4 = valid4 & (known4 | (~(gated & (D3 > thresh))
                                  & ~(gated & canonical
                                      & (splsc < _pth(D3)))))
        lenpen = torch.where(canonical, lenpen_lookup(D3, lp_can),
                             lenpen_lookup(D3, lp_nc))
        lenpen = torch.where(known4, 0, lenpen)
        sc2u = torch.where(ok4, sc2 - lenpen, -_BIG)
        sc2 = torch.where(sc2u >= minsc[:, None, None], sc2u, -_BIG)

        def fold(scv, pfx):
            hd = (spldir4 != SPL_UNKNOWN).to(i32)
            k1 = torch.where(scv > -_BIG // 2,
                             (hd << 23) + torch.clamp(scv, min=-(2 ** 21))
                             + 2 ** 21, -1)
            flat = k1.reshape(N, -1)
            m1 = flat.max(1).values
            tie = flat == m1[:, None]
            sflat = torch.where(tie, splsc.expand(N, C, L + 1).reshape(N, -1),
                                torch.tensor(-1.0, dtype=_F32, device=dev))
            s2b = sflat.max(1).values
            tie2 = tie & (sflat == s2b[:, None])
            F = flat.shape[1]
            pick = torch.where(tie2, torch.arange(F, device=dev)[None, :],
                               _BIG).min(1).values
            c_pick = torch.clamp(pick // (L + 1), max=C - 1)
            x_pick = pick % (L + 1)
            dirflat = spldir4.expand(N, C, L + 1).reshape(N, -1)
            return {
                pfx + "score": torch.where(
                    m1 >= 0, (m1 & ((1 << 23) - 1)) - 2 ** 21,
                    -_BIG).to(i32),
                pfx + "d": starts[ar_n, c_pick],
                pfx + "x": x_pick.to(i32),
                pfx + "dir": dirflat[ar_n, torch.clamp(pick, max=F - 1)]}

        outs[side] = dict(fold(sc2, ""), **fold(sc2u, "u"))
    return outs


def known_probes(starts, valid, lens, rdids, tabs, slots: int):
    """K16's site probes (splice.py:665-697): for each slot [N, 2*C*slots]
    (the donor-keyed ones first, slot t*C + c the t-th site at or after
    candidate c's key), its junction position x (1 where the slot is
    dead), the fresh diagonal, and whether the slot is live (a visible
    site inside the read span of a valid candidate: only those are
    rescored)."""
    kd, ka, krdid = tabs["ss_kd"], tabs["ss_ka"], tabs["ss_rdid"]
    ka_s, kd_s, krdid_a = tabs["ss_ka_s"], tabs["ss_kd_s"], tabs["ss_rdid_a"]
    S = kd.shape[0]
    rd2 = rdids[:, None]
    lens2 = lens[:, None]
    cand_x, cand_d2, cand_ok = [], [], []
    lo = table_searchsorted(kd, starts, tabs.get("ss_kd_lob"),
                            tabs.get("ss_shift"))
    for t in range(slots):
        idx = torch.clamp(lo + t, max=S - 1).to(torch.int64)
        site_rd = krdid[idx]
        okd = ((lo + t < S) & valid & (kd[idx] >= starts)
               & (kd[idx] <= starts + lens2 - 2)
               & ((site_rd < 0) | (site_rd < rd2)))
        x = torch.where(okd, kd[idx] - starts + 1, 1)
        cand_x.append(x)
        cand_d2.append(ka[idx] - x)
        cand_ok.append(okd)
    lo2 = table_searchsorted(ka_s, starts + 1, tabs.get("ss_ka_lob"),
                             tabs.get("ss_shift"))
    for t in range(slots):
        idx = torch.clamp(lo2 + t, max=S - 1).to(torch.int64)
        site_rd = krdid_a[idx]
        oka = ((lo2 + t < S) & valid & (ka_s[idx] >= starts + 1)
               & (ka_s[idx] <= starts + lens2 - 1)
               & ((site_rd < 0) | (site_rd < rd2)))
        x = torch.where(oka, ka_s[idx] - starts, 1)
        cand_x.append(x)
        cand_d2.append(kd_s[idx] - x + 1)
        cand_ok.append(oka)
    return (torch.cat(cand_x, 1).to(torch.int32),
            torch.cat(cand_d2, 1).to(torch.int32), torch.cat(cand_ok, 1))


def inject_known_plain(ref_words, n_text: int, reads, quals, lens, rdids,
                       starts, valid, P_raw, tabs, mm_pen, n_pen: int, minsc,
                       slots: int, src_clip_l, src_clip_r, clip_pen,
                       snv_delta1=None, snv_delta2=None):
    """Plain twin of K16 (splice.py:629 inject_known, line by line, always
    with the source clips, so the source totals and mismatch prefixes it
    takes are not read).  tabs: SpliceSiteDB.device_tables; P_raw: the
    penalty prefixes of the source diagonals [N, C, L+1], SNV-forgiving on
    a graph index as pipeline.py:1117-1120 passes them; snv_delta1/2: the
    packed SNV planes, which forgive catalog SNVs on the fresh diagonal
    (None on a linear index).  The donor-coverage gate is always on.
    Returns a dict of [N, 2*C*slots] arrays with `src`."""
    from . import extend as extend_ops
    i32 = torch.int32
    dev = reads.device
    N, C = starts.shape
    L = reads.shape[1]
    lens2 = lens[:, None]
    srcC = torch.arange(C, device=dev, dtype=i32)[None, :].expand(N, C)
    J1 = C * slots
    x_all, fresh, ok_all = known_probes(starts, valid, lens, rdids, tabs,
                                        slots)
    src = torch.cat([srcC] * (2 * slots), 1)
    J = x_all.shape[1]
    x_m1 = torch.clamp(x_all - 1, min=0)
    tot_f, tot_fm, ppfx = extend_ops.live_pen_prefix_plain(
        ref_words, n_text, reads, quals, lens, mm_pen, n_pen, fresh, ok_all,
        [x_all, x_m1], snv_delta1=snv_delta1, snv_delta2=snv_delta2)
    (pf_x, pfm_x), (pf_xm1, _) = ppfx
    src64 = src.to(torch.int64)
    P_src = P_raw.gather(1, src64[:, :, None].expand(N, J, P_raw.shape[2]))

    def at(P, x):
        return P.gather(2, x[:, :, None].to(torch.int64))[:, :, 0]

    ps_x = at(P_src, x_all)
    src_start = starts.gather(1, src64)
    is_donor = torch.arange(J, device=dev)[None, :] < J1
    q = torch.clamp(quals, max=63).to(torch.int64)
    ccost = torch.where(torch.arange(L, device=dev)[None, :] < lens2,
                        clip_pen[q], 0)
    Cc = torch.cat([torch.zeros((N, 1), dtype=i32, device=dev),
                    torch.cumsum(ccost, 1).to(i32)], 1)
    cl_src = src_clip_l.gather(1, src64)
    cr_src = src_clip_r.gather(1, src64)
    cl_d = torch.where(cl_src < x_all, cl_src, 0)
    cr_a = torch.where((lens2 - cr_src) > x_all, cr_src, 0)
    ps_cl = at(P_src, cl_d)
    cc_cl = Cc.gather(1, cl_d.to(torch.int64))
    ps_cr = at(P_src, lens2 - cr_a)
    cc_cr = Cc.gather(1, cr_a.to(torch.int64))
    score_d = -((ps_x - ps_cl) + cc_cl + (tot_f - pf_x))
    mm_new_d = tot_fm - pfm_x
    anchor_d = lens2 - x_all
    score_a = -(pf_x + (ps_cr - ps_x) + cc_cr)
    mm_new_a = pfm_x
    anchor_a = x_all
    score = torch.where(is_donor, score_d, score_a)
    mm_new = torch.where(is_donor, mm_new_d, mm_new_a)
    anchor_new = torch.where(is_donor, anchor_d, anchor_a)
    d1 = torch.where(is_donor, src_start, fresh)
    d2 = torch.where(is_donor, fresh, src_start)
    out_cl = torch.where(is_donor, cl_d, 0)
    out_cr = torch.where(is_donor, 0, cr_a)
    jl = d1 + x_all
    jr = d2 + x_all - 1

    def ref_at(p):
        return rk.ref_chars_block(ref_words, n_text, p, 1)[..., 0]

    cl_, cl1 = ref_at(jl), ref_at(jl + 1)
    cr0, cr_ = ref_at(jr - 1), ref_at(jr)
    dl = torch.where((cl_ < 4) & (cl1 < 4), cl_ * 16 + cl1, 255)
    ar = torch.where((cr0 < 4) & (cr_ < 4), cr0 * 16 + cr_, 255)
    spldir, _ = _classify(dl, ar)
    # donor-coverage gate (splice.py:800-816)
    ps_xm1 = at(P_src, x_m1)
    left_pen_at_donor = torch.where(is_donor, ps_x - ps_xm1, pf_x - pf_xm1)
    ok_all = ok_all & (left_pen_at_donor == 0)
    ok_all = ok_all & (x_all >= 1) & (x_all <= lens2 - 1) & (d2 > d1)
    ok_all = ok_all & (mm_new <= torch.div(anchor_new, 4,
                                           rounding_mode="floor"))
    ok_all = ok_all & (score >= minsc[:, None])
    ok_all = ok_all & (out_cl < x_all) & (out_cr < lens2 - x_all)
    score = torch.where(ok_all, score, -_BIG).to(i32)
    return dict(score=score, d1=d1.to(i32), d2=d2.to(i32), x=x_all,
                kind=torch.where(ok_all, KIND_SPL, KIND_NONE).to(i32),
                spldir=spldir,
                splscore=torch.zeros(score.shape, dtype=_F32, device=dev),
                clip_l=torch.where(ok_all, out_cl, 0).to(i32),
                clip_r=torch.where(ok_all, out_cr, 0).to(i32),
                src=src.to(i32))


# --- the spliced kernels' wrappers ------------------------------------------

def lenpen_device(prm: SpliceParams, device):
    """The canonical and noncanonical lenpen tables on `device`:
    ((brk, val), (brk, val)) int32, for the plain twins, and one int32
    [4, LP] tensor (brk_can, val_can, brk_nc, val_nc, padded with their
    last entry) for the kernels."""
    tabs = [lenpen_table(c, k, prm.max_intron) for c, k in
            ((prm.lenpen_const, prm.lenpen_coef),
             (prm.lenpen_nc_const, prm.lenpen_nc_coef))]
    LP = max(len(t[0]) for t in tabs)
    rows = []
    for brk, val in tabs:
        rows.append(np.concatenate([brk, np.full(LP - len(brk), brk[-1])]))
        rows.append(np.concatenate([val, np.full(LP - len(val), val[-1])]))
    to = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa
    plain = tuple((to(b), to(v)) for b, v in tabs)
    packed = to(np.stack(rows))
    return plain, packed, [len(t[0]) for t in tabs]


def _planes(n_text, reads, quals, lens, starts, valid, mm_pen, n_pen, ch,
            margin, snv1_w=None, snv2_w=None):
    """pen_planes of the candidates' windows; on a graph index, with the
    SNV-plane windows, `pen` forgives catalog SNVs and `pen_raw` does not
    (pipeline.py:1017-1024)."""
    from . import extend as extend_ops
    mstart = torch.where(valid, starts, -1).to(torch.int32)
    return extend_ops.pen_planes(n_text, reads, quals, lens, mstart, mm_pen,
                                 n_pen, ch, margin, snv1_w, snv2_w)


def pair_sweep_ref(ch, reads, quals, lens, starts, valid, minsc, mm_pen,
                   n_pen: int, n_text: int, prm: SpliceParams, lenpen,
                   max_gap: int, margin: int, top: int = 4, snv1_w=None,
                   snv2_w=None):
    """K13 + K14 in plain torch, with the kernel's arguments: the penalty
    planes from the windows (pipeline.py:1017), pair_sweep_plain with the
    raw plane for splice joins and the SNV-forgiving one for indel joins
    (pipeline.py:1084-1089; they are equal without SNV windows),
    select_pairs_plain and the raw base pairs.  lenpen: lenpen_device.
    Returns (pair result dict, selected top dict, base pairs [N, 2])."""
    pl = _planes(n_text, reads, quals, lens, starts, valid, mm_pen, n_pen,
                 ch, margin, snv1_w, snv2_w)
    lp = lenpen[0]
    res = pair_sweep_plain(ch, pl.pen_raw, pl.pen, pl.mm_raw, starts, valid,
                           lens, minsc, prm, lp[0], lp[1], max_gap=max_gap)
    return res, select_pairs_plain(res, starts, top), raw_base_pairs(
        res["raw"])


@functools.lru_cache(maxsize=None)
def sweep_launch_info(name: str, C: int, L: int, W: int, LP: int,
                      snv: bool = False, G: int = 0) -> dict:
    """K13's, K15's or K8's launch at these shapes, from the CUDA runtime
    (csrc/pair_sweep.cu:h2_pair_sweep_info, second_sweep.cu:
    h2_second_sweep_info, indel_sweep.cu:h2_indel_sweep_info): registers
    per thread, static and dynamic shared bytes (csrc/splice_planes.cuh:
    sp_layout for K13 and K15), threads per block and blocks per SM; for
    K13 and K15 also local bytes per thread and the global scratch bytes
    per block (0 where the planes fit a block's shared memory, else the
    global instantiation runs with no dynamic shared memory).  snv: the
    SNV windows of a graph index (and K13's SNV-forgiving prefix).  K8
    reads G, its gap budget, and not C or LP."""
    if name == "indel_sweep":
        return kernels.launch_info("h2_indel_sweep_info", L, W, G, int(snv))
    args = (C, L, W, LP, int(snv)) if name == "pair_sweep" else (C, L, W,
                                                                  LP)
    return kernels.launch_info(f"h2_{name}_info", *args, n=7)


# K13's and K15's planes count columns in int16 (csrc/splice_planes.cuh:
# SP_MAX_COLS)
SWEEP_MAX_L = 32766


def _check_step_inputs(name, ch, reads, quals, lens, starts, valid, minsc,
                       mm_pen, LP, snv1_w=None, snv2_w=None):
    i32 = torch.int32
    N, C, W = ch.shape
    L = reads.shape[1]
    for nm, t, shp in (("ch", ch, (N, C, W)), ("reads", reads, (N, L)),
                       ("quals", quals, (N, L)), ("lens", lens, (N,)),
                       ("starts", starts, (N, C)), ("minsc", minsc, (N,)),
                       ("mm_pen", mm_pen, (64,))):
        kernels.check_cuda(nm, t, i32, shp)
    kernels.check_cuda("valid", valid, torch.bool, (N, C))
    snv = snv1_w is not None
    if snv:
        kernels.check_cuda("snv1_w", snv1_w, i32, (N, C, W))
        kernels.check_cuda("snv2_w", snv2_w, i32, (N, C, W))
    M = (W - L) // 2
    # the pipeline's margin is max(16, gap budget) (pipeline.py:1008, as
    # JAX's), which the PWM windows (14 columns left of x) need
    if M < 16 or W != L + 2 * M:
        raise ValueError(f"{name}: needs windows of L + 2 * margin columns "
                         f"with a margin of at least 16")
    if L > SWEEP_MAX_L:
        raise ValueError(f"{name}: the planes count columns in int16, so a "
                         f"read of {L} bp passes their {SWEEP_MAX_L}")


def _sweep_scratch(name: str, C: int, L: int, W: int, LP: int, snv: bool,
                   N: int, dev):
    """K13's or K15's global staging for N lanes at these shapes
    (csrc/pair_sweep.cu:h2_pair_sweep_scratch, second_sweep.cu:
    h2_second_sweep_scratch): None where a lane's planes fit a block's
    shared memory, else a buffer of the bytes the kernel asks for (a slice
    per block of its grid)."""
    args = (C, L, W, LP, int(snv)) if name == "pair_sweep" else (C, L, W,
                                                                  LP)
    return kernels.scratch(
        f"h2_{name}_scratch", [ctypes.c_int] * len(args) + [ctypes.c_longlong],
        *args, N, dev=dev)


_PWM_ON = {}


def _pwm_dev(device):
    """PWM_FACTORS on `device`, copied there once."""
    key = str(torch.device(device))
    if key not in _PWM_ON:
        _PWM_ON[key] = torch.from_numpy(PWM_FACTORS).to(device)
    return _PWM_ON[key]


def pair_sweep(ch, reads, quals, lens, starts, valid, minsc, mm_pen,
               n_pen: int, n_text: int, prm: SpliceParams, lenpen,
               max_gap: int, margin: int, top: int = 4, snv1_w=None,
               snv2_w=None):
    """K13 + K14 (csrc/pair_sweep.cu) on CUDA tensors, pair_sweep_ref on
    CPU tensors.  snv1_w / snv2_w: the SNV-plane windows of the candidates
    on a graph index (None on a linear one).  The kernel keeps a lane's
    planes in shared memory where they fit, else in a global scratch
    allocated here."""
    if not ch.is_cuda:
        return pair_sweep_ref(ch, reads, quals, lens, starts, valid, minsc,
                              mm_pen, n_pen, n_text, prm, lenpen, max_gap,
                              margin, top, snv1_w, snv2_w)
    _, lpk, nlp = lenpen
    _check_step_inputs("pair_sweep", ch, reads, quals, lens, starts, valid,
                       minsc, mm_pen, lpk.shape[1], snv1_w, snv2_w)
    use_snv = snv1_w is not None
    i32 = torch.int32
    dev = ch.device
    N, C, W = ch.shape
    L = reads.shape[1]
    gcap = max_gap if max_gap else prm.max_gap
    V = min(prm.max_gap, L - 1, gcap)
    res = torch.empty((6, N, C, C), dtype=i32, device=dev)
    sel = torch.empty((9, N, top), dtype=i32, device=dev)
    bsel = torch.empty((N, 2), dtype=i32, device=dev)
    pwm = _pwm_dev(dev)
    scratch = _sweep_scratch("pair_sweep", C, L, W, lpk.shape[1], use_snv,
                             N, dev)
    kernels.KERNELS["pair_sweep"].launch(
        ch.data_ptr(), reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), minsc.data_ptr(),
        mm_pen.data_ptr(), pwm.data_ptr(), lpk.data_ptr(), n_text, N, C, L,
        W, margin, n_pen, V, gcap, lpk.shape[1], nlp[0], nlp[1],
        prm.min_intron, prm.max_intron, prm.pen_can, prm.pen_noncan,
        prm.min_anchor, prm.min_anchor_noncan, prm.rd_gap_open,
        prm.rd_gap_ext, prm.rf_gap_open, prm.rf_gap_ext, top,
        (snv1_w if use_snv else ch).data_ptr(),
        (snv2_w if use_snv else ch).data_ptr(), int(use_snv),
        res.data_ptr(), sel.data_ptr(), bsel.data_ptr(),
        *kernels.scratch_args(scratch), stream=kernels.stream_of(ch))
    out = dict(zip(("score", "x", "kind", "spldir", "splscore", "raw"),
                   res.unbind(0)))
    out["splscore"] = out["splscore"].view(_F32)
    s = dict(zip(("score", "i", "j", "d1", "d2", "x", "kind", "spldir",
                  "splscore"), sel.unbind(0)))
    s["splscore"] = s["splscore"].view(_F32)
    return out, s, bsel


def _site_args(tabs):
    """(kd, ka, rdid, ka_s, kd_s, rdid_a, kd_lob, ka_lob, shift, S, NB)
    pointers and sizes for the kernels; NB = 0 without a bucket index."""
    names = ("ss_kd", "ss_ka", "ss_rdid", "ss_ka_s", "ss_kd_s", "ss_rdid_a")
    for nm in names:
        kernels.check_cuda(nm, tabs[nm], torch.int32)
    S = tabs["ss_kd"].shape[0]
    lob = tabs.get("ss_kd_lob")
    if lob is not None:
        kernels.check_cuda("ss_kd_lob", lob, torch.int32)
        kernels.check_cuda("ss_ka_lob", tabs["ss_ka_lob"], torch.int32)
    ptrs = [tabs[nm].data_ptr() for nm in names]
    if lob is None:
        ptrs += [tabs["ss_kd"].data_ptr()] * 2
        return ptrs + [0, S, 0]
    return ptrs + [lob.data_ptr(), tabs["ss_ka_lob"].data_ptr(),
                   int(tabs["ss_shift"]), S, lob.shape[0] - 1]


def second_sweep_ref(ch, reads, quals, lens, starts, valid, minsc, mm_pen,
                     n_pen: int, n_text: int, prm: SpliceParams, lenpen,
                     margin: int, b_i, b_j, b_x, b_score, b_valid, ss=None,
                     rdids=None):
    """K15 in plain torch with the kernel's arguments: the planes from the
    windows, then second_sweep_plain once per base pair (b_i ... b_valid
    [2, N]: the q2 and the r2 pair).  Returns [{"right", "left"}] * 2."""
    pl = _planes(n_text, reads, quals, lens, starts, valid, mm_pen, n_pen,
                 ch, margin)
    lp = lenpen[0]
    return [second_sweep_plain(ch, pl.pen_raw, pl.mm_raw, starts, valid,
                               lens, minsc, prm, lp[0], lp[1], b_i[t],
                               b_j[t], b_x[t], b_score[t], b_valid[t], ss,
                               rdids)
            for t in range(2)]


_SIDE_KEYS = ("score", "d", "x", "dir", "uscore", "ud", "ux", "udir")


def second_sweep(ch, reads, quals, lens, starts, valid, minsc, mm_pen,
                 n_pen: int, n_text: int, prm: SpliceParams, lenpen,
                 margin: int, b_i, b_j, b_x, b_score, b_valid, ss=None,
                 rdids=None):
    """K15 (csrc/second_sweep.cu) on CUDA tensors, second_sweep_ref on CPU
    tensors: both base pairs of a step (b_i, b_j, b_x, b_score int32 and
    b_valid bool, [2, N]) in one launch.  Returns one {"right": ...,
    "left": ...} per base pair, each side's fields [N].  Planes in shared
    memory where they fit, else in a global scratch allocated here."""
    if not ch.is_cuda:
        return second_sweep_ref(ch, reads, quals, lens, starts, valid, minsc,
                                mm_pen, n_pen, n_text, prm, lenpen, margin,
                                b_i, b_j, b_x, b_score, b_valid, ss, rdids)
    _, lpk, nlp = lenpen
    _check_step_inputs("second_sweep", ch, reads, quals, lens, starts, valid,
                       minsc, mm_pen, lpk.shape[1])
    i32 = torch.int32
    N, C, W = ch.shape
    L = reads.shape[1]
    for nm, t in (("b_i", b_i), ("b_j", b_j), ("b_x", b_x),
                  ("b_score", b_score)):
        kernels.check_cuda(nm, t, i32, (2, N))
    kernels.check_cuda("b_valid", b_valid, torch.bool, (2, N))
    use_ss = ss is not None
    if use_ss:
        site = _site_args(ss)
        kernels.check_cuda("rdids", rdids, i32, (N,))
    else:
        site = [ch.data_ptr()] * 8 + [0, 0, 0]
    out = torch.empty((2, 2, 8, N), dtype=i32, device=ch.device)
    pwm = _pwm_dev(ch.device)
    scratch = _sweep_scratch("second_sweep", C, L, W, lpk.shape[1], False,
                             N, ch.device)
    kernels.KERNELS["second_sweep"].launch(
        ch.data_ptr(), reads.data_ptr(), quals.data_ptr(), lens.data_ptr(),
        starts.data_ptr(), valid.data_ptr(), minsc.data_ptr(),
        mm_pen.data_ptr(), pwm.data_ptr(), lpk.data_ptr(), b_i.data_ptr(),
        b_j.data_ptr(), b_x.data_ptr(), b_score.data_ptr(),
        b_valid.data_ptr(), (rdids if use_ss else lens).data_ptr(), *site,
        int(use_ss), n_text, N, C, L, W, margin, n_pen, lpk.shape[1],
        nlp[0], nlp[1], prm.min_intron, prm.max_intron, prm.pen_can,
        prm.pen_noncan, prm.min_anchor, prm.min_anchor_noncan,
        out.data_ptr(), *kernels.scratch_args(scratch),
        stream=kernels.stream_of(ch))
    return [{side: dict(zip(_SIDE_KEYS, out[t, s].unbind(0)))
             for s, side in enumerate(("right", "left"))} for t in range(2)]


def inject_known_ref(ref_words, n_text: int, reads, quals, lens, rdids,
                     starts, valid, ch, margin: int, tabs, mm_pen,
                     n_pen: int, minsc, slots: int, src_clip_l, src_clip_r,
                     clip_pen, snv1_w=None, snv2_w=None, snv_delta1=None,
                     snv_delta2=None):
    """K16 in plain torch with the kernel's arguments: the source prefixes
    from the windows' SNV-forgiving penalty planes (pipeline.py:1103-1120;
    the raw plane on a linear index), then inject_known_plain."""
    pl = _planes(n_text, reads, quals, lens, starts, valid, mm_pen, n_pen,
                 ch, margin, snv1_w, snv2_w)
    return inject_known_plain(ref_words, n_text, reads, quals, lens, rdids,
                              starts, valid, _prefix(pl.pen, lens)[0], tabs,
                              mm_pen, n_pen, minsc, slots, src_clip_l,
                              src_clip_r, clip_pen, snv_delta1, snv_delta2)


def inject_known(ref_words, n_text: int, reads, quals, lens, rdids, starts,
                 valid, ch, margin: int, tabs, mm_pen, n_pen: int, minsc,
                 slots: int, src_clip_l, src_clip_r, clip_pen, snv1_w=None,
                 snv2_w=None, snv_delta1=None, snv_delta2=None):
    """K16 (csrc/inject_known.cu) on CUDA tensors, inject_known_ref on CPU
    tensors.  starts/valid: the core candidates [N, C]; ch their windows
    (margin); tabs: SpliceSiteDB.device_tables; src_clip_l/_r: the
    ungapped extension's clips of the candidates.  On a graph index:
    snv1_w / snv2_w the candidates' SNV-plane windows (the source side)
    and snv_delta1/2 the packed SNV planes (the fresh side); None on a
    linear index."""
    if not reads.is_cuda:
        return inject_known_ref(ref_words, n_text, reads, quals, lens, rdids,
                                starts, valid, ch, margin, tabs, mm_pen,
                                n_pen, minsc, slots, src_clip_l, src_clip_r,
                                clip_pen, snv1_w, snv2_w, snv_delta1,
                                snv_delta2)
    i32 = torch.int32
    N, C, W = ch.shape
    L = reads.shape[1]
    kernels.check_cuda("ref_words", ref_words, i32)
    for nm, t, shp in (("ch", ch, (N, C, W)), ("reads", reads, (N, L)),
                       ("quals", quals, (N, L)), ("lens", lens, (N,)),
                       ("rdids", rdids, (N,)), ("starts", starts, (N, C)),
                       ("minsc", minsc, (N,)), ("mm_pen", mm_pen, (64,)),
                       ("clip_pen", clip_pen, (64,)),
                       ("src_clip_l", src_clip_l, (N, C)),
                       ("src_clip_r", src_clip_r, (N, C))):
        kernels.check_cuda(nm, t, i32, shp)
    kernels.check_cuda("valid", valid, torch.bool, (N, C))
    use_snv = snv1_w is not None
    if use_snv != (snv_delta1 is not None):
        raise ValueError("inject_known: the SNV windows and the SNV planes "
                         "go together")
    if use_snv:
        for nm, t, shp in (("snv1_w", snv1_w, (N, C, W)),
                           ("snv2_w", snv2_w, (N, C, W)),
                           ("snv_delta1", snv_delta1, None),
                           ("snv_delta2", snv_delta2,
                            tuple(snv_delta1.shape))):
            kernels.check_cuda(nm, t, i32, shp)
    if W != L + 2 * margin:
        raise ValueError("inject_known: windows must be L + 2*margin wide")
    J = 2 * slots * C
    res = torch.empty((9, N, J), dtype=i32, device=reads.device)
    kernels.KERNELS["inject_known"].launch(
        ref_words.data_ptr(), reads.data_ptr(), quals.data_ptr(),
        lens.data_ptr(), rdids.data_ptr(), starts.data_ptr(),
        valid.data_ptr(), ch.data_ptr(), mm_pen.data_ptr(),
        clip_pen.data_ptr(), minsc.data_ptr(), src_clip_l.data_ptr(),
        src_clip_r.data_ptr(), *_site_args(tabs),
        *(t.data_ptr() for t in ((snv1_w, snv2_w, snv_delta1, snv_delta2)
                                 if use_snv else (ch, ch, ref_words,
                                                  ref_words))),
        n_text, ref_words.shape[0],
        snv_delta1.shape[0] if use_snv else 0, int(use_snv), N, C, L, W,
        margin, slots, n_pen, res.data_ptr(),
        stream=kernels.stream_of(reads))
    out = dict(zip(("score", "d1", "d2", "x", "kind", "spldir", "clip_l",
                    "clip_r", "src"), res.unbind(0)))
    out["splscore"] = torch.zeros((N, J), dtype=_F32, device=reads.device)
    return out
