"""The hand-written CUDA kernels against their plain torch twins on the
card, and the whole device step on the card against the step on the CPU,
on a linear and on a graph index (lite and full pass); the mate-rescue
window kernel (K12) on long mates, tied windows and windows past the text;
the spliced kernels (K13-K17 on both spliced steps' intermediates, K18 on
a 4096-row table set) and both spliced steps against the CPU; on the gss
SNP + splice-site index at k = 10, K13 and K16 with their SNV inputs and
both spliced graph steps, and a two-shard index with one shard on the CPU
(shard_devices=["cuda:0", "cpu"]) against both shards on the card.
Needs a CUDA device; skips without one.  On a machine without JAX run it as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(tests/conftest.py imports jax).  Integer results: exact equality."""

import os

import numpy as np
import pytest
import torch

from hisat2_tpu_torch.align.scoring import Scoring
from hisat2_tpu_torch.index import attach_variants, build_fm_index

pytestmark = pytest.mark.gpu
MOTIF_AT = [20000 * k for k in range(1, 6)]
# the kernels only a spliced run launches, and the resolve walk (only a
# sampled-SA index launches it; these steps run on full-SA indexes)
SPLICED = ("search_lanes_live", "pair_sweep", "second_sweep",
           "inject_known", "merge_sites", "resolve_walk")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from hisat2_tpu_torch import kernels
    kernels.load()
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 300_000).astype(np.uint8)
    # a 17-mer planted 5 times: reads ending in it cross the anchor-stop
    # disarm threshold (min_k + 8 with min_k = 9) with >= 4 rows
    motif = rng.integers(0, 4, 17).astype(np.uint8)
    for at in MOTIF_AT:
        g[at:at + 17] = motif
    return g, build_fm_index([("c", g)])


def _reads(rng, g, N, L):
    n = len(g)
    true = rng.integers(50, n - L - 50, N)
    reads = np.full((N, L), 4, np.int32)
    lens = np.full(N, L, np.int32)
    for i in range(N):
        r = g[true[i]:true[i] + L].astype(np.int32)
        if i % 4 == 1:
            r[rng.integers(0, L, 3)] = 4
        if i % 4 == 2:
            p = int(rng.integers(10, L - 10))
            r = np.concatenate([r[:p], r[p + 2:], [0, 1]])
        if i % 2:
            r = np.where(r < 4, 3 - r, r)[::-1].copy()
        if i % 7 == 0:
            lens[i] = L - int(rng.integers(1, 20))
            r[lens[i]:] = 4
        reads[i] = r
    quals = rng.integers(0, 42, (N, L)).astype(np.int32)
    for i, at in enumerate(MOTIF_AT):
        true[8 + i] = at + 17 - L
        reads[8 + i] = g[at + 17 - L:at + 17]
        lens[8 + i] = L
    # clip-gain ties (as in test_torch_extend.py): row 0 on the left,
    # row 1 on the right, both resolved to the larger clip of 10
    for i in (0, 1):
        reads[i] = g[true[i]:true[i] + L]
        lens[i] = L
        quals[i] = 40
    reads[0, [0, 8, 9]] = (reads[0, [0, 8, 9]] + 1) % 4
    quals[0, 1:8], quals[0, 8], quals[0, 9] = 0, 30, 20
    reads[1, [L - 10, L - 9, L - 1]] = (reads[1, [L - 10, L - 9, L - 1]]
                                        + 1) % 4
    quals[1, 1:10], quals[1, L - 10], quals[1, L - 9] = 0, 30, 20
    return true, reads, lens, quals


def _eq(a, b, what):
    assert torch.equal(a.cpu(), b.cpu()), what


@pytest.mark.parametrize("L", [100, 101, 75])
def test_kernels_match_plain_on_card(card, L):
    from hisat2_tpu_torch.index.format import score_tables, to_device
    from hisat2_tpu_torch.ops import extend, search, splice
    g, idx = card
    rng = np.random.default_rng(L)
    dev = to_device(idx, "cuda")
    tabs = score_tables(Scoring(), "cuda")
    m = idx.meta
    true, reads, lens, quals = _reads(rng, g, 1024, L)
    rd, ql, ln = (torch.from_numpy(a).cuda() for a in (reads, quals, lens))
    a = search.partial_search2(dev.blocked, dev.fchr, dev.ftab2_top, m.zrow,
                               m.zrow2, m.rows, rd, ln, 6, 16, 9)
    b = search.partial_search2_plain(dev.blocked, dev.fchr, dev.ftab2_top,
                                     m.zrow, m.zrow2, m.rows, rd, ln, 6, 16,
                                     9)
    for f in a._fields:
        _eq(getattr(a, f), getattr(b, f), f)
    assert bool(a.stopped[8:13].all())
    st = np.stack([true, true + rng.integers(-4, 5, len(true)),
                   rng.integers(-40, m.n + 40, len(true)),
                   np.full(len(true), -1)], 1).astype(np.int32)
    starts = torch.from_numpy(st).cuda()
    minsc = torch.from_numpy((-(lens // 5)).astype(np.int32)).cuda()
    for margin in (16, 0):
        win = splice.diag_chars(dev.ref_words, m.n, starts, L, margin)
        _eq(win, splice.diag_chars_plain(dev.ref_words, m.n, starts, L,
                                         margin), "ref_window")
        ek = extend.extend_grouped(m.n, rd, ql, ln, starts, tabs["mm_pen"],
                                   tabs["clip_pen"], 1, win, margin,
                                   minsc=minsc, mm_min=2)
        pl = extend.pen_planes(m.n, rd, ql, ln, starts, tabs["mm_pen"], 1,
                               win, margin)
        ep = extend.extend_from_planes(m.n, rd, ql, ln, starts,
                                         tabs["mm_pen"], tabs["clip_pen"], 1,
                                         True, pl, False, minsc, 2)
        for f in ek._fields:
            _eq(getattr(ek, f), getattr(ep, f), f)
        assert ek.clip_l[0, 0] == 10 and ek.clip_r[1, 0] == 10
    prm = splice.SpliceParams(allow_spliced=False)
    valid = starts >= 0
    ch = splice.diag_chars_plain(dev.ref_words, m.n, starts, L, 16)
    sk = splice.self_indel_sweep(ch, rd, ql, ln, starts, valid, minsc,
                                 tabs["mm_pen"], 1, prm, max_gap=5)
    sp = splice.self_indel_sweep_plain(ch, rd, ql, ln, starts, valid, minsc,
                                       tabs["mm_pen"], 1, prm, max_gap=5)
    for k in sp:
        _eq(sk[k], sp[k], k)


def test_step_on_card_matches_cpu(card):
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    g, idx = card
    rng = np.random.default_rng(9)
    _, reads, lens, quals = _reads(rng, g, 512, 100)
    cu = TorchAligner(idx, device="cuda", lane_meta=True)
    cp = TorchAligner(idx, device="cpu", lane_meta=True)
    minsc = cu._minsc(lens)
    kernels.reset_counts()
    for full in (False, True):
        bk = cu.step(*cu.upload(reads, quals, lens, minsc), False, full)
        bp = cp.step(*cp.upload(reads, quals, lens, minsc), False, full)
        _eq(bk, bp, f"packed step (full_out={full})")
        assert cu._out_specs == cp._out_specs
    # every kernel of the linear DNA step (injection runs on graph
    # indexes, the rescue window on paired batches, the splice kernels on
    # spliced runs)
    assert all(v > 0 for k, v in kernels.counts().items()
               if k not in ("inject_indels", "rescue_window") + SPLICED)


def _cmp(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    _eq(a, b, what)


def _flat(x):
    if hasattr(x, "_fields"):
        return {f: getattr(x, f) for f in x._fields}
    if isinstance(x, dict):
        return x
    return {"out": x}


def _replay(cap, names):
    """Each captured kernel call through the kernel and its plain twin."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    assert sorted(cap) == sorted(names)
    for name in names:
        kern, plain = twins[name]
        ko, po = _flat(kern(**cap[name])), _flat(plain(**cap[name]))
        torch.cuda.synchronize()
        assert sorted(ko) == sorted(po), name
        for f in ko:
            _cmp(ko[f], po[f], f"{name}.{f}")


@pytest.fixture(scope="module")
def gcard(card, tmp_path_factory):
    """A 200 kbp graph index (SNVs, deletions, insertions at catalog
    density x 20) and 1024 reads, a third carrying a catalog allele."""
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    g[150_000:150_400] = g[20_000:20_400]
    pos = np.sort(rng.choice(np.arange(500, len(g) - 500), 1600,
                             replace=False))
    lines, cat = [], []
    for k, p in enumerate(pos):
        p = int(p)
        t = k % 4
        if t < 2:
            alt = (int(g[p]) + int(rng.integers(1, 4))) % 4
            lines.append(f"v{k} single c {p} {'ACGT'[alt]}")
            cat.append(("S", p, alt))
        elif t == 2:
            ln = int(rng.integers(1, 6))
            lines.append(f"v{k} deletion c {p} {ln}")
            cat.append(("D", p, ln))
        else:
            ins = rng.integers(0, 4, int(rng.integers(1, 6)))
            lines.append(f"v{k} insertion c {p} "
                         + "".join("ACGT"[c] for c in ins))
            cat.append(("I", p, ins.astype(np.uint8)))
    snp = os.path.join(str(tmp_path_factory.mktemp("gc")), "v.snp")
    with open(snp, "w") as f:
        f.write("\n".join(lines) + "\n")
    idx = build_fm_index([("c", g)])
    attach_variants(idx, snp_file=snp)
    L, B = 100, 1024
    reads = np.zeros((B, L), np.int32)
    for i in range(B):
        s = int(rng.integers(0, len(g) - L - 10))
        r = g[s:s + L].copy()
        if i % 3 == 0:
            kind, p, v = cat[int(rng.integers(0, len(cat)))]
            s = max(0, min(p - int(rng.integers(10, L - 10)),
                           len(g) - L - 10))
            if kind == "S":
                r = g[s:s + L].copy()
                r[p - s] = v
            elif kind == "D":
                r = np.concatenate([g[s:p], g[p + v:s + L + v]])[:L]
            else:
                r = np.concatenate([g[s:p], v, g[p:s + L]])[:L]
        if i % 4 == 1:
            r[rng.integers(0, L, 2)] = rng.integers(0, 4, 2)
        if i % 2:
            r = (3 - r)[::-1]
        reads[i] = r
    quals = rng.integers(5, 41, (B, L)).astype(np.int32)
    lens = np.full(B, L, np.int32)
    lens[::9] = L - rng.integers(1, 20, len(lens[::9]))
    for i in range(0, B, 9):
        reads[i, lens[i]:] = 4
    return idx, reads, quals, lens


@pytest.mark.parametrize("lite", [True, False])
def test_graph_kernels_match_plain_on_card(gcard, lite):
    """Every kernel of the graph step (lite: no sweep, no injection) on
    its real intermediates, SNV branches included."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    idx, reads, quals, lens = gcard
    top = TorchAligner(idx, device="cuda", variants=idx._variants,
                       lane_meta=True)
    al = top._fast if lite else top
    cap = {}
    al.step(*al.upload(reads, quals, lens, al._minsc(lens)), False,
            capture=cap)
    names = ["fm_search2", "compact_cands", "ref_window",
             "extend_ungapped", "pack_slots"]
    if not lite:
        names += ["inject_indels", "indel_sweep"]
    assert cap["extend_ungapped"]["snv1_win"] is not None
    _replay(cap, names)


def test_graph_step_on_card_matches_cpu(gcard):
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    idx, reads, quals, lens = gcard
    cu = TorchAligner(idx, device="cuda", variants=idx._variants,
                      lane_meta=True)
    cp = TorchAligner(idx, device="cpu", variants=idx._variants,
                      lane_meta=True)
    minsc = cu._minsc(lens)
    kernels.reset_counts()
    for tier in ("_fast", None):
        a = getattr(cu, tier) if tier else cu
        b = getattr(cp, tier) if tier else cp
        for full in (False, True):
            bk = a.step(*a.upload(reads, quals, lens, minsc), False, full)
            bp = b.step(*b.upload(reads, quals, lens, minsc), False, full)
            _eq(bk, bp, f"packed step {tier} full_out={full}")
            assert a._out_specs == b._out_specs
            assert a._spill_meta == b._spill_meta
    assert all(v > 0 for k, v in kernels.counts().items()
               if k not in ("rescue_window",) + SPLICED)


@pytest.mark.parametrize("N,K,Mdev,spill,dense", [
    (3000, 23, 12, True, 0.3), (3000, 23, 12, True, 0.05),
    (2048, 6, 6, True, 0.5), (1000, 47, 22, False, 0.3),
    (513, 11, 11, False, 0.4)])
def test_pack_slots_random_on_card(card, N, K, Mdev, spill, dense):
    """K9 on random schemas: ties, both layouts, a spill that overflows
    its S = N rows (dense 0.3) and one that does not, lane counts over
    the scan block's 1024."""
    from hisat2_tpu_torch.ops import compact
    rng = np.random.default_rng(N + K)
    uni = rng.integers(-40, 1, (17, N, K)).astype(np.int32)
    valid = rng.random((N, K)) < dense
    uni[15] = valid
    uni[0] = np.where(valid, rng.integers(-12, 1, (N, K)), -(2 ** 30))
    for f in (4, 5, 6, 8, 9):            # kind spldir known post selfgap
        uni[f] = rng.integers(0, 2 if f != 4 else 4, (N, K))
    uni[5] = 0
    uni[16] = np.where(valid, rng.integers(-1, 50, (N, K)), -1)
    u = torch.from_numpy(uni).cuda()
    ko = compact.pack_slots(u, Mdev, spill)
    po = compact.pack_slots_plain(u, Mdev, spill)
    torch.cuda.synchronize()
    assert sorted(ko) == sorted(po)
    for k in ko:
        _cmp(ko[k], po[k].contiguous(), k)
    if spill and dense == 0.3:
        assert int(ko["sp_src"][-1]) == -2


@pytest.mark.parametrize("lane_meta,lite_cap", [(True, 0), (False, 8)])
def test_compact_cands_random_on_card(card, lane_meta, lite_cap):
    """K3+K4 on random hits over the card fixture's SA: duplicates,
    short and long hits, wide hits, stopped lanes, N not a multiple of
    the warps per block."""
    from hisat2_tpu_torch.index.format import to_device
    from hisat2_tpu_torch.ops import compact
    g, idx = card
    dev = to_device(idx, "cuda")
    rng = np.random.default_rng(5 + lite_cap)
    N, H = 1999, 6
    rows = idx.meta.rows
    top = rng.integers(0, rows - 30, (N, H)).astype(np.int32)
    top[:, 1] = top[:, 0]                       # duplicate hits
    w = rng.choice([0, 1, 1, 2, 3, 5, 9, 12, 25], (N, H))
    bot = (top + w).astype(np.int32)
    lo = rng.integers(0, 60, (N, H)).astype(np.int32)
    hi = (lo + rng.integers(5, 40, (N, H))).astype(np.int32)
    nh = rng.integers(0, H + 1, N).astype(np.int32)
    ab = rng.integers(0, 9, (N, H)).astype(np.int32)
    post = rng.random((N, H)) < 0.3
    stopped = rng.random(N) < 0.3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    kw = dict(sa=dev.sa, top=t(top), bot=t(bot), lo=t(lo), hi=t(hi),
              nh=t(nh), abefore=t(ab), post=t(post), stopped=t(stopped),
              P=10, C=11, CC=6, min_k=9, maxsize=10, short_rows=5,
              lite_cap=lite_cap, lane_meta=lane_meta)
    ko = compact.compact_cands(**kw)
    po = compact.compact_candidates_plain(**kw)
    torch.cuda.synchronize()
    for f in ko._fields:
        _cmp(getattr(ko, f), getattr(po, f), f)


@pytest.mark.parametrize("L", [100, 150, 300])
def test_rescue_window_matches_plain_on_card(card, L):
    """K12 against its plain twin: windows inside the text, at its start
    (negative start) and past its end, the 15-copy tie window of
    tests/test_rescue.py, mates with Ns and shorter lengths; at L = 300
    near-copies of the mate make counts that bfloat16 rounds into ties
    (299 reads as 300).  Then the whole rescue_candidates call."""
    from hisat2_tpu_torch.index.format import score_tables, to_device
    from hisat2_tpu_torch.ops import rescue
    rng = np.random.default_rng(L)
    n = 300_000
    g = rng.integers(0, 4, n).astype(np.uint8)
    unit = rng.integers(0, 4, 120).astype(np.uint8)
    spots = [20000 + 18000 * i for i in range(15)]
    for s in spots:
        g[s:s + 120] = unit
    # copies of one L-bp unit with 1, 0, 2 and 3 mismatches: at L = 300
    # the first two count 299 and 300, which bfloat16 ties
    long_unit = rng.integers(0, 4, L).astype(np.uint8)
    for c, at in zip((1, 0, 2, 3), (240_000, 240_000 + 3 * L,
                                    240_000 + 9 * L, 240_000 + 20 * L)):
        g[at:at + L] = long_unit
        g[at + np.arange(c) * 7 + 3] ^= 1
    idx = build_fm_index([("c", g)])
    dev = to_device(idx, "cuda")
    tabs = score_tables(Scoring(), "cuda")
    W = 57344
    R = 37
    reads = np.full((R, L), 4, np.int32)
    lens = np.full(R, L, np.int32)
    ws = np.zeros(R, np.int64)
    for i in range(R):
        s = int(rng.integers(0, n - L))
        reads[i] = g[s:s + L]
        ws[i] = (s - int(rng.integers(0, W - L))) // 56320 * 56320
    reads[0, :min(L, 100)] = g[spots[0] + 10:spots[0] + 10
                               + min(L, 100)]      # tie window
    ws[0] = 0
    reads[1] = long_unit
    ws[1] = 240_000 // 56320 * 56320
    ws[2], ws[3] = -56320, n - 1000                 # start / past the end
    reads[2] = g[:L]
    reads[3] = g[n - L:]
    reads[4:8, ::13] = 4                            # Ns
    lens[8:12] = L - rng.integers(1, 30, 4)
    for i in range(8, 12):
        reads[i, lens[i]:] = 4
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).cuda()
    rd, wst = t(reads), t(ws)
    k = rescue.rescue_window(dev.ref_words, idx.meta.n, rd, wst, W)
    p = rescue.rescue_window_plain(dev.ref_words, idx.meta.n, rd, wst, W)
    torch.cuda.synchronize()
    _eq(k, p, "rescue_window")
    if L == 300:
        assert k[1, :2].tolist() == [240_000, 240_000 + 3 * L]
    quals = rng.integers(5, 41, (R, L)).astype(np.int32)
    kw = dict(ref_words=dev.ref_words, n_text=idx.meta.n, reads=rd,
              quals=t(quals), lens=t(lens), win_start=wst, W=W,
              mm_pen=tabs["mm_pen"], clip_pen=tabs["clip_pen"], n_pen=1)
    ks, ke = rescue.rescue_candidates(**kw)
    _eq(ks, p, "starts")
    from hisat2_tpu_torch.ops import extend, splice
    ch = splice.diag_chars_plain(dev.ref_words, idx.meta.n, p, L, 0)
    pe = extend.extend_grouped_plain(idx.meta.n, rd, kw["quals"],
                                     kw["lens"], p, tabs["mm_pen"],
                                     tabs["clip_pen"], 1, ch, 0)
    for f in ke._fields:
        _eq(getattr(ke, f), getattr(pe, f), f)


# --- the spliced kernels (K13-K18) -------------------------------------------

def _flat_list(x):
    if hasattr(x, "_fields"):
        return [getattr(x, f) for f in x._fields]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat_list(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat_list(e)]
    return [x]


@pytest.fixture(scope="module")
def scard(card):
    """A spliced aligner on a genome with GT-AG introns, its site DB
    filled by one aligned batch, and a second batch of junction reads."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    rng = np.random.default_rng(13)
    g = rng.integers(0, 4, 300_000).astype(np.uint8)
    introns = [(20000 + 7000 * k, int(ln)) for k, ln in
               enumerate(rng.choice([90, 400, 3000, 12000], 30))]
    for s, ln in introns:
        g[s], g[s + 1], g[s + ln - 2], g[s + ln - 1] = 2, 3, 0, 2
    idx = build_fm_index([("c", g)])
    al = TorchAligner(idx, spliced=True, lane_meta=True, device="cuda")

    def batch(B, L=100):
        codes = np.zeros((B, L), np.uint8)
        for i in range(B):
            s, ln = introns[int(rng.integers(0, len(introns)))]
            x = int(rng.integers(8, L - 8))
            if i % 3 == 2:
                p = int(rng.integers(1000, 290000))
                r = g[p:p + L]
            else:
                r = np.concatenate([g[s - x:s], g[s + ln:s + ln + L - x]])
            if i % 2:
                r = np.where(r < 4, 3 - r, 4)[::-1]
            codes[i] = r[:L]
        return codes, rng.integers(10, 41, (B, L)).astype(np.uint8), \
            np.full(B, L, np.int32)

    al.align_batch(*batch(256))
    return al, idx, batch(1100), batch


def test_spliced_kernels_match_plain_on_card(scard):
    """K13+K14, K15, K16 (lite and full), K17 (1100 reads: 2200 lanes, the
    lane-list mode) and the spliced modes of kernels 5 and 6 on the real
    intermediates of both spliced steps."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    al, _, (codes, quals, lens), _ = scard
    rdids = 10 ** 6 + np.arange(len(lens), dtype=np.int64)
    for a in (al._fast, al):
        rd, ss = a._step_site_args(rdids)
        cap = {}
        a.step(*a.upload(codes, quals, lens, a._minsc(lens)), True,
               capture=cap, rdids=rd, ss=ss)
        want = {"inject_known", "compact_cands", "pack_slots"}
        if not a.lite:
            want |= {"pair_sweep", "second_sweep", "search_lanes_live"}
        assert want <= set(cap)
        for name in sorted(want):
            kern, plain = twins[name]
            ko = _flat_list(kern(**cap[name]))
            po = _flat_list(plain(**cap[name]))
            assert len(ko) == len(po)
            for x, y in zip(ko, po):
                _cmp(x, y, name)


def test_spliced_step_on_card_matches_cpu(scard):
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    al, idx, (codes, quals, lens), batch = scard
    cpu = TorchAligner(idx, spliced=True, lane_meta=True, device="cpu")
    for k in ("sites", "_col_jl", "_col_jr", "_col_rdid"):
        setattr(cpu.splice_db, k, getattr(al.splice_db, k))
    # and 300 bp reads (longer planes; the pair sweep's shared memory)
    long_ = batch(64, 300)
    for a, c, (codes, quals, lens) in (
            (al._fast, cpu._fast, (codes, quals, lens)),
            (al, cpu, (codes, quals, lens)), (al, cpu, long_)):
        rdids = np.arange(len(lens), dtype=np.int64) + 100
        rd, ss = a._step_site_args(rdids)
        rdc, ssc = c._step_site_args(rdids)
        minsc = a._minsc(lens)
        bk = a.step(*a.upload(codes, quals, lens, minsc), True, rdids=rd,
                    ss=ss)
        bp = c.step(*c.upload(codes, quals, lens, minsc), True, rdids=rdc,
                    ss=ssc)
        _eq(bk, bp, "spliced packed step")


@pytest.mark.parametrize("lob", [False, True])
def test_merge_sites_matches_plain_on_card(card, lob):
    """K18 on a 4096-row table set: ties between old and new keys, 300 of
    512 new rows real, with and without the bucket index."""
    from hisat2_tpu_torch.ops import sites
    rng = np.random.default_rng(lob)
    SENT = 2 ** 31 - 2
    cap, nn, m = 4096, 3000, 300
    kd = np.sort(rng.integers(0, 10 ** 7, nn)).astype(np.int32)
    kd[5:9] = kd[5]
    ka = (kd + rng.integers(30, 5000, nn)).astype(np.int32)
    o = np.lexsort((ka, kd))
    kd, ka = kd[o], ka[o]
    rd = rng.integers(-1, 100, nn).astype(np.int32)
    o2 = np.lexsort((kd, ka))

    def pad(a, f):
        b = np.full(cap, f, np.int32)
        b[:len(a)] = a
        return torch.from_numpy(b).cuda()

    nkd = np.full(512, SENT, np.int32)
    nka, nrd = nkd.copy(), np.full(512, -1, np.int32)
    nkd[:m] = rng.integers(0, 10 ** 7, m)
    nkd[:3] = kd[5]
    nka[:m] = nkd[:m] + 100
    nka[:3] = ka[5]
    nrd[:m] = 7
    T = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    kw = dict(kd=pad(kd, SENT), ka=pad(ka, SENT), rd=pad(rd, -1),
              ka_s=pad(ka[o2], SENT), kd_s=pad(kd[o2], SENT),
              rd_a=pad(rd[o2], -1), nkd=T(nkd), nka=T(nka), nrd=T(nrd))
    if lob:
        shift, NB = 5, 1 << 19
        edges = np.arange(NB + 1, dtype=np.int64) << shift
        bkd, bka, w = (np.zeros(512, np.int32) for _ in range(3))
        bkd[:m] = np.clip(nkd[:m] >> shift, 0, NB - 1)
        bka[:m] = np.clip(nka[:m] >> shift, 0, NB - 1)
        w[:m] = 1
        kw.update(lob_kd=T(np.searchsorted(kd, edges).astype(np.int32)),
                  lob_ka=T(np.searchsorted(ka[o2], edges).astype(np.int32)),
                  bins_kd=T(bkd), bins_ka=T(bka), wts=T(w))
    got = sites.merge_sorted_tabs(**kw)
    want = sites.merge_sorted_tabs_plain(**kw)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        _eq(x, y, "merge_sites")


@pytest.fixture(scope="module")
def walk_card():
    """A 300 kbp genome indexed at off_rate 1-5, uploaded to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from hisat2_tpu_torch.index.format import to_device
    g = np.random.default_rng(11).integers(0, 4, 300_000).astype(np.uint8)
    out = {}
    for orate in range(1, 6):
        idx = build_fm_index([("c", g)], off_rate=orate)
        out[orate] = (idx, to_device(idx, "cuda"))
    return g, out


@pytest.mark.parametrize("off_rate", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0, None])
def test_resolve_walk_matches_plain_on_card(walk_card, off_rate, density):
    """K19+K20 on random rows, live densities 0, 20% and 100% and without
    a mask (K19 alone), against the plain twin on the same card tensors."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import resolve
    _, idxs = walk_card
    idx, d = idxs[off_rate]
    rng = np.random.default_rng(off_rate * 7 + int((density or 0.5) * 10))
    M = 100_003
    row = torch.from_numpy(rng.integers(0, idx.meta.rows, M).astype(
        np.int32)).cuda()
    live = (None if density is None else
            torch.from_numpy(rng.random(M) < density).cuda())
    args = (d.blocked, d.fchr, d.sa, idx.meta.zrow, off_rate, row, live)
    n0 = kernels.KERNELS["resolve_walk"].launches
    got = resolve.resolve_rows_sparse(*args)
    torch.cuda.synchronize()
    assert kernels.KERNELS["resolve_walk"].launches == n0 + 1
    _eq(got, resolve.resolve_rows_sparse_plain(*args), "resolve_walk")


def test_sampled_two_shard_steps_on_card_match_cpu(card):
    """The whole DNA and spliced steps of both shards of a two-shard
    index sampled at off_rate 4, on the card against the CPU; every step
    launches the walk."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    g, _ = card
    sh = build_fm_index([("a", g[:150_000]), ("b", g[150_000:])],
                        shard_bp=160_000, off_rate=4)
    assert len(sh.shards) == 2
    rng = np.random.default_rng(13)
    _, reads, lens, quals = _reads(rng, g, 512, 100)
    for spliced in (False, True):
        cu = TorchAligner(sh, device="cuda", spliced=spliced)
        cp = TorchAligner(sh, device="cpu", spliced=spliced)
        minsc = cu._minsc(lens)
        for al in ((cu._fast, cp._fast), (cu, cp)) if spliced else \
                ((cu, cp),):
            ka, pa = al
            n0 = kernels.KERNELS["resolve_walk"].launches
            got = ka._dispatch_packed(reads, quals, lens, minsc, False)
            want = pa._dispatch_packed(reads, quals, lens, minsc, False)
            torch.cuda.synchronize()
            assert kernels.KERNELS["resolve_walk"].launches > n0
            for (hg, ev), (wg, _) in zip(got, want):
                ev.synchronize()
                _eq(hg, wg, f"spliced={spliced} lite={ka.lite} step")


def _gss_index(shard_bp=None):
    """The gss corpus's SNP + splice-site index (tests/data/make_gss.py),
    one shard or two at off_rate 4, and its chromosomes."""
    import gzip
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = i
    chroms = []
    with gzip.open(os.path.join(data, "gss_genome.fa.gz"), "rt") as f:
        for line in f:
            if line.startswith(">"):
                chroms.append((line[1:].strip(), []))
            else:
                chroms[-1][1].append(line.strip())
    chroms = [(n, lut[np.frombuffer("".join(v).encode(), np.uint8)])
              for n, v in chroms]
    kw = dict(shard_bp=shard_bp, off_rate=4) if shard_bp else {}
    idx = build_fm_index(chroms, **kw)
    attach_variants(idx, snp_file=os.path.join(data, "gss.snp"),
                    ss_file=os.path.join(data, "gss.ss"))
    return idx, chroms, data


def _gss_reads(chroms, data, L, n, seed):
    """n junction reads of L bp over the corpus's introns (the .ss file's
    and the novel ones between them), carrying every catalog SNV they
    cover, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    snv = {}
    with open(os.path.join(data, "gss.snp")) as f:
        for line in f:
            p = line.split()
            if p[1] == "single":
                snv.setdefault(p[2], []).append((int(p[3]), "ACGT".index(
                    p[4])))
    # the corpus's introns: start 2500 + 4700 k, the .ss lengths
    lens = (80, 150, 300, 600, 1200, 4000)
    introns = [(2500 + 4700 * k, lens[k % 6]) for k in range(12)]
    codes = np.zeros((n, L), np.uint8)
    for i in range(n):
        name, g = chroms[i % 2]
        s, ln = introns[int(rng.integers(0, len(introns)))]
        x = int(rng.integers(20, L - 20))
        pos = np.r_[s - x:s, s + ln:s + ln + L - x]
        r = g[pos].copy()
        for p, alt in snv.get(name, ()):
            hit = np.flatnonzero(pos == p)
            r[hit] = alt
        if i % 2:
            r = (3 - r)[::-1]
        codes[i] = r
    return codes, rng.integers(10, 41, (n, L)).astype(np.uint8), \
        np.full(n, L, np.int32)


@pytest.fixture(scope="module")
def gss_card(card):
    """The spliced graph aligner at k = 10 (config 6's shape on one shard)
    on the card and on the CPU, with 100 and 150 bp junction reads."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    idx, chroms, data = _gss_index()
    kw = dict(variants=idx._variants, spliced=True, k=10, lane_meta=True)
    al = TorchAligner(idx, device="cuda", **kw)
    cpu = TorchAligner(idx, device="cpu", **kw)
    return al, cpu, {L: _gss_reads(chroms, data, L, 512, L)
                     for L in (100, 150)}


@pytest.mark.parametrize("L", [100, 150])
def test_spliced_graph_kernels_match_plain_on_card(gss_card, L):
    """K13+K14 and K16 with their SNV inputs (and every other kernel of
    the spliced graph steps) on the real intermediates of the lite and
    full step at k = 10 (C = 19), against their plain twins."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    al, _, batches = gss_card
    codes, quals, lens = batches[L]
    for a in (al._fast, al):
        rd, ss = a._step_site_args(np.arange(len(lens)) + 7)
        cap = {}
        a.step(*a.upload(codes, quals, lens, a._minsc(lens)), True,
               capture=cap, rdids=rd, ss=ss)
        assert cap["inject_known"]["snv1_w"] is not None
        if not a.lite:
            assert cap["pair_sweep"]["snv1_w"] is not None
            assert cap["pair_sweep"]["starts"].shape[1] == 19
        for name in sorted(cap):
            kern, plain = twins[name]
            ko = _flat_list(kern(**cap[name]))
            po = _flat_list(plain(**cap[name]))
            assert len(ko) == len(po)
            for x, y in zip(ko, po):
                _cmp(x, y, name)


def test_spliced_graph_step_on_card_matches_cpu(gss_card):
    al, cpu, batches = gss_card
    for L, (codes, quals, lens) in batches.items():
        for a, c in ((al._fast, cpu._fast), (al, cpu)):
            rdids = np.arange(len(lens), dtype=np.int64) + 11
            rd, ss = a._step_site_args(rdids)
            rdc, ssc = c._step_site_args(rdids)
            minsc = a._minsc(lens)
            bk = a.step(*a.upload(codes, quals, lens, minsc), True,
                        rdids=rd, ss=ss)
            bp = c.step(*c.upload(codes, quals, lens, minsc), True,
                        rdids=rdc, ss=ssc)
            _eq(bk, bp, f"spliced graph step L={L} lite={a.lite}")


def test_mixed_shard_devices_on_card(card):
    """shard_devices=["cuda:0", "cpu"]: shard 1 runs its plain twins on the
    CPU where the caller placed it; the spliced graph run on the two-shard
    gss index equals the run with both shards on cuda:0."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    idx, chroms, data = _gss_index(shard_bp=61000)
    assert len(idx.shards) == 2
    codes, quals, lens = _gss_reads(chroms, data, 100, 256, 5)
    res = {}
    for place in (("cuda:0", "cpu"), ("cuda:0", "cuda:0")):
        a = TorchAligner(idx, device="cuda", variants=idx._variants,
                         spliced=True, k=10, shard_devices=list(place))
        assert [str(d.device) for d in a.devs] == list(place)
        assert a.shard_graph_dev[1]["snv1"].device.type == \
            torch.device(place[1]).type
        r = a.align_batch(codes, quals, lens)
        res[place] = (r.raw["cols"], dict(a.splice_db.sites))
    (c1, s1), (c2, s2) = res.values()
    for x, y in zip(c1, c2):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert s1 == s2
    assert len(np.unique(np.asarray(c1[0]))) >= 200
