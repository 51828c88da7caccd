"""The hand-written CUDA kernels against their plain torch twins on the
card, and the whole device step on the card against the step on the CPU,
on a linear and on a graph index (lite and full pass); the mate-rescue
window kernel (K12) on long mates, tied windows and windows past the text;
the spliced kernels (K13-K17 on both spliced steps' intermediates, K18 on
a 4096-row table set) and both spliced steps against the CPU; on the gss
SNP + splice-site index at k = 10, K13 and K16 with their SNV inputs and
both spliced graph steps, and a two-shard index with one shard on the CPU
(shard_devices=["cuda:0", "cpu"]) against both shards on the card; the
junction sweeps K13 + K14 and the two-pair K15 on seeded random lanes at
C in {1, 5, 14, 19, 32, 33, 40} and L from 60 to 2000 (planes in shared
memory, and in the global scratch where they outgrow it); the FM search
K1 and its lane-list mode K17 on seeded random lanes; the spliced
kernels and the spliced step on reads of 600-2000 bp; the DNA step at
-k 64 with a 6,000 bp read (K4's pools in the global scratch); K16 on
random lanes with every, no or a tenth of its slots live (its work list
filled mid-tile at five slots a candidate); K20 at 0.1-30% live over 0 to
2,000,003 rows; K12 at R in {1, 3, 37, 128} x W in {8, 33, 57,344} x L
from 1 to 2000 (padding tails, ties), K18 at m real in {0, 1, 300, 512}
and cap 64 and 65,536, and both replayed in one CUDA graph; K5 and K12
on windows across and wholly past 16 * n_words with a larger n_text (a
sharded index's mate rescue reads shard 0's words at global positions),
on each of the row clamps of JAX's lowerings, and K13+K14, K15, K16 and
K17 on the two spliced steps of a fused 8,192-mate pair batch (16,384
lanes).
Needs a CUDA device; skips without one.  On a machine without JAX run it as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(tests/conftest.py imports jax).  Integer results: exact equality."""

import io
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
    if isinstance(x, (tuple, list)):     # K5: out[set][plane]
        return {f"out{i}": v for i, v in enumerate(_flat_list(x))}
    return {"out": x}


def _replay(cap, names):
    """Each captured kernel call through the kernel and its plain twin."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    assert sorted(cap) == sorted(names)
    for name in names:
        kern, plain = twins[name.split("/")[0]]
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
        names += ["inject_indels", "indel_sweep", "extend_ungapped/extra"]
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


def _pack_blocks(rng, N, K, dense, ties, event):
    """Random blocks of a slot schema of K columns over N lanes, read in
    place: int32, int64, int16, int8, uint8 and bool planes, a strided
    view, constants and absent fields (their defaults; valid from the
    score where absent)."""
    cuts = np.sort(rng.choice(np.arange(1, K), min(K - 1, 4),
                              replace=False)) if K > 1 else []
    edges = [0, *cuts, K]
    t = lambda a, dt=torch.int32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dt).cuda()
    blocks = []
    for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        W = b - a
        valid = rng.random((N, W)) < dense
        sc = (rng.integers(-2, 1, (N, W)) if ties
              else rng.integers(-40, 40, (N, W)))
        d = {"score": t(np.where(valid, sc, -(2 ** 30) - rng.integers(
                 0, 2, (N, W))))}
        d1 = rng.integers(-2 ** 31, 2 ** 31 - 1, (N, W))
        d["d1"] = t(d1, torch.int64)
        wide = torch.zeros((N, W + 3), dtype=torch.int32, device="cuda")
        wide[:, 1:W + 1] = t(d1 + rng.integers(-300, 300, (N, W)),
                             torch.int64).to(torch.int32)
        d["d2"] = wide[:, 1:W + 1]                 # strided view
        d["x"] = t(rng.integers(-5, 300, (N, W)), torch.int16)
        d["kind"] = t(rng.integers(0, 4, (N, W)), torch.int8)
        d["spldir"] = (0 if i % 2 else
                       t(rng.integers(0, 3, (N, W)), torch.int8))
        d["known"] = t(rng.integers(0, 2, (N, W)), torch.uint8)
        d["ab"] = t(rng.integers(-3, 200, (N, W)))
        d["post"] = t(rng.random((N, W)) < 0.5, torch.bool)
        d["selfgap"] = 1 if i == 1 else t(rng.integers(0, 2, (N, W)),
                                          torch.uint8)
        if i % 3 != 2:                             # else absent: 0
            for f in ("n_mm", "n_n", "clip_l", "clip_r"):
                d[f] = t(rng.integers(-3, 300, (N, W)))
        if i % 2 == 0:                             # else NO_ALT
            d["alt"] = t(rng.integers(-100, 100, (N, W)))
        if i % 2 == 1:                             # else from the score
            d["valid"] = t(valid & (rng.random((N, W)) < 0.9), torch.bool)
        if event and i % 3 == 0:                   # else -1
            d["event"] = t(rng.integers(-1, 50, (N, W)))
        blocks.append(d)
    return blocks


@pytest.mark.parametrize(
    "N,K,Mdev,spill,dense,spliced,ties,inplace", [
        (3000, 23, 12, True, 0.3, False, False, False),
        (3000, 23, 12, True, 0.05, False, False, False),
        (2048, 6, 6, True, 0.5, False, False, False),
        (1000, 47, 22, False, 0.3, False, False, False),
        (513, 11, 11, False, 0.4, False, False, False),
        (8192, 23, 10, True, 0.3, False, True, True),
        (20001, 23, 10, True, 0.03, True, False, True),
        (8192, 130, 22, True, 0.9, True, True, True),
        (8192, 130, 22, True, 0.002, False, False, True),
        (4096, 70, 66, True, 0.3, False, True, True),
        (2000, 70, 66, False, 0.3, True, True, True),
        (20001, 210, 66, True, 0.2, True, True, True),
        (333, 1, 1, False, 0.5, False, False, True)])
def test_pack_slots_random_on_card(card, N, K, Mdev, spill, dense, spliced,
                                   ties, inplace):
    """K9 on random schemas: ties, both layouts, a spill that overflows
    its S = N rows (dense 0.3 and up: far above S at 0.9) and one far
    below it, spliced words, N not a multiple of the lanes a block (the
    look-back over up to 2,501 blocks), K up to 210 and Mdev 66; as one
    block of int32 planes (the rows of one [F, N, K] schema), or as
    blocks read in place (int64 / int16 / int8 / uint8 / bool planes, a
    strided view, constants, absent fields)."""
    from hisat2_tpu_torch.ops import compact
    rng = np.random.default_rng(N + K)
    if inplace:
        ev = bool(K % 2 == 0)
        u = _pack_blocks(rng, N, K, dense, ties, ev)
        args = dict(Mdev=Mdev, use_spill=spill, spliced=spliced,
                    has_event=ev)
    else:
        uni = rng.integers(-40, 1, (17, N, K)).astype(np.int32)
        valid = rng.random((N, K)) < dense
        uni[15] = valid
        uni[0] = np.where(valid, rng.integers(-12, 1, (N, K)), -(2 ** 30))
        for f in (4, 5, 6, 8, 9):        # kind spldir known post selfgap
            uni[f] = rng.integers(0, 2 if f != 4 else 4, (N, K))
        uni[5] = 0
        uni[16] = np.where(valid, rng.integers(-1, 50, (N, K)), -1)
        u = [dict(zip(compact.SLOT_FIELDS, torch.from_numpy(uni).cuda()
                      .unbind(0)))]
        args = dict(Mdev=Mdev, use_spill=spill, spliced=spliced,
                    has_event=True)
    ko = compact.pack_slots(u, **args)
    po = compact.pack_slots_plain(u, **args)
    torch.cuda.synchronize()
    assert sorted(ko) == sorted(po)
    for k in ko:
        _cmp(ko[k], po[k].contiguous(), k)
    if spill and dense >= 0.3:
        assert int(ko["sp_src"][-1]) == -2
    if spill and dense <= 0.01:
        assert int((ko["sp_src"] >= 0).sum()) < N // 4
        assert int(ko["sp_src"][-1]) == -1


def _compact_args(dev, rng, N, H, P, spliced, sampled, P2=32, H2=2,
                  max_intron=500_000, synthetic_sa=False, top_hi=None):
    """Random hits (duplicates, short and long, wide, stopped lanes; tops
    below top_hi, by default len(SA) - 104) and, in spliced mode,
    re-search hits; on a sampled SA the resolved rows."""
    rows = dev.sa.shape[0] - 64
    top_hi = rows - 40 if top_hi is None else top_hi
    sa = dev.sa
    if synthetic_sa:
        # starts near both ends of int32, so that the distances to the 8
        # lowest align-capable starts (and to SENT) wrap
        v = rng.integers(0, 5000, dev.sa.shape[0])
        v[rng.random(len(v)) < 0.05] = 2 ** 31 - 3
        sa = torch.from_numpy(v.astype(np.int32)).cuda()
    top = rng.integers(0, top_hi, (N, H)).astype(np.int32)
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
    kw = dict(sa=sa, top=t(top), bot=t(bot), lo=t(lo), hi=t(hi), nh=t(nh),
              abefore=t(ab), post=t(post), stopped=t(stopped), P=P)
    if sampled:
        kw["offs"] = t(np.where(rng.random((N, H, P)) < 0.9, rng.integers(
            0, 5000, (N, H, P)), 0).astype(np.int32))
    if spliced:
        t2 = rng.integers(0, rows - 40, (N, H2)).astype(np.int32)
        w2 = rng.choice([0, 1, 2, 5, P2, P2 + 1, 2 * P2], (N, H2))
        kw.update(top2=t(t2), bot2=t((t2 + w2).astype(np.int32)),
                  lo2=t(rng.integers(0, 60, (N, H2)).astype(np.int32)),
                  nh2=t(rng.integers(0, H2 + 1, N).astype(np.int32)),
                  P2=P2, max_intron=max_intron)
        if sampled:
            kw["offs2"] = t(rng.integers(0, 5000, (N, H2, P2)).astype(
                np.int32))
    return kw


@pytest.mark.parametrize("case", [
    "dna_meta", "dna_lite", "dna_sampled", "spliced_p32_wrap",
    "spliced_p16_sampled", "spliced_j160", "global"])
def test_compact_cands_random_on_card(card, monkeypatch, case):
    """K3+K4 on random hits over the card fixture's SA: duplicates,
    short and long hits, wide hits, stopped lanes, N not a multiple of
    the warps per block; the lite tier; the walk's offsets of a sampled
    SA; spliced mode (re-search hits at P2 32 and 16, their offsets, J =
    160, starts near both ends of int32 with max_intron 2^31 - 1 so that
    JAX's int32 distances wrap); and a pool of J = 19,200 slots, which
    stages in the global scratch, run again with two blocks' scratch."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.index.format import to_device
    from hisat2_tpu_torch.ops import compact
    g, idx = card
    dev = to_device(idx, "cuda")
    # the DNA cases: seeds 5 and 13, tops below the index's rows less 30
    old = {"dna_meta": 5, "dna_lite": 13}
    rng = np.random.default_rng(old.get(case, sum(map(ord, case))))
    N, H, P, kw = 1999, 6, 10, {}
    spl = case.startswith("spliced")
    if case == "spliced_j160":
        P = 16                                  # 6 * 16 + 2 * 32 = 160
    if case == "global":
        N, H, P = 40, 300, 64
    a = _compact_args(dev, rng, N, H, P, spl, "sampled" in case,
                      P2=16 if "p16" in case else 32,
                      max_intron=2 ** 31 - 1 if "wrap" in case else 500_000,
                      synthetic_sa="wrap" in case,
                      top_hi=idx.meta.rows - 30 if case in old else None)
    kw.update(a, C=11 if case != "global" else 65,
              CC=6 if case != "global" else 65, min_k=9, maxsize=10,
              short_rows=5, lite_cap=8 if case == "dna_lite" else 0,
              lane_meta=case != "dna_lite")
    if case == "global":
        kw["maxsize"] = 64
        assert compact.compact_scratch(H, P, 65, 0, 0, N,
                                       torch.device("cuda")) is not None
    ko = compact.compact_cands(**kw)
    po = compact.compact_candidates_plain(**kw)
    torch.cuda.synchronize()
    for f in ko._fields:
        _cmp(getattr(ko, f), getattr(po, f), f)
    if case == "global":
        with monkeypatch.context() as mp:
            mp.setattr(kernels, "scratch", _scratch_of_blocks(2))
            kt = compact.compact_cands(**kw)
            torch.cuda.synchronize()
        for f in ko._fields:
            _cmp(getattr(kt, f), getattr(po, f), f"{f}, two blocks")


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
            kern, plain = twins[name.split("/")[0]]
            ko = _flat_list(kern(**cap[name]))
            po = _flat_list(plain(**cap[name]))
            assert len(ko) == len(po)
            for x, y in zip(ko, po):
                _cmp(x, y, name)


def test_spliced_kernels_at_16384_lanes_on_card(scard):
    """K13+K14, K15, K16 (lite and full) and K17 on both spliced steps of
    a fused pair batch of 8,192 mates (16,384 lanes, the width a spliced
    paired run gives them), against their plain twins."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    al, _, _, batch = scard
    codes, quals, lens = batch(8192)
    rdids = np.tile(2 * 10 ** 6 + np.arange(4096, dtype=np.int64), 2)
    for a in (al._fast, al):
        rd, ss = a._step_site_args(rdids)
        cap = {}
        a.step(*a.upload(codes, quals, lens, a._minsc(lens)), True,
               capture=cap, rdids=rd, ss=ss)
        want = ["inject_known"] + ([] if a.lite else [
            "pair_sweep", "second_sweep", "search_lanes_live"])
        assert set(want) <= set(cap)
        assert cap["inject_known"]["reads"].shape[0] == 16_384
        for name in want:
            kern, plain = twins[name]
            ko = _flat_list(kern(**cap[name]))
            po = _flat_list(plain(**cap[name]))
            torch.cuda.synchronize()
            assert len(ko) == len(po)
            for x, y in zip(ko, po):
                _cmp(x, y, f"{name} at 16,384 lanes")
            del ko, po
        del cap
        torch.cuda.empty_cache()


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


# --- the junction sweeps K13 + K14 and K15 on seeded random lanes ------------

SWEEP_C = (1, 5, 14, 19, 32, 33, 40)
# 480 and 512: config 6's C = 19 with SNV windows passes a block's shared
# memory from L ~ 475; above 512 step 4's runs of columns span words
SWEEP_L = (60, 100, 150, 250, 480, 512, 513, 1000, 2000)
SENT = 2 ** 31 - 2


@pytest.fixture(scope="module")
def sweep_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from hisat2_tpu_torch import kernels
    kernels.load()


def _pack2(codes):
    """2-bit codes -> the packed int32 words of a reference plane."""
    n = len(codes)
    words = np.zeros((n + 15) // 16 + 128, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     codes.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    return torch.from_numpy(words.view(np.int32)).cuda()


def _sweep_world(C, L, seed, N=96, M=16, n=150_000):
    """N lanes over C candidates of a seeded genome with 40 planted pairs
    of GT-AG introns around a 20-40 bp exon: reads across one or both
    junctions with their exon diagonals, reads with a deletion or an
    insertion, decoys a few bp off (indel joins both ways), far decoys,
    candidates at both text ends, N bases and mismatches, short reads,
    invalid candidates, lanes with no valid pair; SNV planes with a delta
    at ~3% of positions; site tables of the introns (half from file, half
    temp sites with read ids)."""
    from hisat2_tpu_torch.ops import splice
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    introns, seconds = [], []
    for k in range(40):                     # an intron, an exon, an intron
        d = int(rng.integers(3000, n - 30_000))
        D = int(rng.choice([40, 300, 2000, 20_000]))
        e = d + D + int(rng.integers(20, 40))
        D2 = int(rng.choice([60, 500, 3000]))
        for a, b in ((d, D), (e, D2)):
            g[a:a + 2], g[a + b - 2:a + b] = (2, 3), (0, 2)
        introns.append((d, D))
        seconds.append((e, D2))
    deltas = [np.where(rng.random(n) < 0.03, rng.integers(1, 4, n), 0)
              for _ in (0, 1)]
    reads = np.full((N, L), 4, np.int32)
    starts = np.zeros((N, C), np.int32)
    valid = np.ones((N, C), bool)
    lens = np.full(N, L, np.int32)
    for i in range(N):
        d, D = introns[i % len(introns)]
        e, D2 = seconds[i % len(introns)]
        x = int(rng.integers(4, L - 4))
        s0 = d - x
        r = np.concatenate([g[s0:d], g[d + D:d + D + L - x]])
        row = [s0, s0 + D]
        if i % 4 == 1:                      # across both introns
            x = int(rng.integers(4, max(5, L - (e - d - D) - 4)))
            s0 = d - x
            r = np.concatenate([g[s0:d], g[d + D:e],
                                g[e + D2:e + D2 + L]])[:L]
            row = [s0, s0 + D, s0 + D + D2]
        elif i % 8 == 6:                    # a 3 bp deletion
            r = np.concatenate([g[s0:s0 + x], g[s0 + x + 3:s0 + L + 3]])
            row = [s0, s0 + 3]
        elif i % 8 == 7:                    # a 2 bp insertion
            r = np.concatenate([g[s0:s0 + x], [1, 2], g[s0 + x:s0 + L]])[:L]
            row = [s0, s0 - 2]
        elif i % 9 == 4:                    # both text ends
            row = [-int(rng.integers(1, 12)), n - L + int(rng.integers(1, 12))]
            r = g[:L].copy()
        row += [s0 + int(rng.integers(1, 12)), s0 - int(rng.integers(1, 6)),
                s0 + D + int(rng.integers(-4, 5)), int(rng.integers(0, n)),
                s0 + 45_000]
        while len(row) < C:
            row.append(int(rng.integers(-20, n + 20)))
        starts[i] = row[:C]
        r = r.astype(np.int32)
        if i % 3 == 0:                      # catalog alleles on the 1st exon
            for q in range(min(x, L)):
                v = deltas[q % 2][s0 + q] if 0 <= s0 + q < n else 0
                if v:
                    r[q] = (g[s0 + q] + v) & 3
        for q in rng.choice(L, int(rng.integers(0, 4)), replace=False):
            r[q] = (r[q] + 1 + int(rng.integers(0, 3))) % 4
        if i % 5 == 2:
            r[int(rng.integers(0, L))] = 4
        reads[i] = r
        if i % 6 == 3:
            lens[i] = L - int(rng.integers(1, L // 3))
            reads[i, lens[i]:] = 4
        valid[i] = rng.random(C) > 0.15
        if i % 11 == 0:
            valid[i] = False                # no valid pair
        if i % 13 == 1:
            valid[i] = False
            valid[i, 0] = True              # one valid candidate
    quals = rng.integers(0, 42, (N, L)).astype(np.int32)
    mm_pen = np.array([2 + min(q, 40) * 4 // 40 for q in range(64)],
                      np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    st, vd = t(starts), t(valid)
    mstart = torch.where(vd, st, -1).to(torch.int32).contiguous()
    words = _pack2(g)
    snv = [_pack2(v) for v in deltas]
    win = lambda w: splice.diag_chars_plain(w, n, mstart, L, M)  # noqa
    kw = dict(ch=win(words).contiguous(), reads=t(reads), quals=t(quals),
              lens=t(lens), starts=st, valid=vd,
              minsc=t((-(lens // 4) - 2).astype(np.int32)),
              mm_pen=t(mm_pen), n_pen=1, n_text=n,
              prm=splice.SpliceParams(), margin=M)
    kw["lenpen"] = splice.lenpen_device(kw["prm"], "cuda")
    s1w, s2w = (win(w).contiguous() for w in snv)
    kd = np.array([d - 1 for d, _ in introns + seconds], np.int64)
    ka = np.array([d + D for d, D in introns + seconds], np.int64)
    rdid = np.where(np.arange(len(kd)) % 2 == 0, -1,
                    rng.integers(0, 3 * N, len(kd)))
    rdids = t(rng.integers(0, 3 * N, N).astype(np.int32))
    return kw, (s1w, s2w), (kd, ka, rdid), rdids


def _site_tabs(kd, ka, rdid, n, lob, cap=None):
    """SpliceSiteDB.device_tables' layout of the sites, on the card (cap:
    the tables' rows, the sites padded with sentinels)."""
    nn = len(kd)
    cap = cap or 1 << nn.bit_length()
    o, o2 = np.lexsort((ka, kd)), np.lexsort((kd, ka))
    t = {}
    for nm, v, f in (("ss_kd", kd[o], SENT), ("ss_ka", ka[o], SENT),
                     ("ss_rdid", rdid[o], -1), ("ss_ka_s", ka[o2], SENT),
                     ("ss_kd_s", kd[o2], SENT), ("ss_rdid_a", rdid[o2], -1)):
        a = np.full(cap, f, np.int32)
        a[:nn] = v
        t[nm] = torch.from_numpy(a).cuda()
    if lob:
        shift = max(0, (n - 1).bit_length() - (1 << 19).bit_length() + 1)
        edges = np.arange((1 << 19) + 1, dtype=np.int64) << shift
        for nm, col in (("ss_kd_lob", "ss_kd"), ("ss_ka_lob", "ss_ka_s")):
            t[nm] = torch.from_numpy(np.searchsorted(
                t[col].cpu().numpy()[:nn], edges).astype(np.int32)).cuda()
        t["ss_shift"] = shift
    return t


def _scratch_of_blocks(blocks):
    """A stand-in for kernels.scratch that gives a kernel the global
    scratch of `blocks` blocks (the query's bytes for one lane, or one pool
    of candidates, times `blocks`), so that the kernel launches that many
    blocks and each walks many lanes through its one slice."""
    from hisat2_tpu_torch import kernels
    real = kernels.scratch

    def cut(symbol, argtypes, *args, dev):
        one = real(symbol, argtypes, *args[:-1], 1, dev=dev)
        if one is None:
            return None
        return torch.empty(blocks * one.numel(), dtype=torch.uint8,
                           device=dev)
    return cut


def _same(a, b, what):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("L", SWEEP_L)
@pytest.mark.parametrize("C", SWEEP_C)
def test_junction_sweeps_random_on_card(sweep_card, monkeypatch, C, L):
    """K13 + K14 (SNV windows off and on) and the two-pair K15 (site tables
    none, sorted and with the bucket index) against their plain twins on
    seeded random lanes, f32 fields by their bits; where a lane's planes
    pass a block's shared memory the kernels stage them in their global
    scratch, and there they are held twice: over the grid they ask for,
    and given the scratch of two blocks, so that each block walks half
    the lanes through its one slice."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    kw, (s1w, s2w), sites, rdids = _sweep_world(
        C, L, 100 * C + L, N=96 if L <= 250 else 32)
    W, LP = kw["ch"].shape[2], kw["lenpen"][1].shape[1]
    k13 = dict(kw, max_gap=10, top=min(4, C * C))
    staged = [splice.sweep_launch_info("pair_sweep", C, L, W, LP, snv)[
        "scratch_per_block"] > 0 for snv in (False, True)]
    staged.append(splice.sweep_launch_info("second_sweep", C, L, W, LP)[
        "scratch_per_block"] > 0)
    if (C, L) in ((14, 100), (19, 250)):
        assert not any(staged), staged
    if (C, L) == (19, 512):              # config 6's shape, SNV windows
        assert staged[:2] == [False, True], staged
    if (C, L) in ((40, 1000), (19, 2000)):
        assert all(staged), staged
    for snv in (False, True):
        a = dict(k13, snv1_w=s1w, snv2_w=s2w) if snv else k13
        po = splice.pair_sweep_ref(**a)
        if not snv:
            res, bsel = po[0], po[2]
        for blocks in (None, 2)[:1 + staged[snv]]:
            with monkeypatch.context() as mp:
                if blocks:
                    mp.setattr(kernels, "scratch", _scratch_of_blocks(blocks))
                n0 = kernels.KERNELS["pair_sweep"].launches
                ko = splice.pair_sweep(**a)
                torch.cuda.synchronize()
            assert kernels.KERNELS["pair_sweep"].launches == n0 + 1
            what = (f"C={C} L={L} snv={snv} global={staged[snv]} "
                    f"blocks={blocks}")
            for part, (x, y) in enumerate(zip(ko[:2], po[:2])):
                for f in y:
                    _same(x[f], y[f], f"{what} part {part} {f}")
            _same(ko[2], po[2], f"{what} base pairs")
    # K15: the q2 / r2 base pairs as the step builds them, and one of
    # random pairs (x from -1 to L + 1, invalid scores, b_valid mixed)
    N = kw["starts"].shape[0]
    rng = np.random.default_rng(C * L)
    bflat = bsel.long().t()
    gp = lambda a: a.reshape(N, C * C).gather(1, bflat.t()).t()  # noqa
    b_score, b_kind = gp(res["raw"]), gp(res["kind"])
    pairs = dict(b_i=(bflat // C).int(), b_j=(bflat % C).int(),
                 b_x=gp(res["x"]), b_score=b_score,
                 b_valid=(b_score > -(2 ** 29)) & (b_kind != 0))
    rnd = dict(b_i=rng.integers(0, C, N), b_j=rng.integers(0, C, N),
               b_x=rng.integers(-1, L + 2, N),
               b_score=np.where(rng.random(N) < 0.2, -(2 ** 30),
                                -rng.integers(0, 40, N)),
               b_valid=rng.random(N) < 0.8)
    for k, v in rnd.items():
        v = torch.from_numpy(v.astype(bool if k == "b_valid" else np.int32))
        pairs[k] = torch.stack([pairs[k][0], v.cuda()]).contiguous()
    for lob in (None, False, True):
        ss = None if lob is None else _site_tabs(*sites, kw["n_text"], lob)
        a = dict(kw, **pairs, ss=ss, rdids=rdids if ss is not None else None)
        po = splice.second_sweep_ref(**a)
        for blocks in (None, 2)[:1 + staged[2]]:
            with monkeypatch.context() as mp:
                if blocks:
                    mp.setattr(kernels, "scratch", _scratch_of_blocks(blocks))
                n0 = kernels.KERNELS["second_sweep"].launches
                ko = splice.second_sweep(**a)
                torch.cuda.synchronize()
            assert kernels.KERNELS["second_sweep"].launches == n0 + 1
            for t in range(2):
                for side in ("right", "left"):
                    for f in po[t][side]:
                        _same(ko[t][side][f], po[t][side][f],
                              f"C={C} L={L} sites={lob} global={staged[2]} "
                              f"blocks={blocks} pair {t} {side} {f}")


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


KNOWN_L = (31, 100, 129, 600, 2000)
KNOWN_C = (6, 14, 40)


def _known_world(rng, C, L, N, n=60_000, M=16):
    """K16's inputs on the card: N lanes of reads copied from a seeded
    genome at their first candidate (mutations, N chars, mixed lengths
    down to 2), C candidates each, mostly in the text and some past
    either end (their windows all 4s), invalid ones, inherited clips; SNV
    planes with a delta at 5% of positions."""
    from hisat2_tpu_torch.ops import splice
    g = rng.integers(0, 4, n).astype(np.uint8)
    lens = np.where(rng.random(N) < 0.3, rng.integers(2, L + 1, N),
                    L).astype(np.int32)
    starts = rng.integers(-L // 2, n - L // 2, (N, C))
    u = rng.random((N, C))
    starts = np.where(u < 0.05, rng.integers(-3 * L, 0, (N, C)), starts)
    starts = np.where(u > 0.95, rng.integers(n - L, n + 2 * L, (N, C)),
                      starts).astype(np.int32)
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    for i in range(N):
        p = starts[i, 0] + np.arange(L)
        inside = (p >= 0) & (p < n)
        reads[i, inside] = g[p[inside]]
        mut = rng.random(L) < 0.03
        reads[i, mut] = (reads[i, mut] + 1) % 4
        reads[i, rng.random(L) < 0.01] = 4
    quals = rng.integers(0, 42, (N, L)).astype(np.int32)
    clip = lambda: np.where(rng.random((N, C)) < 0.3,  # noqa
                            rng.integers(0, L + 1, (N, C)), 0).astype(
                                np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    words = _pack2(g)
    st = t(starts)
    kw = dict(ref_words=words, n_text=n, reads=t(reads), quals=t(quals),
              lens=t(lens), rdids=t(rng.integers(0, 1000, N).astype(
                  np.int32)), starts=st, valid=t(rng.random((N, C)) > 0.1),
              ch=splice.diag_chars_plain(words, n, st, L, M).contiguous(),
              margin=M, mm_pen=t(np.array([2 + min(q, 40) * 4 // 40
                                           for q in range(64)], np.int32)),
              n_pen=1, minsc=t(np.where(rng.random(N) < 0.5, -(2 ** 31),
                                        -(lens // 3)).astype(np.int32)),
              src_clip_l=t(clip()), src_clip_r=t(clip()),
              clip_pen=t(np.array([1 + min(q, 40) // 20 for q in range(64)],
                                  np.int32)))
    deltas = [np.where(rng.random(n) < 0.05, rng.integers(1, 4, n), 0)
              for _ in (0, 1)]
    snv_w = [splice.diag_chars_plain(_pack2(v), n, st, L, M).contiguous()
             for v in deltas]
    snv = dict(snv1_w=snv_w[0], snv2_w=snv_w[1],
               snv_delta1=_pack2(deltas[0]), snv_delta2=_pack2(deltas[1]))
    return kw, starts, lens, snv


def _known_sites(rng, mode, starts, lens, n):
    """Site tables for K16 (kd, ka, rdid, rows): `dense` five donor-keyed
    and five acceptor-keyed sites inside every candidate's read span (x =
    1 and len - 1 among them, repeated keys, visible); `none` sites only
    where no read sees them (temp sites of later reads, or far off);
    `mixed` sites at a tenth of the candidates, half of them temp sites;
    `one` a table of one row; `tail` a few sites above most keys, so that
    lo + t passes the table's end."""
    N, C = starts.shape
    st = starts.astype(np.int64).ravel()
    ln = np.repeat(lens.astype(np.int64), C)
    if mode == "one":
        return (np.array([st[0] + max(ln[0] // 2 - 1, 0)]),
                np.array([st[0] + ln[0] + 700]), np.array([-1]), 1)
    if mode == "tail":
        kd = np.sort(st)[-3:] + 1
        return kd, kd + 400, np.full(3, -1), None
    pick = (np.ones(len(st), bool) if mode in ("dense", "none")
            else rng.random(len(st)) < 0.1)
    st, ln = st[pick], ln[pick]
    span = np.maximum(ln - 1, 1)
    u = rng.integers(0, span)
    u[::7] = 0                              # x = 1
    u[3::7] = np.maximum(ln[3::7] - 2, 0)   # x = len - 1
    # five keys a candidate, so that its first five slots each way find a
    # site in its span
    ks = np.arange(5 if mode == "dense" else 1)[:, None]
    kd = (st + np.minimum(u + ks, span - 1)).ravel()
    ka = kd + rng.integers(-50, 5000, len(kd))
    ka2 = (st + 1 + np.minimum(rng.integers(0, span) + ks, span - 1)).ravel()
    kd2 = ka2 - rng.integers(-50, 5000, len(ka2))
    kd, ka = np.concatenate([kd, kd2]), np.concatenate([ka, ka2])
    kd = np.concatenate([kd, kd[:5]])       # repeated keys
    ka = np.concatenate([ka, ka[:5] + 3])
    rdid = np.full(len(kd), -1)
    if mode == "none":
        far = rng.random(len(kd)) < 0.5
        kd = np.where(far, kd + 3 * n, kd)
        ka = np.where(far, ka + 3 * n, ka)
        rdid = np.where(far, -1, 5000)      # later than every read
    if mode == "mixed":
        rdid = np.where(rng.random(len(kd)) < 0.5, -1,
                        rng.integers(0, 1000, len(kd)))
    return kd, ka, rdid, None


@pytest.mark.parametrize("L", KNOWN_L)
@pytest.mark.parametrize("C", KNOWN_C)
def test_inject_known_random_on_card(sweep_card, C, L):
    """K16 against its plain twin on random lanes, its work list stressed:
    every slot live (two and five slots a candidate; at five a block's
    list fills and is walked before the probes end), none live, a tenth
    live with temp sites, a one-row table, probes past the table's end;
    with and without the bucket index and the SNV planes."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    rng = np.random.default_rng(C * 10_000 + L)
    N = 64 if L <= 129 else 16 if L <= 600 else 6
    kw, starts, lens, snv = _known_world(rng, C, L, N)
    n = kw["n_text"]
    cases = [("dense", 2, False, False), ("dense", 5, True, True),
             ("none", 2, True, False), ("mixed", 2, False, True),
             ("mixed", 3, True, False), ("one", 2, False, False),
             ("tail", 2, True, True)]
    for mode, slots, lob, use_snv in cases:
        kd, ka, rdid, cap = _known_sites(rng, mode, starts, lens, n)
        a = dict(kw, tabs=_site_tabs(kd, ka, rdid, n, lob, cap),
                 slots=slots, **(snv if use_snv else {}))
        po = splice.inject_known_ref(**a)
        n0 = kernels.KERNELS["inject_known"].launches
        ko = splice.inject_known(**a)
        torch.cuda.synchronize()
        assert kernels.KERNELS["inject_known"].launches == n0 + 1
        what = f"C={C} L={L} {mode} slots={slots} lob={lob} snv={use_snv}"
        for f in po:
            _same(ko[f], po[f], f"{what} {f}")
        _, _, ok = splice.known_probes(a["starts"], a["valid"], a["lens"],
                                       a["rdids"], a["tabs"], slots)
        share = float(ok.float().mean())
        if mode == "dense":
            assert share > 0.6, (what, share)
        if mode == "none":
            assert share == 0.0, (what, share)


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


@pytest.mark.parametrize("M", [0, 1, 1023, 1024, 1025, 100_003,
                               2_000_003])
@pytest.mark.parametrize("density", [0.02, 0.001, 0.3])
def test_resolve_walk_sparse_shapes_on_card(walk_card, M, density):
    """K20 at live densities of 2%, 0.1% and 30% over M rows (none, one, a
    tile of 1,024 rows and either side of it, and runs where each block
    sweeps several tiles and carries rows it has not walked from one tile
    to the next), rows repeated (drawn from 5,000 distinct rows), the
    last rows live so that the last block has work."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import resolve
    _, idxs = walk_card
    idx, d = idxs[4]
    rng = np.random.default_rng(M % 997 + int(density * 1000))
    pool = rng.integers(0, idx.meta.rows, 5_000)
    row = torch.from_numpy(pool[rng.integers(0, 5_000, M)].astype(
        np.int32)).cuda()
    lv = rng.random(M) < density
    lv[-3:] = True
    live = torch.from_numpy(lv).cuda()
    args = (d.blocked, d.fchr, d.sa, idx.meta.zrow, 4, row, live)
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
            kern, plain = twins[name.split("/")[0]]
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


# --- the indel sweep K8 on seeded random lanes -------------------------------

INDEL_L = (100, 151, 512)
INDEL_G = (1, 5, 17, 19, 27, 32)


def _indel_world(rng, N, C, L, G, live):
    """N lanes of C candidates with a margin of max(16, G): windows that
    hold the read with a planted deletion or insertion of 1..G, random
    windows, runs of N (100000 a column) and lanes of dense mismatches;
    short reads, N bases and random qualities; SNV-plane windows with a
    delta at ~5% of the columns; `valid` at the given live share."""
    M = max(16, G)
    W = L + 2 * M
    ch = rng.integers(0, 4, (N, C, W)).astype(np.int32)
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    lens = np.full(N, L, np.int32)
    lens[::4] = L - rng.integers(1, L // 3, len(lens[::4]))
    for n in range(N):
        reads[n, lens[n]:] = 4
        for c in range(C - 1):
            g = int(rng.integers(1, G + 1))
            x = int(rng.integers(1, max(2, lens[n] - g)))
            seg = reads[n, :L].copy()
            if c % 2:       # an insertion of g in the read: drop it here
                seg = np.concatenate([seg[:x], seg[x + g:],
                                      rng.integers(0, 4, g)])
            else:           # a deletion of g in the read: add it here
                seg = np.concatenate([seg[:x], rng.integers(0, 4, g), seg])
            ch[n, c, M:M + L] = np.where(seg[:L] > 3, 0, seg[:L])
        if n % 5 == 1:      # dense mismatches
            ch[n][rng.random((C, W)) < 0.5] = rng.integers(0, 4)
        if n % 3 == 2:      # a run of N in each window
            for c in range(C):
                a = int(rng.integers(0, W - 8))
                ch[n, c, a:a + int(rng.integers(4, 48))] = 4
    reads[rng.random(reads.shape) < 0.01] = 4
    quals = rng.integers(0, 42, (N, L)).astype(np.int32)
    starts = rng.integers(-5, 10 ** 7, (N, C)).astype(np.int32)
    valid = rng.random((N, C)) < live
    minsc = (-(rng.integers(L // 10, L, N))).astype(np.int32)
    minsc[::7] = -10 ** 6
    snv = tuple(np.where(rng.random((N, C, W)) < 0.05,
                         rng.integers(1, 4, (N, C, W)), 0).astype(np.int32)
                for _ in range(2))
    return ch, reads, quals, lens, starts, valid, minsc, snv


def _indel_both(kw, what):
    """K8 against its plain twin on these arguments (one launch)."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    n0 = kernels.KERNELS["indel_sweep"].launches
    ko = splice.self_indel_sweep(**kw)
    po = splice.self_indel_sweep_plain(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["indel_sweep"].launches == n0 + 1, what
    assert sorted(ko) == sorted(po), what
    for k in po:
        _same(ko[k], po[k], f"{what} {k}")
    return po


@pytest.mark.parametrize("G", INDEL_G)
@pytest.mark.parametrize("L", INDEL_L)
def test_indel_sweep_random_on_card(sweep_card, L, G):
    """K8 against its plain twin with and without SNV windows at live
    shares 0, 0.1 and 1, including L = 512 with G = 27 and 32 (above the
    227 KB a block can use in the earlier design); dead rows are the
    constant row."""
    from hisat2_tpu_torch.ops import splice
    from hisat2_tpu_torch.align.scoring import Scoring
    rng = np.random.default_rng(1000 * L + G)
    mm_pen = torch.from_numpy(Scoring().mm_pen_table()).cuda()
    prm = splice.SpliceParams(allow_spliced=False)
    for live in (0.0, 0.1, 1.0):
        ch, reads, quals, lens, starts, valid, minsc, snv = _indel_world(
            rng, 48, 6, L, G, live)
        ch, reads, quals, lens, starts, valid, minsc, *snv = (
            torch.from_numpy(a).cuda() for a in (ch, reads, quals, lens,
                                                 starts, valid, minsc, *snv))
        for use_snv in (False, True):
            kw = dict(ch=ch, reads=reads, quals=quals, lens=lens,
                      starts=starts, valid=valid, minsc=minsc,
                      mm_pen=mm_pen, n_pen=1, prm=prm, max_gap=G,
                      snv1_w=snv[0] if use_snv else None,
                      snv2_w=snv[1] if use_snv else None)
            po = _indel_both(kw, f"L={L} G={G} live={live} snv={use_snv}")
            dead = ~kw["valid"]
            for p in ("", "w_"):
                assert bool((po[p + "score"][dead] == -2 ** 30).all())
                assert torch.equal(po[p + "d1"][dead], kw["starts"][dead])
            if live == 1.0 and G >= 5:
                assert bool((po["kind"] != 0).any())


def test_indel_sweep_wrapped_key_on_card(sweep_card):
    """The int32 key wrap (G = 18, L = 300: a read of A against a window
    of C with six N columns): the kernel emits JAX's +524288 deletion row,
    as the twin does."""
    from hisat2_tpu_torch.ops import splice
    from hisat2_tpu_torch.align.scoring import Scoring
    L, G = 300, 18
    ch = np.ones((1, 1, L + 2 * G), np.int32)
    ch[0, 0, G + 100:G + 106] = 4
    i32 = torch.int32
    kw = dict(ch=torch.from_numpy(ch).cuda(),
              reads=torch.zeros((1, L), dtype=i32).cuda(),
              quals=torch.full((1, L), 40, dtype=i32).cuda(),
              lens=torch.tensor([L], dtype=i32).cuda(),
              starts=torch.zeros((1, 1), dtype=i32).cuda(),
              valid=torch.ones((1, 1), dtype=torch.bool).cuda(),
              minsc=torch.tensor([-60], dtype=i32).cuda(),
              mm_pen=torch.from_numpy(Scoring().mm_pen_table()).cuda(),
              n_pen=1, prm=splice.SpliceParams(allow_spliced=False),
              max_gap=G)
    po = _indel_both(kw, "wrapped key")
    assert [int(po[f][0, 0]) for f in ("score", "d1", "d2", "x", "kind")] \
        == [524288, -1, 0, 7, 2]


# --- every read length on the DNA paths (K1/K17, K6+K7, K8, K12) -------------

EXT_L = (36, 75, 100, 151, 250, 512, 513, 600, 1100, 2000)


def _extend_world(rng, words, n_text, B, C, L, live, snv_words, ties):
    """B lanes of C slots, windows made by K5's twin from the starts (the
    kernel's contract): starts at a live share `live` drawn from a few
    diagonals per lane (repeats within a lane, some past the text ends),
    the rest -1; reads from the text with mismatches, Ns, garbage ends and
    shorter lengths; optionally the two clip-gain tie rows."""
    from hisat2_tpu_torch.ops import splice
    g_at = rng.integers(0, n_text - L, B)
    ref = splice.diag_chars_plain(words, n_text,
                                  torch.from_numpy(g_at[:, None].astype(
                                      np.int32)).to(words.device), L, 0)
    reads = ref[:, 0].cpu().numpy().astype(np.int32).copy()
    reads[reads > 3] = 0
    lens = np.full(B, L, np.int32)
    for i in range(B):
        for p in rng.integers(0, L, int(rng.integers(0, 2 + L // 30))):
            reads[i, p] = (reads[i, p] + 1) % 4
        if i % 4 == 1:
            reads[i, :int(rng.integers(1, 12))] = int(rng.integers(0, 4))
        if i % 4 == 2:
            reads[i, L - int(rng.integers(1, 12)):] = (reads[i, -1] + 1) % 4
        if i % 5 == 0:
            reads[i, int(rng.integers(0, L))] = 4
        if i % 3 == 0 and L > 20:
            lens[i] = L - int(rng.integers(1, 20))
            reads[i, lens[i]:] = 4
    quals = rng.integers(0, 42, (B, L)).astype(np.int32)
    quals[::2] = 40
    st = np.full((B, C), -1, np.int64)
    for i in range(B):
        diag = [g_at[i], g_at[i] + int(rng.integers(-3, 4)),
                int(rng.integers(-60, n_text + 60)), n_text - L // 3,
                -(L // 4)]
        for j in range(C):
            if rng.random() < live:
                st[i, j] = diag[int(rng.integers(0, len(diag)))]
    if ties and B >= 2:
        for i in (0, 1):
            st[i, 0] = g_at[i]
            lens[i] = L
            quals[i] = 40
            reads[i] = np.minimum(ref[i, 0].cpu().numpy(), 3)
        reads[0, [0, 8, 9]] = (reads[0, [0, 8, 9]] + 1) % 4
        quals[0, 1:8], quals[0, 8], quals[0, 9] = 0, 30, 20
        reads[1, [L - 10, L - 9, L - 1]] = (reads[1, [L - 10, L - 9, L - 1]]
                                            + 1) % 4
        quals[1, 1:10], quals[1, L - 10], quals[1, L - 9] = 0, 30, 20
    dev = words.device
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(dev)
    stt = t(st)
    margin = 16
    win = splice.diag_chars_plain(words, n_text, stt, L, margin)
    s1 = s2 = None
    if snv_words is not None:
        s1, s2 = (splice.diag_chars_plain(w, n_text, stt, L, margin)
                  for w in snv_words)
    minsc = t(np.array([int(-0.6 - 0.6 * x) for x in lens]))
    return dict(n_text=n_text, reads=t(reads), quals=t(quals), lens=t(lens),
                cand_start=stt, win_chars=win, win_margin=margin,
                minsc=minsc, snv1_win=s1, snv2_win=s2)


@pytest.mark.parametrize("L", EXT_L)
def test_extend_ungapped_random_on_card(card, L):
    """K6+K7 against its plain twin at C in {1, 6, 8, 19}, live shares 0,
    0.1, 0.5 and 1 with repeated starts within lanes, uniform_len on and
    off, soft clipping off, minsc None, SNV windows on and off, and the
    clip-gain ties; one evaluation per distinct (lane, start) gives the
    twin's row to every slot."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.index.format import score_tables, to_device
    from hisat2_tpu_torch.ops import extend
    g, idx = card
    dev = to_device(idx, "cuda")
    tabs = score_tables(Scoring(), "cuda")
    rng = np.random.default_rng(7000 + L)

    def snv_plane():
        # a delta of 1-3 at ~5% of the text's columns, 2-bit packed
        nw = dev.ref_words.shape[0]
        d = np.where(rng.random(16 * nw) < 0.05,
                     rng.integers(1, 4, 16 * nw), 0).astype(np.uint32)
        w = (d.reshape(nw, 16) << (2 * np.arange(16, dtype=np.uint32))).sum(
            1, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).cuda()
    snv_words = (snv_plane(), snv_plane())
    B = 48 if L <= 512 else 16
    cases = [(1, 1.0, {}), (6, 0.1, {}), (6, 0.5, {"uniform_len": True}),
             (8, 1.0, {"snv": True}), (19, 0.0, {}),
             (19, 0.1, {"snv": True}), (6, 0.5, {"allow_softclip": False}),
             (8, 0.5, {"minsc": None})]
    for C, live, opt in cases:
        opt = dict(opt)
        snv = opt.pop("snv", False)
        kw = _extend_world(rng, dev.ref_words, idx.meta.n, B, C, L, live,
                           snv_words if snv else None, ties=C > 1)
        if opt.get("uniform_len"):
            kw["lens"] = torch.full_like(kw["lens"], L)
        kw.update(mm_pen=tabs["mm_pen"], clip_pen=tabs["clip_pen"],
                  n_pen=1, mm_min=2, **opt)
        n0 = kernels.KERNELS["extend_ungapped"].launches
        ko = extend.extend_grouped(**kw)
        po = extend.extend_grouped_plain(**kw)
        torch.cuda.synchronize()
        what = f"L={L} C={C} live={live} {opt}"
        assert kernels.KERNELS["extend_ungapped"].launches == n0 + 1, what
        for f in po._fields:
            _eq(getattr(ko, f), getattr(po, f), f"{what} {f}")
        if C > 1 and opt.get("allow_softclip", True) and not snv:
            assert int(po.clip_l[0, 0]) == 10 and int(po.clip_r[1, 0]) == 10


@pytest.mark.parametrize("L", [513, 600, 1100, 2000])
def test_fm_search_long_reads_on_card(card, L):
    """K1 dense and in its lane-list mode (K17) above the 512 bp the round
    log held in local memory: the log goes to the rounds rows."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.index.format import to_device
    from hisat2_tpu_torch.ops import search
    g, idx = card
    dev = to_device(idx, "cuda")
    m = idx.meta
    rng = np.random.default_rng(L)
    _, reads, lens, _ = _reads(rng, g, 256, L)
    rd, ln = (torch.from_numpy(a).cuda() for a in (reads, lens))
    a = search.partial_search2(dev.blocked, dev.fchr, dev.ftab2_top, m.zrow,
                               m.zrow2, m.rows, rd, ln, 6, 16, 9)
    b = search.partial_search2_plain(dev.blocked, dev.fchr, dev.ftab2_top,
                                     m.zrow, m.zrow2, m.rows, rd, ln, 6, 16,
                                     9)
    for f in a._fields:
        _eq(getattr(a, f), getattr(b, f), f"L={L} {f}")
    assert int(a.nrounds.max()) > 0
    cut = ln.clone()
    cut[::3] = 5                                  # dead lanes
    cut[1::3] = torch.clamp(cut[1::3] // 2, min=17)
    n0 = kernels.KERNELS["search_lanes_live"].launches
    k = search.search_lanes_live(dev.blocked, dev.fchr, dev.ftab2_top,
                                 m.zrow, m.zrow2, m.rows, rd, cut, 2, 16, 9,
                                 chunk=64)
    p = search.search_lanes_live_ref(dev.blocked, dev.fchr, dev.ftab2_top,
                                     m.zrow, m.zrow2, m.rows, rd, cut, 2,
                                     16, 9, chunk=64)
    torch.cuda.synchronize()
    assert kernels.KERNELS["search_lanes_live"].launches == n0 + 1
    for f in k._fields:
        _eq(getattr(k, f), getattr(p, f), f"L={L} lane list {f}")


@pytest.mark.parametrize("L,G", [(513, 5), (600, 19), (1100, 5),
                                 (1100, 19), (1100, 27), (2000, 27),
                                 (6500, 5)])
def test_indel_sweep_long_reads_on_card(sweep_card, monkeypatch, L, G):
    """K8 against its plain twin above the former 1024 bp cap, with and
    without SNV windows; at L = 6500 one warp's buffers outgrow the shared
    memory a block can use and the kernel stages them in its global
    scratch, held again with the scratch of one block (its three pools of
    candidates walked by one block's warps)."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    from hisat2_tpu_torch.align.scoring import Scoring
    rng = np.random.default_rng(L + G)
    mm_pen = torch.from_numpy(Scoring().mm_pen_table()).cuda()
    prm = splice.SpliceParams(allow_spliced=False)
    N = 16 if L < 5000 else 12
    ch, reads, quals, lens, starts, valid, minsc, snv = _indel_world(
        rng, N, 6, L, G, 0.3)
    ch, reads, quals, lens, starts, valid, minsc, *snv = (
        torch.from_numpy(a).cuda() for a in (ch, reads, quals, lens, starts,
                                             valid, minsc, *snv))
    W = ch.shape[2]
    staged = splice._indel_sweep_scratch(L, W, G, False, N * 6, ch.device)
    assert (staged is not None) == (L > 5000)
    for use_snv in (False, True):
        kw = dict(ch=ch, reads=reads, quals=quals, lens=lens, starts=starts,
                  valid=valid, minsc=minsc, mm_pen=mm_pen, n_pen=1, prm=prm,
                  max_gap=G, snv1_w=snv[0] if use_snv else None,
                  snv2_w=snv[1] if use_snv else None)
        _indel_both(kw, f"L={L} G={G} snv={use_snv}")
        if staged is not None:
            with monkeypatch.context() as mp:
                mp.setattr(kernels, "scratch", _scratch_of_blocks(1))
                _indel_both(kw, f"L={L} G={G} snv={use_snv} one block")


@pytest.mark.parametrize("L", [513, 600, 1100, 2000])
def test_rescue_window_long_mates_on_card(card, L):
    """K12 on mates above its former 1024 bp cap and around 512 (the
    read's words in dynamic shared memory), with windows inside the text,
    at its start and past its end."""
    from hisat2_tpu_torch.index.format import to_device
    from hisat2_tpu_torch.ops import rescue
    g, idx = card
    dev = to_device(idx, "cuda")
    n, W, R = idx.meta.n, 57344, 12
    rng = np.random.default_rng(L)
    reads = np.zeros((R, L), np.int32)
    ws = np.zeros(R, np.int64)
    for i in range(R):
        s = int(rng.integers(0, n - L))
        reads[i] = g[s:s + L]
        ws[i] = (s - int(rng.integers(0, W - L))) // 56320 * 56320
    ws[1], ws[2] = -56320, n - 1000
    reads[3, ::17] = 4
    rd = torch.from_numpy(reads).cuda()
    wst = torch.from_numpy(ws.astype(np.int32)).cuda()
    k = rescue.rescue_window(dev.ref_words, n, rd, wst, W)
    p = rescue.rescue_window_plain(dev.ref_words, n, rd, wst, W)
    torch.cuda.synchronize()
    _eq(k, p, f"rescue_window L={L}")


@pytest.fixture(scope="module")
def long_card(card, tmp_path_factory):
    """Linear and graph aligners on the card and the CPU over the card
    fixture's genome (the graph with a catalog of SNVs and indels), with
    a repeat for mate rescue."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    g, _ = card
    g = g.copy()
    rng = np.random.default_rng(1101)
    unit = rng.integers(0, 4, 1200).astype(np.uint8)
    for k in range(24):                 # 24 copies: the mate needs rescue
        g[150_000 + 5_000 * k:150_000 + 5_000 * k + 1200] = unit
    lin = build_fm_index([("c", g)])
    gidx = build_fm_index([("c", g)])
    snp = tmp_path_factory.mktemp("long") / "v.snp"
    pos = np.sort(rng.choice(np.arange(1_000, len(g) - 1_000), 300,
                             replace=False))
    with open(snp, "w") as f:
        for i, p in enumerate(pos):
            if i % 3 == 0:
                f.write(f"d{i}\tdeletion\tc\t{p}\t{int(rng.integers(1, 6))}"
                        f"\n")
            elif i % 3 == 1:
                alt = "ACGT"[(int(g[p]) + 1) % 4]
                f.write(f"s{i}\tsingle\tc\t{p}\t{alt}\n")
            else:
                f.write(f"i{i}\tinsertion\tc\t{p}\tACG\n")
    attach_variants(gidx, snp_file=str(snp))
    out = {}
    for name, ix, var in (("linear", lin, None),
                          ("graph", gidx, gidx._variants)):
        out[name] = (TorchAligner(ix, device="cuda", variants=var),
                     TorchAligner(ix, device="cpu", variants=var))
    return g, out


def _long_batch(rng, g, B, Lmax):
    """B reads of 100-300 bp and one of Lmax bp from g, with mismatches,
    some reverse-complemented."""
    lens = rng.integers(100, 301, B).astype(np.int32)
    lens[0] = Lmax
    codes = np.full((B, Lmax), 4, np.uint8)
    for i in range(B):
        s = int(rng.integers(0, len(g) - Lmax))
        r = g[s:s + lens[i]].copy()
        r[rng.integers(0, lens[i], 2)] ^= 1
        if i % 2:
            r = (3 - r)[::-1]
        codes[i, :lens[i]] = r
    quals = rng.integers(5, 41, (B, Lmax)).astype(np.uint8)
    return codes, quals, lens


@pytest.mark.parametrize("Lmax", [600, 1100])
@pytest.mark.parametrize("kind", ["linear", "graph"])
def test_long_read_steps_on_card_match_cpu(long_card, kind, Lmax):
    """TorchAligner's step on the card against the CPU step (plain twins)
    on a batch whose longest read is Lmax (both passes of the graph
    aligner): packed buffers equal."""
    g, als = long_card
    cu, cp = als[kind]
    rng = np.random.default_rng(Lmax + (kind == "graph"))
    codes, quals, lens = _long_batch(rng, g, 48, Lmax)
    for a, c in ((cu, cp), (cu._fast, cp._fast)):
        if a is None:
            continue
        minsc = a._minsc(lens)
        for full in (False, True):
            bk = a.step(*a.upload(codes, quals, lens, minsc), False, full)
            bp = c.step(*c.upload(codes, quals, lens, minsc), False, full)
            _eq(bk, bp, f"{kind} L={Lmax} lite={a.lite} full_out={full}")


@pytest.mark.parametrize("kind", ["linear", "graph"])
def test_long_read_pairs_on_card_match_cpu(long_card, kind):
    """Paired batches through align_batch's paired path with mate rescue,
    one pair of 1100 bp mates: the card's alignments equal the CPU's."""
    from hisat2_tpu_torch.align import driver
    from hisat2_tpu_torch.align.paired import PairPolicy
    from hisat2_tpu_torch.io.fasta import ReadBatch
    g, als = long_card
    cu, cp = als[kind]
    rng = np.random.default_rng(77 + (kind == "graph"))
    B, Lm = 16, 1100
    m1, m2, q1, q2 = [], [], [], []
    for i in range(B):
        ln = Lm if i == 0 else int(rng.integers(100, 301))
        if i % 4 == 3:
            # mate 1 ends a copy of the repeat, mate 2 lies past it: only
            # mate 2 aligns alone, and mate 1 needs the rescue
            u = 150_000 + 5_000 * (i % 24) + 1200
            s, e = u - ln, u + 50 + ln
        else:
            s = int(rng.integers(0, len(g) - 2 * Lm))
            e = s + ln + int(rng.integers(50, 400))
        a = g[s:s + ln].copy()
        b = (3 - g[e - ln:e])[::-1].copy()
        a[rng.integers(0, ln, 2)] ^= 1
        m1.append(a)
        m2.append(b)
        q1.append(rng.integers(5, 41, ln).astype(np.uint8))
        q2.append(rng.integers(5, 41, ln).astype(np.uint8))
    out, jobs = [], []
    for al in (cu, cp):
        rescue_mates = al.rescue_mates
        al.rescue_mates = lambda codes, *a, **k: (
            jobs.append(codes.shape), rescue_mates(codes, *a, **k))[1]
        sink = io.StringIO()
        w = driver.SamWriter(sink, ["c"], [len(g)], no_head=True)
        rd = np.arange(B, dtype=np.int64)
        ref_fn = (lambda al_: (lambda pos, span: al_.ref_codes[pos:pos
                                                               + span]))(al)
        driver._align_pair_batch(
            al, w, PairPolicy(), al.scoring, 5,
            ReadBatch([f"p{i}" for i in range(B)], m1, q1),
            ReadBatch([f"p{i}" for i in range(B)], m2, q2), ref_fn, rd)
        del al.rescue_mates
        out.append(sink.getvalue())
    assert out[0] == out[1]
    assert out[0].count("\n") >= 2 * B
    assert jobs and all(shp[1] == Lm for shp in jobs)   # rescue at 1100 bp


@pytest.mark.parametrize("Lmax", [600, 1100])
def test_spliced_long_reads_on_card_match_cpu(scard, Lmax):
    """Spliced steps (lite and full) on the card against the CPU step on a
    batch whose longest read is Lmax, the rest 100-300 bp, reads across
    the fixture's introns: packed buffers equal."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    al, idx, _, batch = scard
    cpu = TorchAligner(idx, spliced=True, lane_meta=True, device="cpu")
    for k in ("sites", "_col_jl", "_col_jr", "_col_rdid"):
        setattr(cpu.splice_db, k, getattr(al.splice_db, k))
    codes, quals, lens = batch(24, Lmax)
    rng = np.random.default_rng(Lmax)
    lens[1:] = rng.integers(100, 301, len(lens) - 1)
    for i in range(1, len(lens)):
        codes[i, lens[i]:] = 4
    rdids = np.arange(len(lens), dtype=np.int64) + 100
    for a, c in ((al._fast, cpu._fast), (al, cpu)):
        rd, ss = a._step_site_args(rdids)
        rdc, ssc = c._step_site_args(rdids)
        minsc = a._minsc(lens)
        bk = a.step(*a.upload(codes, quals, lens, minsc), False, rdids=rd,
                    ss=ss)
        bp = c.step(*c.upload(codes, quals, lens, minsc), False, rdids=rdc,
                    ss=ssc)
        _eq(bk, bp, f"spliced step L={Lmax} lite={a.lite}")


@pytest.mark.parametrize("L", [1100, 2000])
def test_spliced_kernels_long_reads_match_plain_on_card(scard, L):
    """K13+K14, K15 (planes in the global scratch at these lengths), K16
    (lite and full), K17 and the spliced modes of kernels 5 and 6 on the
    real intermediates of both spliced steps at L bp."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    al, _, _, batch = scard
    codes, quals, lens = batch(64, L)
    rdids = 10 ** 6 + np.arange(len(lens), dtype=np.int64)
    for a in (al._fast, al):
        rd, ss = a._step_site_args(rdids)
        cap = {}
        a.step(*a.upload(codes, quals, lens, a._minsc(lens)), True,
               capture=cap, rdids=rd, ss=ss)
        want = {"inject_known", "compact_cands", "pack_slots"}
        if not a.lite:
            want |= {"pair_sweep", "second_sweep"}
        assert want <= set(cap)
        for name in sorted(cap):
            kern, plain = twins[name.split("/")[0]]
            ko = _flat_list(kern(**cap[name]))
            po = _flat_list(plain(**cap[name]))
            torch.cuda.synchronize()
            assert len(ko) == len(po)
            for x, y in zip(ko, po):
                _cmp(x, y, f"{name} L={L}")


# kernel 5's arguments with a row per lane
COMPACT_LANE_ARGS = ("top", "bot", "lo", "hi", "nh", "abefore", "post",
                     "stopped", "top2", "bot2", "lo2", "nh2", "offs", "offs2")


def test_dna_step_k64_long_read_on_card_matches_cpu(card, monkeypatch):
    """The unpaired DNA step at -k 64 (64 rows a hit) with a 6,000 bp read
    on the card fixture's 300 kbp genome (min_k = 10: H = 274 hits, so a
    warp's pool of 17,536 slot keys passes a block's shared memory and
    kernel 5 stages it in its global scratch) against the CPU step; then
    kernel 5 on the step's lanes against its twin, and on those lanes
    tiled to 24 (seeded order) with the scratch of one block, so that each
    of its four warps walks six lanes through its one pool: each tiled
    lane's outputs equal its row of the untiled run."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    from hisat2_tpu_torch.ops import compact
    g, idx = card
    cu = TorchAligner(idx, device="cuda", k=64)
    cp = TorchAligner(idx, device="cpu", k=64)
    assert cu.msize == 64 and cu.min_k == 10
    rng = np.random.default_rng(64)
    L = 6000
    lens = np.array([L, 150], np.int32)
    codes = np.full((2, L), 4, np.uint8)
    for i, n in enumerate(lens):
        s = int(rng.integers(0, len(g) - n))
        r = g[s:s + n].copy()
        r[rng.integers(0, n, 3)] ^= 1
        codes[i, :n] = r
    # a 17-mer of the motif the fixture plants 5 times: more hits
    codes[1, 40:57] = g[MOTIF_AT[0]:MOTIF_AT[0] + 17]
    quals = rng.integers(5, 41, (2, L)).astype(np.uint8)
    H = max(cu.max_hits, L // (cu.min_k + 12) + 2)
    assert compact.compact_scratch(H, 64, cu.max_cands, 0, 0, 4,
                                   torch.device("cuda")) is not None
    minsc = cu._minsc(lens)
    n0 = kernels.KERNELS["compact_cands"].launches
    cap = {}
    for full in (False, True):
        bk = cu.step(*cu.upload(codes, quals, lens, minsc), False, full,
                     capture=cap)
        bp = cp.step(*cp.upload(codes, quals, lens, minsc), False, full)
        _eq(bk, bp, f"-k 64 L={L} full_out={full}")
    assert kernels.KERNELS["compact_cands"].launches == n0 + 2
    kw = cap["compact_cands"]
    ko = _flat_list(compact.compact_cands(**kw))
    for x, y in zip(ko, _flat_list(compact.compact_candidates_plain(**kw))):
        _cmp(x, y, "-k 64 kernel 5")
    N = kw["top"].shape[0]
    idx = torch.from_numpy(np.random.default_rng(24).integers(0, N, 24))
    tiled = dict(kw)
    for k in COMPACT_LANE_ARGS:
        if tiled.get(k) is not None:
            tiled[k] = tiled[k][idx.cuda()].contiguous()
    with monkeypatch.context() as mp:
        mp.setattr(kernels, "scratch", _scratch_of_blocks(1))
        kt = _flat_list(compact.compact_cands(**tiled))
        torch.cuda.synchronize()
    for x, y in zip(ko, kt):
        _cmp(None if x is None else x[idx.cuda()], y,
             "-k 64 kernel 5, lanes tiled over one block")


FM_L = (1, 2, 33, 100, 151, 512, 513, 2000)


@pytest.mark.parametrize("L", FM_L)
def test_fm_search_random_on_card(card, L):
    """K1 dense and in its lane-list mode (K17) against the plain twin on
    seeded random lanes, on the 44-column table and on the 49-column one
    of a sampled SA: lens below L (0 too), N bases, reads ending in the
    planted motif (anchor stops), hit caps reached (H = 2), anchor_stop
    on and off; every PartialHits field equal."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.index.format import to_device
    from hisat2_tpu_torch.ops import search
    g, idx = card
    rng = np.random.default_rng(1000 + L)
    B = 300
    reads = rng.integers(0, 4, (B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    for i in range(B):
        s = int(rng.integers(0, len(g) - L))
        if i % 4:
            reads[i] = g[s:s + L]
        if i % 7 == 3:
            reads[i, rng.integers(0, L, 1 + L // 50)] = 4
        if i % 5 == 0:
            lens[i] = L
        if i % 11 == 2 and L >= 17:
            at = MOTIF_AT[i % len(MOTIF_AT)]
            lens[i] = L
            reads[i, L - 17:] = g[at:at + 17]
        reads[i, lens[i]:] = rng.integers(0, 5, L - lens[i])
    rd, ln = (torch.from_numpy(a).cuda() for a in (reads, lens))
    m = idx.meta
    dev = to_device(idx, "cuda")
    marks = torch.randint(-2 ** 31, 2 ** 31 - 1, (dev.blocked.shape[0], 5),
                          dtype=torch.int32, device="cuda")
    for blocked in (dev.blocked, torch.cat([dev.blocked, marks],
                                           1).contiguous()):
        for H, stop in ((6, True), (2, True), (6, False)):
            args = (blocked, dev.fchr, dev.ftab2_top, m.zrow, m.zrow2,
                    m.rows, rd, ln, H, 16, 9)
            what = f"L={L} cols={blocked.shape[1]} H={H} stop={stop}"
            a = search.partial_search2(*args, anchor_stop=stop)
            b = search.partial_search2_plain(*args, anchor_stop=stop)
            for f in a._fields:
                _eq(getattr(a, f), getattr(b, f), f"{what} {f}")
            # the lane-list mode: every other lane, in a shuffled order
            lanes = torch.from_numpy(rng.permutation(B)[:B // 2].astype(
                np.int32)).cuda()
            n0 = kernels.KERNELS["search_lanes_live"].launches
            k = search.partial_search2(*args, anchor_stop=stop, lanes=lanes)
            torch.cuda.synchronize()
            assert kernels.KERNELS["search_lanes_live"].launches == n0 + 1
            on = torch.zeros(B, dtype=torch.bool, device="cuda")
            on[lanes.long()] = True
            for f in a._fields:
                x, y = getattr(k, f), getattr(b, f)
                m_ = on.reshape((B,) + (1,) * (y.dim() - 1))
                _eq(x, torch.where(m_, y, torch.zeros_like(y)),
                    f"{what} lane list {f}")
    if L >= 33:
        assert int(b.nh.sum()) > 0


def _inject_world(rng, C, L, N, slots, n=60_000, M=16, dense=False,
                  one=False):
    """K10's arguments on the card: N lanes of reads copied from a seeded
    genome across a catalog event at their first candidate (a deletion of
    1-10 bp, or an insertion of 1-16 bp whose allele the read carries or,
    one time in three, does not), the event's other diagonal, decoys, a
    candidate past the text's end, invalid ones; mutations, N chars and
    shorter reads; SNV planes with a delta at 5% of positions.  dense: a
    deletion every 2 bp, so that nearly every slot is live; one: a
    one-event table.  On a text shorter than the reads the fresh
    diagonals leave it and their penalty sums pass 2^31."""
    from hisat2_tpu_torch.ops import splice
    g = rng.integers(0, 4, n).astype(np.uint8)
    lo_, hi_ = min(100, n // 4), max(n // 4 + 1, n - L - 30)
    if dense:
        events = [(int(p), int(rng.integers(1, 11)), [])
                  for p in range(lo_, n - 20, 2)]
    else:
        k = 1 if one else max(8, min(4000, n // 15))
        events = []
        for p in np.sort(rng.choice(np.arange(lo_, n - 20), k,
                                    replace=False)):
            if len(events) % 2 or one:
                events.append((int(p), int(rng.integers(1, 11)), []))
            else:
                al = rng.integers(0, 4, int(rng.integers(1, 17)))
                events.append((int(p), -len(al), list(al)))
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    starts = np.zeros((N, C), np.int32)
    for i in range(N):
        p, ln, al = events[int(rng.integers(0, len(events)))]
        x = int(rng.integers(1, max(2, min(L - 18, p - lo_ + 1))))
        s = p - x
        if ln > 0:
            r = np.concatenate([g[s:p], g[p + ln:]])
        else:
            a = np.asarray(al, np.uint8)
            r = np.concatenate([g[s:p], a if i % 3 else (a + 1) % 4,
                                g[p:]])
        r = r[:L]
        reads[i, :len(r)] = r
        mut = rng.random(L) < 0.02
        reads[i, mut] = (reads[i, mut] + 1) % 4
        reads[i, rng.random(L) < 0.005] = 4
        row = [s, s + ln, s + int(rng.integers(-3, 4)),
               int(rng.integers(lo_, hi_)), n + int(rng.integers(0, L)),
               int(rng.integers(0, n))]
        starts[i] = (row * C)[:C]
    lens = np.where(rng.random(N) < 0.3, rng.integers(2, L + 1, N),
                    L).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    ev = sorted(events)
    E = 8
    while E < len(ev) + 1:
        E *= 2
    ip = np.full(E, 2 ** 30, np.int32)
    il = np.zeros(E, np.int32)
    ch = np.zeros((E, 16), np.int32)
    for j, (p, ln, al) in enumerate(ev):
        ip[j], il[j] = p, ln
        ch[j, :len(al)] = al
    if one:                      # the one-row table itself: E = 1
        ip, il, ch, E = ip[:1], il[:1], ch[:1], 1
    ne = min(len(ev), E)
    rkey = ip[:ne].astype(np.int64) + il[:ne]
    o2 = np.argsort(rkey, kind="stable")
    rk_ = np.full(E, 2 ** 30, np.int32)
    ril = np.zeros(E, np.int32)
    rrow = np.zeros(E, np.int32)
    rk_[:ne], ril[:ne], rrow[:ne] = rkey[o2], il[:ne][o2], o2
    words = _pack2(g)
    snv = [_pack2(np.where(rng.random(n) < 0.05, rng.integers(1, 4, n), 0))
           for _ in (0, 1)]
    st = t(starts)
    wins = [splice.diag_chars_plain(w, n, st, L, M).contiguous()
            for w in (words, *snv)]
    return dict(ref_words=words, n_text=n, reads=t(reads),
                quals=t(rng.integers(0, 42, (N, L)).astype(np.int32)),
                lens=t(lens), starts=st, valid=t(rng.random((N, C)) > 0.1),
                ch=wins[0], snv1_w=wins[1], snv2_w=wins[2], margin=M,
                ip=t(ip), ilen=t(il), ins_chars=t(ch), rkey=t(rk_),
                r_ilen=t(ril), r_row=t(rrow),
                mm_pen=t(np.array([2 + min(q, 40) * 4 // 40
                                   for q in range(64)], np.int32)),
                n_pen=1, minsc=t(np.where(rng.random(N) < 0.5, -(2 ** 31),
                                          -(lens // 3)).astype(np.int32)),
                snv_delta1=snv[0], snv_delta2=snv[1], slots=slots)


def _hold_indels(kw, what):
    """K10 against its plain twin on one argument set: one launch, equal
    outputs; returns the live share (splice.indel_probes)."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    po = splice.inject_indels_plain(**kw)
    n0 = kernels.KERNELS["inject_indels"].launches
    ko = splice.inject_indels(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["inject_indels"].launches == n0 + 1
    assert sorted(ko) == sorted(po)
    for f in po:
        _same(ko[f], po[f], f"{what} {f}")
    live = splice.indel_probes(*(kw[k] for k in (
        "starts", "valid", "lens", "reads", "ip", "ilen", "ins_chars",
        "rkey", "r_ilen", "r_row")), kw["slots"])["live"]
    return float(live.float().mean()), ko


@pytest.mark.parametrize("L", [100, 600, 2000, 22_050])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_inject_indels_random_on_card(card, L, slots):
    """K10 against its plain twin on catalog-indel lanes at L = 100, 600,
    2,000 and 22,050 (on a 600 bp text, where the fresh diagonals' sums
    pass 2^31 and wrap) and 1, 2 and 4 slots a candidate."""
    rng = np.random.default_rng(L * 10 + slots)
    N = 256 if L <= 600 else 32 if L <= 2000 else 6
    kw = _inject_world(rng, 6, L, N, slots,
                       n=600 if L > 2000 else 60_000)
    share, ko = _hold_indels(kw, f"L={L} slots={slots}")
    assert share > 0.0 and bool((ko["kind"] == 2).any())
    if L > 2000:
        # a live slot whose score wrapped past 2^31 to a positive number
        assert bool((ko["score"] > 2 ** 30).any())


@pytest.mark.parametrize("case", ["one", "dense4", "dense5", "wide"])
def test_inject_indels_work_list_on_card(card, case):
    """K10 on a one-event table (E = 1, probes past its end) and on a
    dense catalog where nearly every slot is live: 4 slots a candidate at
    C = 130 (a lane's items take two rounds of probes and the list fills
    in the first, so it is walked mid-tile), 5 slots at C = 6 (the list is
    walked between the slots of one round), and 4 slots at C = 6."""
    rng = np.random.default_rng(len(case))
    C, slots, dense = {"one": (6, 2, False), "dense4": (130, 4, True),
                       "dense5": (6, 5, True), "wide": (6, 4, True)}[case]
    kw = _inject_world(rng, C, 100, 64, slots, n=8_000, dense=dense,
                       one=case == "one")
    share, _ = _hold_indels(kw, case)
    if dense:
        assert share > 0.5, share
    else:
        assert kw["ip"].shape[0] == 1


def test_ref_window_multi_on_card(card):
    """K5 in one launch of three planes and two start sets (W = 133 with
    margin 16, W = 101 without) against the plain windows of each (set,
    plane): starts of -1, before the text, near and past its end; an
    empty extra set; one plane alone."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    g, idx = card
    rng = np.random.default_rng(133)
    n, L, N = len(g), 101, 1000
    planes = [_pack2(g)] + [_pack2(rng.integers(0, 4, n)) for _ in (0, 1)]
    st = rng.integers(0, n, (N, 6))
    st[:, 1] = -1
    st[:, 2] = rng.integers(-150, 0, N)
    st[:, 3] = n - rng.integers(-20, 140, N)
    st[:, 4] = n + rng.integers(0, 50, N)
    core = torch.from_numpy(st.astype(np.int32)).cuda()
    extra = torch.from_numpy(st[:, :3].astype(np.int32).copy()).cuda()
    empty = torch.zeros((N, 0), dtype=torch.int32, device="cuda")
    for ps, sets, margins in ((planes, [core, extra], [16, 0]),
                              (planes, [core, empty], [16, 0]),
                              (planes[:1], [extra], [0]),
                              (planes[:2], [extra, core], [0, 3])):
        n0 = kernels.KERNELS["ref_window"].launches
        got = splice.diag_chars_multi(ps, n, sets, margins, L)
        torch.cuda.synchronize()
        assert kernels.KERNELS["ref_window"].launches == n0 + 1
        assert len(got) == len(sets)
        for s, m, row in zip(sets, margins, got):
            assert len(row) == len(ps)
            for w, o in zip(ps, row):
                _eq(o, splice.diag_chars_plain(w, n, s, L, m),
                    f"ref_window W={L + 2 * m} set {tuple(s.shape)}")


def test_ref_window_past_2_31_chars_on_card(card):
    """K5 on a set of 8,192 x 40 starts of 6,554-char windows (2^31 +
    131,072 chars, 8.6 GB of int32: the flat index past 2^31), against
    the plain windows 512 lanes at a time."""
    from hisat2_tpu_torch.ops import splice
    g, idx = card
    n, L, N, C = len(g), 6_554, 8_192, 40
    words = _pack2(g)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    st = torch.randint(-L, n, (N, C), generator=gen, device="cuda",
                       dtype=torch.int32)
    assert N * C * L >= 2 ** 31
    out = splice.diag_chars_multi([words], n, [st], [0], L)[0][0]
    torch.cuda.synchronize()
    for i in range(0, N, 512):
        _eq(out[i:i + 512], splice.diag_chars_plain(words, n, st[i:i + 512],
                                                    L, 0),
            f"ref_window rows {i}-{i + 511}")
    del out
    torch.cuda.empty_cache()


def _random_words(rng, nw):
    return torch.from_numpy(rng.integers(0, 2 ** 32, nw, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).cuda()


@pytest.mark.parametrize("row", [8, 128, 1])
def test_ref_window_past_the_words_on_card(card, monkeypatch, row):
    """K5 on three planes of n_words words and n_text = 16 * n_words +
    200,000: windows that cross 16 * n_words, lie wholly past it, and
    reach n_text, read the word JAX's gather reads there (the last row of
    8 or 128 words, or the last word on an unpadded plane) as its twin
    does; below 16 * n_words nothing changes."""
    from hisat2_tpu_torch.ops import rank, splice
    nw = 6_253 if row == 1 else 6_272
    if row == 128:
        monkeypatch.setattr(rank, "ROW8_MAX_WORDS", 4_096)
    assert rank.clamp_row(nw) == row
    rng = np.random.default_rng(row)
    planes = [_random_words(rng, nw) for _ in range(3)]
    end, L, N = 16 * nw, 101, 512
    n = end + 200_000
    st = rng.integers(0, end - 500, (N, 6))
    st[:, 1] = end - rng.integers(1, 140, N)        # across the words' end
    st[:, 2] = end + rng.integers(0, 190_000, N)    # wholly past it
    st[:, 3] = n - rng.integers(-20, 140, N)        # at the text's end
    st[:, 4] = end + rng.integers(-3, 3, N)
    core = torch.from_numpy(st.astype(np.int32)).cuda()
    extra = torch.from_numpy(st[:, 1:4].astype(np.int32).copy()).cuda()
    for ps, sets, margins in ((planes, [core, extra], [16, 0]),
                              (planes[:1], [core], [0])):
        got = splice.diag_chars_multi(ps, n, sets, margins, L)
        torch.cuda.synchronize()
        for s, m, out in zip(sets, margins, got):
            for w, o in zip(ps, out):
                p = splice.diag_chars_plain(w, n, s, L, m)
                _eq(o, p, f"ref_window past the words, row {row}, W "
                    f"{L + 2 * m}")
                pos = s.long()[..., None] - m + torch.arange(
                    L + 2 * m, device="cuda")
                assert ((p < 4) == ((pos >= 0) & (pos < n))).all()


@pytest.mark.parametrize("L", [100, 150])
def test_rescue_window_past_the_words_on_card(card, L):
    """K12 on windows across and wholly past 16 * n_words with n_text
    larger (the clamp of JAX's ref_char: the last word), against its
    twin, at W 33 and 57,344; mates copied from the text below the words
    and from what the clamps read past them; then the whole
    rescue_candidates (K12, K5 with its row clamp, K6+K7) on the card
    against the CPU."""
    from hisat2_tpu_torch.align.scoring import Scoring
    from hisat2_tpu_torch.index.format import score_tables
    from hisat2_tpu_torch.ops import rank, rescue
    rng = np.random.default_rng(L)
    nw = 6_272
    words = _random_words(rng, nw)
    end = 16 * nw
    n = end + 300_000
    virt = {r: rank.ref_chars_block(words.cpu(), n, torch.tensor([0]), n,
                                    row=r)[0].numpy() for r in (1, 8)}
    R = 37
    ws = np.concatenate([end - rng.integers(100, 60_000, 12),
                         end + rng.integers(0, 240_000, 20),
                         [end - 57_344, end, n - 1_000, n - 57_000, -5]])
    reads = np.full((R, L), 4, np.int32)
    for i in range(R):
        v = virt[(1, 8)[i % 2]]
        s = int(np.clip(ws[i] + rng.integers(0, 2_000), 0, n - L))
        reads[i] = np.minimum(v[s:s + L], 3)
        if i % 3 == 2:
            reads[i, rng.integers(0, L, 4)] = rng.integers(0, 4, 4)
    reads[-3:] = 4                                  # padding jobs
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    rd, wst = t(reads), t(ws.astype(np.int32))
    for W in (33, 57_344):
        k = rescue.rescue_window(words, n, rd, wst, W)
        p = rescue.rescue_window_plain(words, n, rd, wst, W)
        _eq(k, p, f"rescue_window past the words L={L} W={W}")
    sc = Scoring()
    quals = t(rng.integers(5, 41, (R, L)).astype(np.int32))
    lens = t(np.full(R, L, np.int32))
    outs = []
    for dev in ("cuda", "cpu"):
        tab = score_tables(sc, dev)
        outs.append(rescue.rescue_candidates(
            words.to(dev), n, rd.to(dev), quals.to(dev), lens.to(dev),
            wst.to(dev), 57_344, tab["mm_pen"], tab["clip_pen"], sc.n_pen))
    (ks, ke), (ps, pe) = outs
    _eq(ks, ps, "rescue_candidates starts past the words")
    for f in ke._fields:
        _eq(getattr(ke, f), getattr(pe, f), f"rescue_candidates {f}")
    assert int((ps >= end).sum()) > 100


# --- K12 and K18 at every shape the redesign must take ------------------------

RESCUE_SPOTS = [20000 + 18000 * i for i in range(15)]


@pytest.fixture(scope="module")
def rescue_world():
    """A 300 kbp genome with a 120 bp unit 15 times at 18 kbp spacing
    (tests/test_rescue.py's tie window), and its packed words on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from hisat2_tpu_torch import kernels
    kernels.load()
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 300_000).astype(np.uint8)
    unit = rng.integers(0, 4, 120).astype(np.uint8)
    for s in RESCUE_SPOTS:
        g[s:s + 120] = unit
    return g, _pack2(g)


def _rescue_jobs(rng, g, R, L, W):
    """R rescue jobs: mates from the genome in windows around them, the
    tie window, windows before the text's start and past its end, Ns, and
    (R > 3) a tail of all-N padding jobs, as rescue_mates pads a chunk."""
    n = len(g)
    reads = np.full((R, L), 4, np.int32)
    ws = np.zeros(R, np.int64)
    for i in range(R):
        s = int(rng.integers(0, n - L))
        reads[i] = g[s:s + L]
        ws[i] = s - int(rng.integers(0, max(W - L, 1)))
    reads[0] = 4
    k = min(L, 100)
    reads[0, :k] = g[RESCUE_SPOTS[0] + 10:RESCUE_SPOTS[0] + 10 + k]
    ws[0] = RESCUE_SPOTS[0] - 5 if W < 4000 else 0
    if R > 1:
        ws[1], reads[1] = -56320 if W > L else -3, g[:L]
    if R > 2:
        ws[2], reads[2] = n - 1000, g[n - L:]
    if R > 3:
        reads[3, ::7] = 4
        reads[R - R // 3:] = 4          # the chunk's padding jobs
    return reads, ws.astype(np.int32)


@pytest.mark.parametrize("L", [1, 31, 100, 150, 300, 513, 2000])
def test_rescue_window_shapes_on_card(rescue_world, L):
    """K12 against its plain twin bit for bit at R in {1, 3, 37, 128} x W
    in {8, 33, 57,344}: one launch a call; at L = 300 the 299 / 300 bf16
    tie of the near-copies, at 513 and 2,000 several read chunks."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import rescue
    g, words = rescue_world
    n = len(g)
    rng = np.random.default_rng(L)
    gl = g.copy()
    if L == 300:
        # copies of one 300 bp unit with 1 and 0 mismatches: 299 and 300
        # read as 300 in bfloat16, so the lower diagonal ranks first
        unit = rng.integers(0, 4, L).astype(np.uint8)
        for c, at in ((1, 240_000), (0, 240_900)):
            gl[at:at + L] = unit
            gl[at + np.arange(c) * 7 + 3] ^= 1
        words = _pack2(gl)
    for R in (1, 3, 37, 128):
        for W in (8, 33, 57_344):
            reads, ws = _rescue_jobs(rng, gl, R, L, W)
            if L == 300 and R > 1 and W == 57_344:
                reads[1], ws[1] = unit, 200_000
            t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
            rd, wst = t(reads), t(ws)
            n0 = kernels.KERNELS["rescue_window"].launches
            k = rescue.rescue_window(words, n, rd, wst, W)
            torch.cuda.synchronize()
            assert kernels.KERNELS["rescue_window"].launches == n0 + 1
            p = rescue.rescue_window_plain(words, n, rd, wst, W)
            _eq(k, p, f"rescue_window R={R} L={L} W={W}")
            if L == 300 and R > 1 and W == 57_344:
                assert k[1, :2].tolist() == [240_000, 240_900]
            if R > 3:
                pad = torch.arange(8, dtype=torch.int32)
                assert torch.equal(k[-1].cpu(), int(ws[-1]) + pad)


def _merge_args(rng, cap, nn, m, case, lob):
    """Old table sets of nn real rows (sentinel-padded to cap) and a
    512-row chunk of m real new rows: random keys with three tied to an
    old key ("random"), every real row the same key equal to an old key
    ("equal"), or distinct keys each equal to an old row's ("old")."""
    SENT = 2 ** 31 - 2
    kd = np.sort(rng.integers(0, 10 ** 7, nn)).astype(np.int32)
    kd[5:9] = kd[5]
    ka = (kd + rng.integers(30, 5000, nn)).astype(np.int32)
    o = np.lexsort((ka, kd))
    kd, ka = kd[o], ka[o]
    rd = rng.integers(-1, 100, nn).astype(np.int32)
    o2 = np.lexsort((kd, ka))
    pad = lambda a, f: np.concatenate(  # noqa: E731
        [a, np.full(cap - nn, f, np.int32)])
    nkd = np.full(512, SENT, np.int32)
    nka, nrd = nkd.copy(), np.full(512, -1, np.int32)
    if case == "equal":
        nkd[:m], nka[:m] = kd[5], ka[5]
    elif case == "old":
        pick = rng.choice(nn, m, replace=False)
        nkd[:m], nka[:m] = kd[pick], ka[pick]
    else:
        nkd[:m] = rng.integers(0, 10 ** 7, m)
        nkd[:min(m, 3)] = kd[5]
        nka[:m] = nkd[:m] + 100
        nka[:min(m, 3)] = ka[5]
    nrd[:m] = 7 + np.arange(m) % 50
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    kw = dict(kd=T(pad(kd, SENT)), ka=T(pad(ka, SENT)), rd=T(pad(rd, -1)),
              ka_s=T(pad(ka[o2], SENT)), kd_s=T(pad(kd[o2], SENT)),
              rd_a=T(pad(rd[o2], -1)), nkd=T(nkd), nka=T(nka), nrd=T(nrd))
    if lob:
        shift, NB = 5, 1 << 19
        edges = np.arange(NB + 1, dtype=np.int64) << shift
        bkd, bka, w = (np.zeros(512, np.int32) for _ in range(3))
        bkd[:m] = np.clip(nkd[:m] >> shift, 0, NB - 1)
        bka[:m] = np.clip(nka[:m] >> shift, 0, NB - 1)
        if m:
            bkd[0], bka[m - 1] = 0, NB - 1      # the first and last bins
        w[:m] = 1
        kw.update(lob_kd=T(np.searchsorted(kd, edges).astype(np.int32)),
                  lob_ka=T(np.searchsorted(ka[o2], edges).astype(np.int32)),
                  bins_kd=T(bkd), bins_ka=T(bka), wts=T(w))
    return kw


@pytest.mark.parametrize("cap,nn,m,case", [
    (64, 40, 0, "random"), (64, 40, 1, "random"), (64, 40, 300, "random"),
    (64, 60, 512, "equal"), (64, 40, 30, "old"),
    (65_536, 60_000, 0, "random"), (65_536, 60_000, 1, "random"),
    (65_536, 60_000, 300, "old"), (65_536, 65_100, 512, "random"),
    (65_536, 60_000, 512, "equal")])
@pytest.mark.parametrize("lob", [False, True])
def test_merge_sites_shapes_on_card(card, cap, nn, m, case, lob):
    """K18 against its plain twin bit for bit: m real new rows in {0, 1,
    300, 512}, all-equal new keys, new keys equal to old ones, new rows cut
    by the capacity (60 of 64, 65,100 of 65,536 old rows), cap in {64,
    65,536}, with and without the bucket index (bins at 0 and NB - 1); one
    launch a call."""
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import sites
    rng = np.random.default_rng(cap + m + lob)
    kw = _merge_args(rng, cap, nn, m, case, lob)
    n0 = kernels.KERNELS["merge_sites"].launches
    got = sites.merge_sorted_tabs(**kw)
    torch.cuda.synchronize()
    assert kernels.KERNELS["merge_sites"].launches == n0 + 1
    want = sites.merge_sorted_tabs_plain(**kw)
    assert len(got) == len(want) == (8 if lob else 6)
    for i, (x, y) in enumerate(zip(got, want)):
        _eq(x, y, f"merge_sites output {i}")


def test_rescue_merge_graph_replays_on_card(rescue_world, card):
    """K12 (a 128-job chunk at W = 57,344, 8 slices a job meeting through
    the tickets) and K18 captured in one CUDA graph and replayed twice:
    the same outputs as the plain twins each time, so the tickets are
    back to zero after every launch."""
    from hisat2_tpu_torch.ops import rescue, sites
    g, words = rescue_world
    n, W = len(g), 57_344
    rng = np.random.default_rng(15)
    reads, ws = _rescue_jobs(rng, g, 128, 100, W)
    rd, wst = torch.from_numpy(reads).cuda(), torch.from_numpy(ws).cuda()
    mkw = _merge_args(rng, 1024, 559, 300, "random", True)
    want_r = rescue.rescue_window_plain(words, n, rd, wst, W)
    want_m = sites.merge_sorted_tabs_plain(**mkw)
    rescue.rescue_window(words, n, rd, wst, W)     # the tickets, outside
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    g_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_, stream=s):
        got_r = rescue.rescue_window(words, n, rd, wst, W)
        got_m = sites.merge_sorted_tabs(**mkw)
    for rep in range(2):
        for o in (got_r, *got_m):
            o.fill_(-7)
        g_.replay()
        torch.cuda.synchronize()
        _eq(got_r, want_r, f"rescue_window replay {rep}")
        for i, (x, y) in enumerate(zip(got_m, want_m)):
            _eq(x, y, f"merge_sites output {i} replay {rep}")


@pytest.fixture(scope="module")
def allele_card(card):
    """An allele index as `genotype --alleles` builds it: 300 alleles of a
    2,000 bp locus with 2-8 SNVs each, so a 150 bp read matches most of
    them exactly (hits hundreds of rows wide); 768 reads, 2:1 from two
    alleles, and 64 random ones."""
    rng = np.random.default_rng(1616)
    Lk = 2000
    bb = rng.integers(0, 4, Lk)
    seqs = []
    for a in range(300):
        s = bb.copy()
        for p in rng.choice(Lk, int(rng.integers(2, 9)), replace=False):
            s[p] = (s[p] + 1 + rng.integers(0, 3)) % 4
        seqs.append((f"Y*{a:03d}", s.astype(np.uint8)))
    idx = build_fm_index(seqs)
    reads = np.zeros((832, 150), np.int32)
    for i in range(768):
        src = seqs[7 if i % 3 else 201][1]
        st = int(rng.integers(0, Lk - 150))
        reads[i] = src[st:st + 150]
        if i % 2:
            reads[i] = (3 - reads[i])[::-1]
    reads[768:] = rng.integers(0, 4, (64, 150))
    quals = np.full(reads.shape, 40, np.int32)
    lens = np.full(len(reads), 150, np.int32)
    return idx, reads, quals, lens


def test_allele_index_step_on_card(allele_card):
    """The genotype allele aligner's step (k = 16, max_seeds = 10**6:
    msize 64, 65 candidates a lane) with hits wider than 64 rows: every
    kernel it launches, K4 and K9 among them, against its plain twin on
    the step's own arguments, and the packed step against the CPU's."""
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    idx, reads, quals, lens = allele_card
    kw = dict(k=16, max_seeds=10 ** 6, spliced=False)
    cu = TorchAligner(idx, device="cuda", **kw)
    cp = TorchAligner(idx, device="cpu", **kw)
    assert (cu.msize, cu.max_cands) == (64, 65)
    minsc = cu._minsc(lens)
    cap = {}
    cu.step(*cu.upload(reads, quals, lens, minsc), True, capture=cap)
    cc = cap["compact_cands"]
    width = (cc["bot"] - cc["top"]).max().item()
    assert width > 64, f"widest hit {width} rows"
    assert {"compact_cands", "pack_slots"} <= set(cap)
    _replay(cap, list(cap))
    for full in (False, True):
        bk = cu.step(*cu.upload(reads, quals, lens, minsc), True, full)
        bp = cp.step(*cp.upload(reads, quals, lens, minsc), True, full)
        _eq(bk, bp, f"allele step full_out={full}")
        assert cu._out_specs == cp._out_specs


def test_msa_graph_step_on_card(monkeypatch, tmp_path, card):
    """`genotype --msa --assembly --device cuda` on the committed geno
    STR locus: the report and the assembly equal the JAX oracles, K10+K11
    ran; then the driver's own graph aligner (the MSA's union variants,
    repeat-length indels as catalog events): its lite and full steps on
    the first batch, every kernel against its plain twin (K10+K11 on
    live injected slots)."""
    import gzip as gz
    import importlib.util
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.genotype import driver
    from hisat2_tpu_torch.io.fasta import read_batches
    from hisat2_tpu_torch.ops import splice
    data = os.path.join(os.path.dirname(__file__), "data")
    spec = importlib.util.spec_from_file_location(
        "make_geno", os.path.join(data, "make_geno.py"))
    mg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mg)
    mg.stage(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    argv, outs = mg.RUNS["msa"]
    kernels.reset_counts()
    with mg.recorded_aligners() as made:
        assert driver.main(argv + ["--device", "cuda"]) == 0
    assert kernels.counts()["inject_indels"] > 0
    for got, oracle in outs:
        with gz.open(os.path.join(data, oracle + ".gz"), "rb") as f:
            assert open(got, "rb").read() == f.read(), oracle
    al = made[-1]
    assert al.has_indels and al._fast is not None
    b = next(read_batches("geno_reads_msa.fa", 4096))
    minsc = al._minsc(b.lens)
    for tier in (al._fast, al):
        cap = {}
        tier.step(*tier.upload(b.codes, b.quals, b.lens, minsc), False,
                  capture=cap)
        if tier is al:
            assert "inject_indels" in cap
            inj = splice.inject_indels_plain(**cap["inject_indels"])
            assert int((inj["event"] >= 0).sum()) > 0
        _replay(cap, list(cap))
