"""Port parity for the graph-DNA slice: the torch aligner on a variant
index (SNVs and known ALT indels, two tiers) against hisat2_tpu on the CPU.

A seeded 30 kbp genome with a 3-copy repeat and 40 catalog variants of all
three kinds (as tests/test_two_tier.py), and reads that carry catalog SNV
and indel alleles as well as sequencing errors.  The JAX step is traced
once per variant with spies on its ops, which capture the intermediates
(hits, the unified slot schema, windows, sweep and injection inputs and
outputs); each plain twin of the port is then held against them:

- K4 (compact_candidates_plain) and K9 (pack_slots_plain), lite and full;
- K5 on the SNV planes, K6+K7 and K8 with SNV forgiveness;
- K11 (live_pen_prefix_plain) on both JAX paths, and K10
  (inject_indels_plain);
- the whole lite and full-pass step: packed buffer, _out_specs,
  _spill_meta and every unpacked key, spill and full_out layouts;
- align_batch through the two tiers on the test_two_tier_graph_dna corpus
  and on the allele corpus.

Tolerance: exact (integer results).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.index.variants import attach_variants
from hisat2_tpu.ops import compact as j_compact
from hisat2_tpu.ops import extend as j_extend
from hisat2_tpu.ops import search as j_search
from hisat2_tpu.ops import splice as j_splice
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.ops import compact, extend, splice

ACGT = "ACGT"


def _genome_and_catalog(tmp_path, seed=5):
    """tests/test_two_tier.py:19-49: 30 kbp, a 3-copy repeat, 40
    variants (SNV / deletion / insertion in turn)."""
    rng = np.random.default_rng(seed)
    N = 30000
    g = rng.integers(0, 4, N).astype(np.uint8)
    blk = g[1000:1300].copy()
    g[5000:5300] = blk
    g[9000:9300] = blk
    lines, cat = [], []
    for k, p in enumerate(sorted(rng.choice(
            np.arange(2000, 28000), 40, replace=False))):
        p = int(p)
        t = k % 3
        if t == 0:
            alt = (int(g[p]) + 1) % 4
            lines.append(f"rs{k}\tsingle\tc1\t{p}\t" + ACGT[alt])
            cat.append(("S", p, alt))
        elif t == 1:
            ln = int(rng.integers(1, 4))
            lines.append(f"rs{k}\tdeletion\tc1\t{p}\t{ln}")
            cat.append(("D", p, ln))
        else:
            ins = rng.integers(0, 4, int(rng.integers(1, 4)))
            lines.append(f"rs{k}\tinsertion\tc1\t{p}\t"
                         + "".join(ACGT[c] for c in ins))
            cat.append(("I", p, ins.astype(np.uint8)))
    snp = os.path.join(str(tmp_path), "v.snp")
    with open(snp, "w") as f:
        f.write("\n".join(lines) + "\n")
    index = build_fm_index([("c1", g)])
    attach_variants(index, snp_file=snp)
    return rng, g, cat, index


def _allele_reads(rng, g, cat, B, L):
    """B reads: every second one carries a catalog allele (SNV, deletion
    or insertion) at a random offset, some get 1-2 sequencing errors,
    every fifth is reverse-complemented."""
    n = len(g)
    codes = np.zeros((B, L), np.uint8)
    for i in range(B):
        if i % 2 == 0:
            kind, p, v = cat[(i // 2) % len(cat)]
            off = int(rng.integers(12, L - 12))
            s = max(0, min(p - off, n - L - 8))
            if kind == "S":
                r = g[s:s + L].copy()
                r[p - s] = v
            elif kind == "D":
                r = np.concatenate([g[s:p], g[p + v:s + L + v]])
            else:
                r = np.concatenate([g[s:p], v, g[p:s + L]])[:L]
        else:
            s = int(rng.integers(0, n - L))
            r = g[s:s + L].copy()
        r = r[:L].copy()
        if i % 3 == 1:
            for q in rng.choice(L, int(rng.integers(1, 3)), replace=False):
                r[q] = (r[q] + 1 + int(rng.integers(0, 3))) % 4
        if i % 5 == 0:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        codes[i] = r
    quals = rng.integers(10, 41, (B, L)).astype(np.uint8)
    return codes, quals, np.full(B, L, np.int32)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    rng, g, cat, index = _genome_and_catalog(tmp_path_factory.mktemp("gr"))
    codes, quals, lens = _allele_reads(rng, g, cat, 96, 100)
    db = index._variants
    ja = TPUAligner(index, variants=db, lane_meta=True)
    ta = TorchAligner(index, variants=db, lane_meta=True, device="cpu")
    return dict(index=index, g=g, cat=cat, codes=codes, quals=quals,
                lens=lens, ja=ja, ta=ta)


def _tier(al, lite):
    return al._fast if lite else al


_SPIES = ((j_search, "partial_search2"), (j_splice, "diag_chars"),
          (j_extend, "extend_grouped"), (j_extend, "pen_planes"),
          (j_splice, "self_indel_sweep"), (j_splice, "inject_indels"),
          (j_compact, "select_ranked"))


def _jax_step(ja, codes, quals, lens, full_out):
    """Trace TPUAligner._align_device with spies on its ops; returns the
    output dict and {op name: [(args, kwargs, result), ...]}."""
    calls = {nm: [] for _, nm in _SPIES}
    saved = [(m, nm, getattr(m, nm)) for m, nm in _SPIES]

    def spy(nm, fn):
        def f(*a, **k):
            r = fn(*a, **k)
            calls[nm].append((a, k, r))
            return r
        return f

    def arrays(x):
        return jax.tree_util.tree_map(
            lambda v: v if isinstance(v, jax.Array) else None, x)

    minsc = np.array([ja.scoring.min_score(int(x)) for x in lens], np.int32)
    try:
        for m, nm, fn in saved:
            setattr(m, nm, spy(nm, fn))

        def run(params, reads, quals_, lens_, minsc_):
            out = ja._align_device(ja.dev, params, reads, quals_, lens_,
                                   minsc_, uniform=bool(np.all(
                                       lens == codes.shape[1])),
                                   full_out=full_out)
            return out, {nm: [arrays(c) for c in v]
                         for nm, v in calls.items()}

        out, cap = jax.jit(run)(
            ja.params, jnp.asarray(codes, jnp.int32),
            jnp.asarray(quals, jnp.int32), jnp.asarray(lens, jnp.int32),
            jnp.asarray(minsc))
    finally:
        for m, nm, fn in saved:
            setattr(m, nm, fn)
        # _align_device leaves its spill layout for _align_device_packed
        # to record; this trace bypasses that, so drop it
        ja._traced_spill_mdev = None
    to_np = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    return ({k: np.asarray(v) for k, v in out.items()},
            jax.tree_util.tree_map(to_np, cap,
                                   is_leaf=lambda v: v is None))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.fixture(scope="module")
def traced(graph):
    """The JAX step's outputs and intermediates per (lite, full_out)."""
    return {(lite, fo): _jax_step(_tier(graph["ja"], lite), graph["codes"],
                                  graph["quals"], graph["lens"], fo)
            for lite in (True, False) for fo in (False, True)}


def _hits_t(cap):
    (_, _, hits), = cap["partial_search2"]
    return {f: _t(getattr(hits, f)) for f in hits._fields}


def _uni(cap):
    """The unified slot schema the JAX step selected from (the last 17
    select_ranked calls, one per field in SLOT_FIELDS order)."""
    return dict(zip(compact.SLOT_FIELDS,
                    (a[1] for (a, k, r) in cap["select_ranked"][-17:])))


def _margin(cap, L):
    return (cap["diag_chars"][0][2].shape[2] - L) // 2


def _g_budget(t, L):
    """The sweep's gap bound, as pipeline.py:1004-1007 computes it."""
    sp = t.splice_params
    gb = max(1, (-int(t.scoring.min_score(L))
                 - min(sp.rd_gap_open, sp.rf_gap_open))
             // max(min(sp.rd_gap_ext, sp.rf_gap_ext), 1))
    return min(gb, sp.min_intron - 1)


@pytest.mark.parametrize("lite", [True, False])
def test_compact_cands_plain_matches_jax(graph, traced, lite):
    """K3+K4's plain twin on the JAX step's hits against the candidate
    pool the JAX step went on with."""
    t = _tier(graph["ta"], lite)
    out, cap = traced[(lite, False)]
    h = _hits_t(cap)
    C = t.max_cands
    CC = min(t.core_cands, C)
    c = compact.compact_candidates_plain(
        t.dev.sa, h["top"], h["bot"], h["lo"], h["hi"], h["nh"],
        h["abefore"], h["post"], h["stopped"],
        max(t.cand_per_hit, t.short_rows, t.msize), C, CC, t.min_k,
        max(t.k, t.max_seeds), t.short_rows,
        t.lite_cap if lite else 0, True)
    # the reference window's starts: where(cvalid, cstart, -1)
    mstart = cap["diag_chars"][0][0][2]
    _eq(torch.where(c.cvalid, c.cstart, -1), mstart, "mstart")
    # the unified schema before selection: ungapped slots first
    U = _uni(cap)
    _eq(c.cstart, U["d1"][:, :CC], "cstart")
    _eq(c.cab, U["ab"][:, :CC], "cab")
    _eq(c.cpost.to(torch.int32), U["post"][:, :CC], "cpost")
    ext = cap["extend_grouped"][0][2]
    _eq((c.cvalid_long & _t(np.asarray(ext.ok))).to(torch.int32),
        U["valid"][:, :CC], "cvalid_long")
    for f in ("h_minw", "h_alignable") + (("h_sat",) if lite else ()):
        _eq(getattr(c, f), out[f], f)
    if lite:
        assert c.xstart.shape[1] == 0
        return
    # full pass: the sweep's inputs and the extra slots' block
    sw_args = cap["self_indel_sweep"][0][0]
    _eq(c.cstart, sw_args[4], "cstart (sweep)")
    _eq(c.cvalid, sw_args[5], "cvalid (sweep)")
    X = C - CC
    _eq(c.xstart, U["d1"][:, -X:], "xstart")
    _eq(c.xab, U["ab"][:, -X:], "xab")
    _eq(c.xpost.to(torch.int32), U["post"][:, -X:], "xpost")
    xs_m = cap["extend_grouped"][1][0][5]
    _eq(torch.where(c.xvalid, c.xstart, -1), xs_m, "xvalid")


@pytest.mark.parametrize("lite,full_out", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_pack_slots_plain_matches_jax(graph, traced, lite, full_out):
    """K9's plain twin on the JAX step's unified schema (taken from the
    spill trace: full_out changes only the selection and layout) against
    its outputs."""
    out, _ = traced[(lite, full_out)]
    U = _uni(traced[(lite, False)][1])
    blocks = [{f: _t(U[f]).to(torch.int32) for f in compact.SLOT_FIELDS}]
    K = blocks[0]["score"].shape[1]
    Mdev = min(K, max(10, _tier(graph["ta"], lite).msize + 2))
    got = compact.pack_slots_plain(blocks, Mdev, not full_out,
                                   has_event=True)
    keys = sorted(k for k in out if k.startswith(("u_", "sp_")))
    assert sorted(got) == keys
    for k in keys:
        _eq(got[k], out[k], k)


def test_snv_windows_match_jax(graph, traced):
    """K5 on the SNV planes: the same starts and margin as the reference
    window."""
    t = graph["ta"]
    _, cap = traced[(False, False)]
    dc = cap["diag_chars"]
    ref, s1, s2 = (c[2] for c in dc[:3])
    mstart = dc[0][0][2]
    n_text, L = t.meta.n, graph["codes"].shape[1]
    margin = _margin(cap, L)
    for plane, want in ((t.dev.ref_words, ref), (t.graph_dev["snv1"], s1),
                        (t.graph_dev["snv2"], s2)):
        _eq(splice.diag_chars_plain(plane, n_text, _t(mstart), L, margin),
            want, "window")
    assert (s1 != 0).any()


def test_extend_with_snv_matches_jax(graph, traced):
    """K6+K7 with SNV forgiveness, core (windowed) and extra slots."""
    t = graph["ta"]
    _, cap = traced[(False, False)]
    p_core, p_x = cap["pen_planes"][:2]
    e_core, e_x = cap["extend_grouped"][:2]
    n_text = t.meta.n
    for pp, ee, windowed in ((p_core, e_core, True), (p_x, e_x, False)):
        a, k, want_planes = pp
        reads, quals, lens, cs = (_t(a[i]) for i in (2, 3, 4, 5))
        if windowed:
            ch, s1, s2 = (_t(k[x]) for x in ("win_chars", "snv1_win",
                                            "snv2_win"))
            margin = (ch.shape[2] - reads.shape[1]) // 2
        else:
            ch = splice.diag_chars_plain(t.dev.ref_words, n_text, cs,
                                         reads.shape[1], 0)
            s1 = splice.diag_chars_plain(t.graph_dev["snv1"], n_text, cs,
                                         reads.shape[1], 0)
            s2 = splice.diag_chars_plain(t.graph_dev["snv2"], n_text, cs,
                                         reads.shape[1], 0)
            margin = 0
        pl = extend.pen_planes(n_text, reads, quals, lens, cs,
                               t.params["mm_pen"], t.scoring.n_pen, ch,
                               margin, s1, s2)
        for f in pl._fields:
            _eq(getattr(pl, f), np.asarray(getattr(want_planes, f)), f)
        if windowed:
            assert np.asarray(want_planes.snp_ok).any()
        minsc = _t(ee[1]["minsc"])
        r = extend.extend_grouped_plain(
            n_text, reads, quals, lens, cs, t.params["mm_pen"],
            t.params["clip_pen"], t.scoring.n_pen, ch, margin,
            uniform_len=True, minsc=minsc, mm_min=t.scoring.mm_min,
            snv1_win=s1, snv2_win=s2)
        for f in r._fields:
            _eq(getattr(r, f), np.asarray(getattr(ee[2], f)), f)


def test_sweep_with_snv_matches_jax(graph, traced):
    """K8 with the SNV windows."""
    t = graph["ta"]
    _, cap = traced[(False, False)]
    (a, k, want), = cap["self_indel_sweep"]
    ch, reads, quals, lens, starts, valid, minsc = (_t(x) for x in a[:7])
    got = splice.self_indel_sweep_plain(
        ch, reads, quals, lens, starts, valid, minsc, t.params["mm_pen"],
        t.scoring.n_pen, t.splice_params,
        max_gap=_g_budget(t, reads.shape[1]),
        snv1_w=_t(k["snv1_w"]), snv2_w=_t(k["snv2_w"]))
    for f in want:
        if want[f] is not None:
            _eq(got[f], want[f], f)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_live_pen_prefix_matches_jax(graph, chunk):
    """K11's plain twin on both JAX paths (chunked at chunk=64, dense at
    4096), with the SNV planes (tests/test_rank_ops.py:141 pattern)."""
    t = graph["ta"]
    rng = np.random.default_rng(chunk)
    N, J, L = 40, 14, 60
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    reads[rng.random((N, L)) < 0.02] = 4
    quals = rng.integers(20, 41, (N, L)).astype(np.int32)
    lens = rng.integers(30, L + 1, N).astype(np.int32)
    # fresh diagonals near the catalog's SNVs, a few off the text
    snv = np.asarray(t.graph.snv_joined)
    fresh = (rng.choice(snv, (N, J)) - rng.integers(0, L, (N, J))
             ).astype(np.int32)
    fresh[0, :3] = [-5, t.meta.n - 10, -L]
    live = rng.random((N, J)) < 0.3
    xq = rng.integers(0, L + 1, (N, J)).astype(np.int32)
    xr = np.minimum(xq + 3, L).astype(np.int32)
    mm_pen = np.arange(64, dtype=np.int32) // 10 + 2
    g = t.graph
    want = j_extend.live_pen_prefix(
        jnp.asarray(t.shards[0].ref_words), t.meta.n, jnp.asarray(reads),
        jnp.asarray(quals), jnp.asarray(lens), jnp.asarray(mm_pen), 1,
        jnp.asarray(fresh), jnp.asarray(live),
        [jnp.asarray(xq), jnp.asarray(xr)],
        snv_delta1=jnp.asarray(g.snv_delta1),
        snv_delta2=jnp.asarray(g.snv_delta2), chunk=chunk)
    got = extend.live_pen_prefix_plain(
        t.dev.ref_words, t.meta.n, _t(reads), _t(quals), _t(lens),
        _t(mm_pen), 1, _t(fresh), _t(live), [_t(xq), _t(xr)],
        snv_delta1=t.graph_dev["snv1"], snv_delta2=t.graph_dev["snv2"],
        chunk=chunk)
    flat = lambda r: [r[0], r[1]] + [v for p in r[2] for v in p]  # noqa
    for a, b in zip(flat(got), flat(want)):
        _eq(a, b, "live_pen_prefix")
    assert np.asarray(want[0])[live].any()


def test_inject_indels_matches_jax(graph, traced):
    """K10's plain twin (source prefixes rebuilt from the windows) on the
    JAX step's inputs against its output."""
    t = graph["ta"]
    _, cap = traced[(False, False)]
    (a, k, want), = cap["inject_indels"]
    reads, quals, lens, starts, valid = (_t(a[i]) for i in (2, 3, 4, 5, 6))
    ch, s1w, s2w = (_t(c[2]) for c in cap["diag_chars"][:3])
    margin = _margin(cap, reads.shape[1])
    gd = t.graph_dev
    got = splice.inject_indels_plain(
        t.dev.ref_words, t.meta.n, reads, quals, lens, starts, valid, ch,
        s1w, s2w, margin, gd["ind_ip"], gd["ind_len"], gd["ind_chars"],
        gd["ind_rkey"], gd["ind_rlen"], gd["ind_rrow"], t.params["mm_pen"],
        t.scoring.n_pen, _t(a[17]), gd["snv1"], gd["snv2"],
        slots=t.ss_slots)
    # (the JAX step adds ab/post to the same dict after the call)
    for f in ("score", "d1", "d2", "x", "kind", "spldir", "splscore",
              "event"):
        _eq(got[f], want[f], f)
    assert (want["event"] >= 0).any()


def _pack_both(ja, ta, codes, quals, lens, full_out):
    B = len(lens)
    minsc = np.array([ja.scoring.min_score(int(x)) for x in lens], np.int64)
    uniform = bool(np.all(lens == codes.shape[1]))
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    jp = ja._dispatch_packed(rd, qd, np.arange(B), uniform, h2d,
                             full_out=full_out)[0]
    tp = ta._dispatch_packed(codes, quals, lens, minsc, uniform,
                             full_out=full_out)[0]
    return jp, tp


@pytest.mark.parametrize("lite,full_out,var_lens", [
    (True, False, False), (True, True, False), (False, False, False),
    (False, True, False), (True, False, True), (False, False, True)])
def test_graph_step_matches_jax(graph, lite, full_out, var_lens):
    ja, ta = _tier(graph["ja"], lite), _tier(graph["ta"], lite)
    codes, lens = graph["codes"], graph["lens"]
    if var_lens:
        # every third read shorter (padded with N): the non-uniform path
        codes, lens = codes.copy(), lens.copy()
        lens[::3] -= np.arange(len(lens[::3])) % 17 + 1
        for i in range(0, len(lens), 3):
            codes[i, lens[i]:] = 4
    jp, tp = _pack_both(ja, ta, codes, graph["quals"], lens, full_out)
    w = np.asarray(jp).shape[1]
    assert ja._out_specs[w] == ta._out_specs[w]
    assert ja._spill_meta[w] == ta._spill_meta[w]
    _eq(tp[0].numpy(), jp, "packed buffer")
    jo, to = ja._merge_shards([jp]), ta._merge_shards([tp])
    assert sorted(jo) == sorted(to)
    for k in jo:
        _eq(to[k], jo[k], k)
    if not lite:
        assert (jo["u_event"] >= 0).any()      # known-indel slots


def test_align_batch_two_tier_matches_jax(graph):
    """The allele corpus through both tiers, with a routed subset that is
    not a power of two."""
    ja, ta = graph["ja"], graph["ta"]
    args = (graph["codes"], graph["quals"], graph["lens"])
    h = ta._advance_two_pass(ta.dispatch(*args), False)
    sub = h[3]
    assert 0 < sub.size < len(graph["lens"]) and sub.size & (sub.size - 1)
    rb = ta._finish_two_pass(h, False)
    ra = ja.align_batch(*args)
    for a, b in zip(ra.raw["cols"], rb.raw["cols"]):
        _eq(b, a, "raw column")
    jsnp = np.asarray(rb.raw["cols"][22])
    assert (jsnp >= 0).any()                   # known-indel alignments
    for k in ra.lanes or {}:
        if hasattr(ra.lanes[k], "shape"):
            _eq(rb.lanes[k], ra.lanes[k], k)


def test_two_tier_graph_dna_corpus_matches_jax(tmp_path):
    """tests/test_two_tier.py:19 test_two_tier_graph_dna's corpus and
    aligners (k = 10, lane metadata) through the port."""
    rng, g, _, index = _genome_and_catalog(tmp_path)
    B, L = 256, 100
    starts = rng.integers(0, len(g) - L - 50, B)
    codes = np.stack([g[s:s + L] for s in starts]).astype(np.int64)
    for i in range(B):
        ne = int(rng.integers(0, 4)) if i % 3 == 0 else 0
        for p in rng.choice(L, ne, replace=False):
            codes[i, p] = (codes[i, p] + 1 + int(rng.integers(0, 3))) % 4
    for i in range(0, B, 5):
        codes[i] = np.where(codes[i] < 4, 3 - codes[i], 4)[::-1]
    quals = np.full((B, L), 40, np.int64)
    lens = np.full(B, L, np.int64)
    ja = TPUAligner(index, variants=index._variants, lane_meta=True, k=10)
    ta = TorchAligner(index, variants=index._variants, lane_meta=True, k=10,
                      device="cpu")
    assert ta._fast is not None and ta._fast.lite
    assert ta._fast.dev is ta.dev
    assert ta._fast.graph_dev is ta.graph_dev
    r1, r2 = ja.align_batch(codes, quals, lens), ta.align_batch(codes, quals,
                                                                lens)
    for a, b in zip(r1.raw["cols"], r2.raw["cols"]):
        _eq(b, a, "raw column")
    for k in r1.lanes or {}:
        if hasattr(r1.lanes[k], "shape"):
            _eq(r2.lanes[k], r1.lanes[k], k)
