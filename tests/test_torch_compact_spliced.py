"""Port parity for the candidate compaction (K3+K4) in spliced mode and the
slot merge (K9) of a spliced step, against hisat2_tpu on the CPU.

tests/test_torch_spliced.py's genome (200 kbp, planted GT..AG introns)
built as a `--ss` RNA index (its introns as splice sites) with a full
suffix array and again sampled at off_rate 4.  The JAX full spliced step
is traced once per index with spies on its ops (the hits, the prefix
re-search's hits, the resolved rows, the unified slot schema); then

- compact_candidates_plain in spliced mode (the re-search rows, the
  proximity filter, the distance rank; on the sampled index through the
  walk's offsets `offs` / `offs2`) is held against the candidate pool the
  JAX step went on with;
- the blocks the port's own step hands to kernel 6 make the JAX step's
  schema (slot_schema), and pack_slots on them (the plain twin on the
  CPU, spliced words) gives the JAX step's u_* / sp_* outputs;
- pack_slots_plain's stable top-Mdev selection equals JAX's
  stable_rank_asc + select_ranked at K = 130, Mdev 22 and 66, with ties.

Tolerance: exact (integer results).
"""

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
from hisat2_tpu.ops import resolve as j_resolve
from hisat2_tpu.ops import search as j_search
from hisat2_tpu.ops import splice as j_splice
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.ops import compact

# tests/test_torch_spliced.py's introns and two-junction pair
INTRONS = [(30000, 200), (60000, 1000), (90000, 5000), (120000, 80),
           (150000, 20000), (180000, 500)]
PAIR = [(100000, 400), (100440, 600)]


def _genome():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 200000).astype(np.uint8)
    for s, ln in INTRONS + PAIR:
        g[s], g[s + 1] = 2, 3
        g[s + ln - 2], g[s + ln - 1] = 0, 2
    return g


def _batch(g, B=48, L=100):
    """Reads across one intron (half), across the 40 bp exon, with a small
    gap, and unspliced; errors, reverse complements and short reads."""
    rng = np.random.default_rng(17)
    codes = np.zeros((B, L), np.uint8)
    for i in range(B):
        k = i % 6
        s, ln = INTRONS[i % len(INTRONS)]
        x = int(rng.integers(8, L - 8))
        if k in (0, 1, 2):
            r = np.concatenate([g[s - x:s], g[s + ln:s + ln + L - x]])
        elif k == 3:
            p = int(rng.integers(1000, 190000))
            r = np.concatenate([g[p:p + x], g[p + x + 4:p + L + 4]])
        elif k == 4:
            a = int(rng.integers(20, 40))
            r = np.concatenate([g[100000 - a:100000], g[100400:100440],
                                g[101040:101040 + L]])
        else:
            p = int(rng.integers(1000, 190000))
            r = g[p:p + L].copy()
        r = r[:L].copy()
        if i % 4 == 1:
            for q in rng.choice(L, 2, replace=False):
                r[q] = (r[q] + 1) % 4
        if i % 5 == 0:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        codes[i] = r
    quals = rng.integers(10, 41, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    lens[::11] = L - 13
    for i in range(0, B, 11):
        codes[i, lens[i]:] = 4
    return codes, quals, lens


_SPIES = ((j_search, "partial_search2"), (j_search, "search_lanes_live"),
          (j_resolve, "resolve_consecutive"), (j_splice, "diag_chars"),
          (j_extend, "extend_grouped"), (j_compact, "select_ranked"))


def _jax_step(ja, codes, quals, lens, rdids):
    """Trace the JAX full spliced step (spill layout) with spies on its
    ops; returns its outputs and {op name: [(args, kwargs, result)]}."""
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

    dev = ja.devs[0]
    params = {**ja.params, **ja.shard_params[0]}
    ss = ja.splice_db.device_tables(ja.shard_bases[0], dev.meta.n)
    minsc = np.array([ja.scoring.min_score(int(x)) for x in lens], np.int32)
    try:
        for m, nm, fn in saved:
            setattr(m, nm, spy(nm, fn))

        def run(reads, quals_, lens_, minsc_, rd):
            out = ja._align_device(dev, params, reads, quals_, lens_, minsc_,
                                   rd, ss, uniform=False, full_out=False)
            return out, {nm: [arrays(c) for c in v]
                         for nm, v in calls.items()}

        out, cap = jax.jit(run)(
            jnp.asarray(codes, jnp.int32), jnp.asarray(quals, jnp.int32),
            jnp.asarray(lens, jnp.int32), jnp.asarray(minsc),
            jnp.asarray(rdids, jnp.int32))
    finally:
        for m, nm, fn in saved:
            setattr(m, nm, fn)
        ja._traced_spill_mdev = None
    to_np = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    return ({k: np.asarray(v) for k, v in out.items()},
            jax.tree_util.tree_map(to_np, cap,
                                   is_leaf=lambda v: v is None))


@pytest.fixture(scope="module", params=[0, 4], ids=["full_sa", "off_rate4"])
def rna(request, tmp_path_factory):
    off_rate = request.param
    g = _genome()
    ss = tmp_path_factory.mktemp("ss") / "g.ss"
    ss.write_text("".join(f"chrT\t{s - 1}\t{s + ln}\t+\n"
                          for s, ln in INTRONS[:4]))
    idx = build_fm_index([("chrT", g)], off_rate=off_rate)
    attach_variants(idx, ss_file=str(ss))
    assert idx.meta.off_rate == off_rate and len(idx._variants.ss_ref) == 4
    ja = TPUAligner(idx, variants=idx._variants, spliced=True,
                    lane_meta=True)
    ta = TorchAligner(idx, variants=idx._variants, spliced=True,
                      lane_meta=True, device="cpu")
    codes, quals, lens = _batch(g)
    rdids = np.arange(len(lens), dtype=np.int64) + 5
    out, cap = _jax_step(ja, codes, quals, lens, rdids)
    tcap = {}
    rd_t, ss_t = ta._step_site_args(rdids)
    ta.step(*ta.upload(codes, quals, lens, ta._minsc(lens)), False,
            capture=tcap, rdids=rd_t, ss=ss_t)
    return dict(ja=ja, ta=ta, out=out, cap=cap, tcap=tcap)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _uni(cap, F):
    """The unified slot schema the JAX step selected from (its last F
    select_ranked calls, one per field in SLOT_FIELDS order)."""
    return dict(zip(compact.SLOT_FIELDS,
                    (a[1] for (a, k, r) in cap["select_ranked"][-F:])))


def test_compact_cands_spliced_plain_matches_jax(rna):
    """K3+K4's plain twin in spliced mode on the JAX step's hits, prefix
    re-search hits and (sampled SA) resolved rows, against the candidate
    pool the JAX step went on with."""
    ta, out, cap = rna["ta"], rna["out"], rna["cap"]
    (_, _, hits), = cap["partial_search2"][:1]
    (_, _, hits2), = cap["search_lanes_live"]
    h = {f: _t(getattr(hits, f)) for f in hits._fields}
    h2 = {f: _t(getattr(hits2, f)) for f in hits2._fields}
    sampled = ta.meta.off_rate > 0
    offs = offs2 = None
    if sampled:
        offs, offs2 = (_t(r) for (_, _, r) in cap["resolve_consecutive"])
    P2 = 32 if not sampled else ta.short_rows
    C = ta.max_cands
    CC = min(ta.core_cands, C)
    c = compact.compact_candidates_plain(
        ta.devs[0].sa, h["top"], h["bot"], h["lo"], h["hi"], h["nh"],
        h["abefore"], h["post"], h["stopped"],
        max(ta.cand_per_hit, ta.short_rows, ta.msize), C, CC, ta.min_k,
        max(ta.k, ta.max_seeds), ta.short_rows, 0, True,
        top2=h2["top"], bot2=h2["bot"], lo2=h2["lo"], nh2=h2["nh"], P2=P2,
        max_intron=ta.scoring.max_intron_len, offs=offs, offs2=offs2)
    # the re-search rows join the pool: some lanes resolve them
    w2 = h2["bot"] - h2["top"]
    assert bool(((w2 > 0) & (w2 <= P2)
                 & (torch.arange(2)[None, :] < h2["nh"][:, None])).any())
    mstart = cap["diag_chars"][0][0][2]
    _eq(torch.where(c.cvalid, c.cstart, -1), mstart, "mstart")
    U = _uni(cap, 16)
    _eq(c.cstart, U["d1"][:, :CC], "cstart")
    _eq(c.cab, U["ab"][:, :CC], "cab")
    _eq(c.cpost.to(torch.int32), U["post"][:, :CC], "cpost")
    ext = cap["extend_grouped"][0][2]
    _eq((c.cvalid_long & _t(np.asarray(ext.ok))).to(torch.int32),
        U["valid"][:, :CC], "cvalid_long")
    for f in ("h_minw", "h_alignable"):
        _eq(getattr(c, f), out[f], f)
    X = C - CC
    if X:
        _eq(c.xstart, U["d1"][:, -X:], "xstart")
        _eq(c.xab, U["ab"][:, -X:], "xab")
        _eq(c.xpost.to(torch.int32), U["post"][:, -X:], "xpost")


def test_pack_slots_spliced_blocks_match_jax(rna):
    """The blocks of the port's spliced full step, read by pack_slots (on
    the CPU: slot_schema, then pack_slots_plain, spliced words), against
    the JAX step's unified schema and its u_* / sp_* outputs."""
    out, cap, tcap = rna["out"], rna["cap"], rna["tcap"]
    kw = tcap["pack_slots"]
    assert kw["spliced"] and kw["use_spill"] and not kw["has_event"]
    blocks = kw["blocks"]
    assert len(blocks) >= 3
    assert any(isinstance(v, int) for b in blocks for v in b.values())
    assert any(v.dtype == torch.bool for b in blocks for v in b.values()
               if torch.is_tensor(v))
    U = _uni(cap, 16)
    uni = compact.slot_schema(blocks, False)
    assert uni.shape[0] == 16
    for i, f in enumerate(compact.SLOT_FIELDS[:16]):
        _eq(uni[i], U[f], f"schema {f}")
    got = compact.pack_slots(**kw)
    keys = sorted(k for k in out if k.startswith(("u_", "sp_")))
    assert sorted(got) == keys and "sp_w" in keys
    assert got["sp_w"].shape[1] == 5
    for k in keys:
        _eq(got[k], out[k], k)


@pytest.mark.parametrize("Mdev", [22, 66])
def test_pack_slots_selection_matches_jax(Mdev):
    """pack_slots_plain's stable top-Mdev by (valid desc, score desc)
    against JAX's stable_rank_asc + select_ranked at K = 130, scores drawn
    from four values (ties everywhere), a third of the slots invalid."""
    rng = np.random.default_rng(Mdev)
    N, K = 64, 130
    uni = rng.integers(0, 3, (16, N, K)).astype(np.int32)
    uni[0] = rng.integers(-3, 1, (N, K))
    uni[1] = rng.integers(0, 10 ** 6, (N, K))
    uni[2] = uni[1] + rng.integers(-5, 6, (N, K))
    uni[7] = rng.integers(0, 9, (N, K))
    uni[15] = rng.random((N, K)) < 0.67
    blocks = [dict(zip(compact.SLOT_FIELDS, _t(uni).unbind(0)))]
    got = compact.pack_slots_plain(blocks, Mdev, False)
    skey = jnp.where(uni[15] > 0, -uni[0], np.int32(2 ** 31 - 1))
    rank = j_compact.stable_rank_asc(skey)
    msel = rank[:, None, :] == jnp.arange(Mdev, dtype=jnp.int32)[None, :,
                                                                  None]
    sel = {f: np.asarray(j_compact.select_ranked(msel, jnp.asarray(uni[i])))
           for i, f in enumerate(compact.SLOT_FIELDS[:16])}
    for f in ("score", "d1", "x", "ab", "n_mm", "n_n", "clip_l", "clip_r"):
        _eq(got["u_" + f], sel[f], f)
    _eq(got["u_dd"], sel["d2"] - sel["d1"], "dd")
    cs = np.where(sel["spldir"] > 0, 3 + sel["spldir"], sel["kind"])
    flags = (sel["valid"] | (sel["post"] << 1) | (sel["selfgap"] << 2)
             | (sel["known"] << 3) | (cs << 4))
    _eq(got["u_flags"], flags, "flags")
