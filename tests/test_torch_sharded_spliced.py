"""Port parity for genome-scale spliced RNA: the spliced torch aligner on a
two-shard index sampled at off_rate 4, against hisat2_tpu on the CPU.

Two 100 kbp chromosomes, one shard each, with planted GT..AG introns of
80 bp to 20 kbp on both; the batch mixes reads across one intron (with
and without errors), across two introns around a 40 bp exon, with an
indel, and unspliced reads.  Both splice-site DBs hold the same from-file
sites on both chromosomes and one temp site.

- the lite step (site injection, the shard's window of the site tables)
  and the full step (prefix re-search with the narrow row cap of a
  sampled SA, its rows through the resolve walk; pair sweep, second
  sweeps with the shard's n_text) of each shard: packed buffers, layouts
  and the merged keys, the per-lane q2_* set of the winning shard;
- align_batch through the two tiers and the temp-site fixed point;
- _merge_shards on the full step's fetched outputs with shard bases [0,
  2^31 + 4096].

Tolerance: exact (the packed int32 buffers, every raw column).
"""

import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu_torch.align.pipeline import TorchAligner

N_CHR = 100000
INTRONS = [(20000, 200), (40000, 1000), (60000, 5000), (75000, 80),
           (80000, 15000)]
EXON = [(10000, 400), (10440, 600)]        # a 40 bp exon between two


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs in parallel
    workers, and torch's default of a thread per core oversubscribes the
    CPU (each small op then waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chrom(seed):
    g = np.random.default_rng(seed).integers(0, 4, N_CHR).astype(np.uint8)
    for s, ln in INTRONS + EXON:
        g[s], g[s + 1] = 2, 3
        g[s + ln - 2], g[s + ln - 1] = 0, 2
    return g


def _batch(chroms, B=48, L=100):
    rng = np.random.default_rng(31)
    codes = np.zeros((B, L), np.uint8)
    for i in range(B):
        g = chroms[i % 2]
        k = (i // 2) % 6
        s, ln = INTRONS[(i // 2) % len(INTRONS)]
        x = int(rng.integers(10, L - 10))
        if k in (0, 1, 2):
            r = np.concatenate([g[s - x:s], g[s + ln:s + ln + L - x]])
        elif k == 3:
            p = int(rng.integers(1000, N_CHR - 1000))
            r = np.concatenate([g[p:p + x], g[p + x + 3:p + L + 3]])
        elif k == 4:
            a = int(rng.integers(20, 40))
            r = np.concatenate([g[10000 - a:10000], g[10400:10440],
                                g[11040:11040 + L]])
        else:
            p = int(rng.integers(1000, N_CHR - 1000))
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


def _seed_sites(db):
    for ref in (0, 1):
        for s, ln in INTRONS[:3]:
            db.add_known(ref, s - 1, s + ln, 1)
    s, ln = INTRONS[3]
    db.add_novel(1, s - 1, s + ln, 1, rdid=20)


@pytest.fixture(scope="module")
def rna():
    chroms = [_chrom(7), _chrom(8)]
    sh = build_fm_index([("cA", chroms[0]), ("cB", chroms[1])],
                        shard_bp=N_CHR + 1000, off_rate=4)
    assert len(sh.shards) == 2
    assert all(s.meta.off_rate == 4 for s in sh.shards)
    ja = TPUAligner(sh, spliced=True, lane_meta=True)
    ta = TorchAligner(sh, spliced=True, lane_meta=True, device="cpu")
    for db in (ja.splice_db, ta.splice_db):
        _seed_sites(db)
    codes, quals, lens = _batch(chroms)
    return dict(ja=ja, ta=ta, codes=codes, quals=quals, lens=lens, disp={})


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _dispatch_both(rna, lite):
    """Both packages' per-shard packed buffers of the lite or full step
    (once per module)."""
    if lite not in rna["disp"]:
        ja, ta = (rna["ja"]._fast, rna["ta"]._fast) if lite else \
            (rna["ja"], rna["ta"])
        codes, quals, lens = rna["codes"], rna["quals"], rna["lens"]
        B = len(lens)
        rdids = np.arange(B, dtype=np.int64) + 5
        minsc = np.array([ja.scoring.min_score(int(x)) for x in lens],
                         np.int64)
        rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
        rna["disp"][lite] = (
            ja._dispatch_packed(rd, qd, rdids, False, h2d),
            ta._dispatch_packed(codes, quals, lens, minsc, False,
                                rdids=rdids))
    return rna["disp"][lite]


@pytest.mark.parametrize("lite", (True, False))
def test_spliced_two_shard_steps_match_jax(rna, lite):
    ja, ta = (rna["ja"]._fast, rna["ta"]._fast) if lite else \
        (rna["ja"], rna["ta"])
    jps, tps = _dispatch_both(rna, lite)
    assert len(jps) == len(tps) == 2
    for jp, tp in zip(jps, tps):
        w = np.asarray(jp).shape[1]
        assert ja._out_specs[w] == ta._out_specs[w]
        assert ja._spill_meta[w] == ta._spill_meta[w]
        _eq(tp[0].numpy(), jp, "packed buffer")
    jo, to = ja._merge_shards(jps), ta._merge_shards(tps)
    assert sorted(jo) == sorted(to)
    for k in jo:
        _eq(to[k], jo[k], k)
    flags = jo["u_flags"]
    kinds = np.where((flags >> 4) >= 4, 1, flags >> 4)
    assert ((flags & 1) & (kinds == 1)).any()          # spliced slots
    assert ((flags & 1) & ((flags >> 3) & 1)).any()    # known-site slots
    if not lite:
        assert (jo["q2_score"] > -2 ** 29).any()


def test_merge_shards_int64_matches_jax(rna):
    """The full step's per-shard outputs merged as if the second shard
    began at 2^31 + 4096: int64 positions, the q2_* set per lane from the
    shard with the best composite."""
    ja, ta = rna["ja"], rna["ta"]
    _, tps = _dispatch_both(rna, False)
    outs = [ta._fetch_out(p) for p in tps]
    # let the second shard win some lanes' q2 set and lose others
    outs[1]["q2_score"] = outs[1]["q2_score"] + np.where(
        np.arange(len(outs[1]["q2_score"]))[:, None] % 3 == 0, 1, -1)

    def merged(al):
        saved = al.shard_bases
        al.shard_bases = [0, 2 ** 31 + 4096]
        al._fetch_out = lambda o: {k: v.copy() for k, v in o.items()}
        try:
            return al._merge_shards(outs)
        finally:
            al.shard_bases = saved
            del al._fetch_out

    jm, tm = merged(ja), merged(ta)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        assert jm[k].dtype == tm[k].dtype, k
        _eq(tm[k], jm[k], k)
    assert tm["q2_d"].dtype == np.int64 and tm["q2_d"].max() >= 2 ** 31


def test_spliced_two_shard_align_batch_matches_jax(rna):
    ja, ta = rna["ja"], rna["ta"]
    args = (rna["codes"], rna["quals"], rna["lens"])
    ra, rb = ja.align_batch(*args), ta.align_batch(*args)
    for a, b in zip(ra.raw["cols"], rb.raw["cols"]):
        _eq(b, a, "raw column")
    for k in ra.lanes or {}:
        if hasattr(ra.lanes[k], "shape"):
            _eq(rb.lanes[k], ra.lanes[k], k)
    assert ja.splice_db.sites == ta.splice_db.sites
    cols = rb.raw["cols"]
    spl = np.asarray(cols[16]) == 1
    refs = np.asarray(cols[2])
    assert (spl & (refs == 0)).sum() >= 5 and (spl & (refs == 1)).sum() >= 5
