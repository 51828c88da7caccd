"""Port parity for the spliced slice: both spliced steps (the lite pass
with site injection and the full junction pass) and align_batch through
the two tiers and the temp-site fixed point, against hisat2_tpu on the
CPU.

The genome is tests/test_spliced.py's (200 kbp, six planted GT..AG
introns) with two more around a 40 bp exon; the batch mixes reads across
one and two introns, with
sequencing errors, an indel and short reads, and unspliced reads.  Both
splice-site DBs hold the same from-file and temp sites.

Tolerance: exact (the packed int32 buffer bit for bit, every raw column).
"""

import numpy as np
import pytest

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu_torch.align.pipeline import TorchAligner

INTRONS = [(30000, 200), (60000, 1000), (90000, 5000), (120000, 80),
           (150000, 20000), (180000, 500)]
PAIR = [(100000, 400), (100440, 600)]      # a 40 bp exon between two


def _genome():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 200000).astype(np.uint8)
    for s, ln in INTRONS + PAIR:
        g[s], g[s + 1] = 2, 3
        g[s + ln - 2], g[s + ln - 1] = 0, 2
    return g


def _batch(g, B=48, L=100):
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


def _seed_sites(db):
    """Four planted introns from file, one temp site seen by reads > 20."""
    for s, ln in INTRONS[:4]:
        db.add_known(0, s - 1, s + ln, 1)
    s, ln = INTRONS[5]
    db.add_novel(0, s - 1, s + ln, 1, rdid=20)


@pytest.fixture(scope="module")
def rna():
    g = _genome()
    idx = build_fm_index([("chrT", g)])
    ja = TPUAligner(idx, spliced=True, lane_meta=True)
    ta = TorchAligner(idx, spliced=True, lane_meta=True, device="cpu")
    for db in (ja.splice_db, ta.splice_db):
        _seed_sites(db)
    codes, quals, lens = _batch(g)
    return dict(g=g, idx=idx, ja=ja, ta=ta, codes=codes, quals=quals,
                lens=lens)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("lite,full_out", [(True, False), (False, False)])
def test_spliced_step_matches_jax(rna, lite, full_out):
    """The packed buffer, its layout and every unpacked key of the lite
    step (known-site injection, spliced schema) and the full step (prefix
    re-search, pair sweep, injection, second sweeps)."""
    ja, ta = (rna["ja"]._fast, rna["ta"]._fast) if lite else \
        (rna["ja"], rna["ta"])
    codes, quals, lens = rna["codes"], rna["quals"], rna["lens"]
    B = len(lens)
    rdids = np.arange(B, dtype=np.int64) + 5
    minsc = np.array([ja.scoring.min_score(int(x)) for x in lens], np.int64)
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    jp = ja._dispatch_packed(rd, qd, rdids, False, h2d,
                             full_out=full_out)[0]
    tp = ta._dispatch_packed(codes, quals, lens, minsc, False,
                             full_out=full_out, rdids=rdids)[0]
    w = np.asarray(jp).shape[1]
    assert ja._out_specs[w] == ta._out_specs[w]
    assert ja._spill_meta[w] == ta._spill_meta[w]
    _eq(tp[0].numpy(), jp, "packed buffer")
    jo, to = ja._merge_shards([jp]), ta._merge_shards([tp])
    assert sorted(jo) == sorted(to)
    for k in jo:
        _eq(to[k], jo[k], k)
    flags = jo["u_flags"]
    kinds = np.where((flags >> 4) >= 4, 1, flags >> 4)
    assert ((flags & 1) & (kinds == 1)).any()          # spliced slots
    assert ((flags & 1) & ((flags >> 3) & 1)).any()    # known-site slots
    if not lite:
        assert (jo["q2_score"] > -2 ** 29).any()


def test_align_batch_spliced_matches_jax(rna):
    """Both tiers, the routing by new splice-site boundaries, the temp-site
    fixed point and the host phase (composites, ZS), raw column by
    column; the two DBs end with the same sites."""
    ja, ta = rna["ja"], rna["ta"]
    args = (rna["codes"], rna["quals"], rna["lens"])
    ra, rb = ja.align_batch(*args), ta.align_batch(*args)
    for a, b in zip(ra.raw["cols"], rb.raw["cols"]):
        _eq(b, a, "raw column")
    for k in ra.lanes or {}:
        if hasattr(ra.lanes[k], "shape"):
            _eq(rb.lanes[k], ra.lanes[k], k)
    assert ja.splice_db.sites == ta.splice_db.sites
    jk = np.asarray(rb.raw["cols"][16])
    assert (jk == 1).sum() >= 10
