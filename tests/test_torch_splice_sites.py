"""Port parity for the splice-site tables: the intron-length penalty table
of K13/K15, table_searchsorted (site_search.cuh's plain twin), K18
(merge_sorted_tabs) and SpliceSiteDB.device_tables, and K17
(search_lanes_live) against hisat2_tpu on the CPU.

Tolerance: exact.  The incremental merge's bucket index is checked by the
lookups it gives (against a full rebuild's sorted tables), not by its raw
lob arrays, which legitimately keep the rebuild-time shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align import splice_db as j_sdb
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.ops import search as j_search
from hisat2_tpu.ops import splice as j_splice
from hisat2_tpu_torch.align import splice_db as t_sdb
from hisat2_tpu_torch.index.format import to_device
from hisat2_tpu_torch.ops import search, sites, splice

SENT = 2 ** 31 - 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("const,coef", [(-8.0, 1.0), (-8.0, 2.0)])
def test_lenpen_table_matches_jax(const, coef):
    """The step table against JAX's f32 trunc(max(0, const + coef*ln D))
    (splice.py:614-619) for every D in [20, 500000]: G,-8,1 and --dta's
    noncanonical G,-8,2."""
    D = np.arange(20, 500001, dtype=np.int32)
    logd = jnp.log(jnp.maximum(jnp.asarray(D), 1).astype(jnp.float32))
    want = jnp.maximum((const + coef * logd).astype(jnp.int32), 0)
    tab = tuple(_t(a) for a in splice.lenpen_table(const, coef, 500000))
    _eq(splice.lenpen_lookup(_t(D), tab), want, "lenpen")
    assert int(np.asarray(want)[-1]) >= 5


def _sorted_table(rng, cap, nn, hi):
    kd = np.sort(rng.integers(0, hi, nn)).astype(np.int32)
    kd[10:14] = kd[10]                          # equal keys
    a = np.full(cap, SENT, np.int32)
    a[:nn] = kd
    return a


@pytest.mark.parametrize("lob", [False, True])
def test_table_searchsorted_matches_jax(lob):
    rng = np.random.default_rng(3)
    cap, nn, hi = 4096, 3000, 9_000_000
    tab = _sorted_table(rng, cap, nn, hi)
    q = np.concatenate([rng.integers(-50, hi + 50, 5000),
                        tab[:200], [-(2 ** 31), SENT, 2 ** 31 - 1]]
                       ).astype(np.int32)
    jl = tl = shift = None
    if lob:
        shift = max(0, (hi - 1).bit_length() - (1 << 19).bit_length() + 1)
        edges = np.arange((1 << 19) + 1, dtype=np.int64) << shift
        lo = np.searchsorted(tab[:nn], edges).astype(np.int32)
        jl, tl = jnp.asarray(lo), _t(lo)
    want = j_splice.table_searchsorted(
        jnp.asarray(tab), jnp.asarray(q), jl,
        None if shift is None else jnp.int32(shift))
    got = splice.table_searchsorted(_t(tab), _t(q), tl, shift)
    _eq(got, want, "lookup")
    inr = q <= SENT             # the bucket span ends at the sentinels
    _eq(got[inr], np.searchsorted(tab, q[inr]), "lookup vs numpy")


def test_merge_sorted_tabs_plain_matches_jax():
    """K18's plain twin on a 4096-row table set with ties between old and
    new keys, 300 real new rows in the 512-row chunk, and new bins beyond
    the rebuild-time range (clipped to the last bin)."""
    rng = np.random.default_rng(5)
    cap, nn = 4096, 3000
    kd = _sorted_table(rng, cap, nn, 5_000_000)
    ka = np.where(kd < SENT, kd + rng.integers(30, 9000, cap), SENT
                  ).astype(np.int32)
    o = np.lexsort((ka[:nn], kd[:nn]))
    kd[:nn], ka[:nn] = kd[:nn][o], ka[:nn][o]
    rd = np.where(kd < SENT, rng.integers(-1, 50, cap), -1).astype(np.int32)
    o2 = np.lexsort((kd[:nn], ka[:nn]))
    ka_s, kd_s, rd_a = (np.full(cap, f, np.int32) for f in (SENT, SENT, -1))
    ka_s[:nn], kd_s[:nn], rd_a[:nn] = ka[:nn][o2], kd[:nn][o2], rd[:nn][o2]
    m = 300
    nkd = np.full(512, SENT, np.int32)
    nka = nkd.copy()
    nrd = np.full(512, -1, np.int32)
    nkd[:m] = rng.integers(0, 6_000_000, m)
    nkd[:4] = kd[10]                            # ties with old rows
    nka[:m] = nkd[:m] + rng.integers(30, 9000, m)
    nka[:2] = ka[10]
    nrd[:m] = rng.integers(50, 90, m)
    shift = 4
    NB = 1 << 19
    edges = np.arange(NB + 1, dtype=np.int64) << shift
    lob_kd = np.searchsorted(kd[:nn], edges).astype(np.int32)
    lob_ka = np.searchsorted(ka_s[:nn], edges).astype(np.int32)
    bkd, bka, wts = (np.zeros(512, np.int32) for _ in range(3))
    bkd[:m] = np.clip(nkd[:m].astype(np.int64) >> shift, 0, NB - 1)
    bka[:m] = np.clip(nka[:m].astype(np.int64) >> shift, 0, NB - 1)
    wts[:m] = 1
    args = (kd, ka, rd, ka_s, kd_s, rd_a, nkd, nka, nrd, lob_kd, lob_ka,
            bkd, bka, wts)
    want = j_sdb._merge_sorted_tabs(*(jnp.asarray(a) for a in args))
    got = sites.merge_sorted_tabs(*(_t(a) for a in args))
    assert len(got) == len(want) == 8
    for a, b, nm in zip(got, want, ("kd", "ka", "rd", "ka_s", "kd_s", "rd_a",
                                    "lob_kd", "lob_ka")):
        _eq(a, b, nm)
    # the merged index finds every key as a full sort would
    q = _t(np.concatenate([nkd[:m], kd[:nn], [0, 2 ** 30]]).astype(np.int32))
    _eq(splice.table_searchsorted(got[0], q, got[6], shift),
        np.searchsorted(np.asarray(got[0]), q.numpy()), "merged lookup")


def test_device_tables_match_jax():
    """SpliceSiteDB through waves of new sites: the port's device_tables
    (rebuilds and K18 merges) against the JAX DB's, table by table, and
    their lookups against a fresh rebuild's; the last waves reach past the
    rebuild-time key range."""
    rng = np.random.default_rng(8)
    g = rng.integers(0, 4, 60000).astype(np.uint8)
    idx = build_fm_index([("c1", g)])
    jdb, tdb = j_sdb.SpliceSiteDB(idx), t_sdb.SpliceSiteDB(idx, device="cpu")
    pos = np.concatenate([rng.integers(100, 20000, 200),
                          rng.integers(20000, 59000, 120)])
    sites_ = list(dict.fromkeys((0, int(a), int(a + d)) for a, d in zip(
        pos, rng.integers(60, 600, len(pos)))))
    merges = 0
    for w in range(0, len(sites_), 40):
        for k, s in enumerate(sites_[w:w + 40]):
            for db in (jdb, tdb):
                if k % 5 == 0:
                    db.add_known(*s, 1)
                else:
                    db.add_novel(*s, 1, rdid=w + k)
        jt, tt = jdb.device_tables(), tdb.device_tables()
        assert sorted(jt) == sorted(tt)
        for k in jt:
            _eq(tt[k], np.asarray(jt[k]), f"wave {w} {k}")
        merges = tdb.n_merges
        fresh = t_sdb.SpliceSiteDB(idx, device="cpu")
        fresh.sites, fresh._col_jl = tdb.sites, tdb._col_jl
        fresh._col_jr, fresh._col_rdid = tdb._col_jr, tdb._col_rdid
        ft = fresh.device_tables()
        q = _t(rng.integers(0, 60000, 500).astype(np.int32))
        for key, lob in (("ss_kd", "ss_kd_lob"), ("ss_ka_s", "ss_ka_lob")):
            _eq(tt[key], ft[key], key + " vs rebuild")
            _eq(splice.table_searchsorted(tt[key], q, tt.get(lob),
                                          tt.get("ss_shift")),
                splice.table_searchsorted(ft[key], q), key + " lookup")
    assert merges >= 3


@pytest.fixture(scope="module")
def idx60():
    rng = np.random.default_rng(6)
    g = rng.integers(0, 4, 60000).astype(np.int8)
    idx = build_fm_index([("c", g)])
    return idx, g, to_device(idx, "cpu")


@pytest.mark.parametrize("chunk", [64, 4096])
def test_search_lanes_live_matches_jax(idx60, chunk):
    """K17's plain twin: the spliced prefix re-search over lanes with cut
    lengths, compacted and chunked (B = 200 above chunk = 64) or dense."""
    idx, g, tdev = idx60
    rng = np.random.default_rng(chunk)
    B, L = 200, 100
    reads = np.zeros((B, L), np.int32)
    for i in range(B):
        o = int(rng.integers(0, len(g) - L))
        reads[i] = g[o:o + L]
        reads[i, int(rng.integers(0, L))] = (reads[i, 0] + 1) % 4
    cut = np.where(rng.random(B) < 0.4, rng.integers(0, L + 1, B),
                   rng.integers(0, 7, B)).astype(np.int32)
    meta = idx.meta
    jd = idx.to_device()

    def fn(rr, ll):
        return j_search.partial_search2(
            jd.blocked, jd.fchr, jd.ftab2_top, meta.zrow, meta.zrow2,
            meta.rows, rr, ll, 2, 7, 9)

    want = jax.jit(lambda r, c: j_search.search_lanes_live(
        fn, r, c, 7, chunk=chunk))(jnp.asarray(reads), jnp.asarray(cut))
    got = search.search_lanes_live(
        tdev.blocked, tdev.fchr, tdev.ftab2_top, meta.zrow, meta.zrow2,
        meta.rows, _t(reads), _t(cut), 2, 7, 9, chunk=chunk)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    assert (np.asarray(want.nh) > 0).sum() > 20
