"""Port parity for spliced shapes the junction kernels once refused on the
card, on the CPU against hisat2_tpu:

- the spliced full step (prefix re-search, pair sweep, injection, second
  sweeps) and the lite step on a batch whose longest read is 600 bp (the
  rest 100-300 bp), reads across one or two introns;
- the spliced full step at -k 24, so C = max(k + 1, 6) + 8 = 33
  candidates per lane, with reads on a 30-copy repeat.

Both give TPUAligner's packed buffer bit for bit.  The card runs the same
shapes through the kernels in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu_torch.align.pipeline import TorchAligner

INTRONS = [(30000, 200), (60000, 1000), (90000, 5000), (120000, 80),
           (150000, 20000), (180000, 500)]
PAIR = [(100000, 400), (100440, 600)]      # a 40 bp exon between two


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(71)
    g = rng.integers(0, 4, 200000).astype(np.uint8)
    for s, ln in INTRONS + PAIR:
        g[s], g[s + 1] = 2, 3
        g[s + ln - 2], g[s + ln - 1] = 0, 2
    return g, build_fm_index([("chrT", g)])


def _batch(g, rng, B, lens):
    """Reads of lens[i] bp: across one intron, across both introns of the
    40 bp exon, with a 4 bp deletion, or unspliced; errors, reverse
    strands."""
    L = int(lens.max())
    codes = np.full((B, L), 4, np.uint8)
    for i in range(B):
        n = int(lens[i])
        s, ln = INTRONS[i % len(INTRONS)]
        x = int(rng.integers(8, n - 8))
        k = i % 4
        if k in (0, 1):
            r = np.concatenate([g[s - x:s], g[s + ln:s + ln + n - x]])
        elif k == 2:
            a = int(rng.integers(20, 40))
            r = np.concatenate([g[100000 - a:100000], g[100400:100440],
                                g[101040:101040 + n]])
        else:
            p = int(rng.integers(1000, 190000 - n))
            r = np.concatenate([g[p:p + x], g[p + x + 4:p + n + 4]])
        r = r[:n].copy()
        if i % 3 == 1:
            for q in rng.choice(n, 3, replace=False):
                r[q] = (r[q] + 1) % 4
        if i % 5 == 0:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        codes[i, :n] = r
    quals = rng.integers(10, 41, (B, L)).astype(np.uint8)
    return codes, quals, lens.astype(np.int32)


def _seed_sites(db):
    for s, ln in INTRONS[:3]:
        db.add_known(0, s - 1, s + ln, 1)
    s, ln = INTRONS[4]
    db.add_novel(0, s - 1, s + ln, 1, rdid=20)


def _compare(idx, codes, quals, lens, lite, full_out=False, **kw):
    ja = TPUAligner(idx, spliced=True, lane_meta=True, **kw)
    ta = TorchAligner(idx, spliced=True, lane_meta=True, device="cpu", **kw)
    for db in (ja.splice_db, ta.splice_db):
        _seed_sites(db)
    if lite:
        ja, ta = ja._fast, ta._fast
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
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp),
                                  err_msg="packed buffer")
    return ta._merge_shards([tp])


@pytest.mark.parametrize("lite", [False, True])
def test_spliced_step_matches_jax_at_600bp(genome, lite):
    g, idx = genome
    rng = np.random.default_rng(600)
    B = 16
    lens = np.concatenate([[600], rng.integers(100, 301, B - 1)])
    out = _compare(idx, *_batch(g, rng, B, lens), lite)
    flags = out["u_flags"]
    kinds = np.where((flags >> 4) >= 4, 1, flags >> 4)
    assert ((flags & 1) & (kinds == 1)).any()          # spliced slots


def test_spliced_step_matches_jax_at_k24():
    """C = 33 candidates per lane on the full step."""
    rng = np.random.default_rng(24)
    g = rng.integers(0, 4, 200000).astype(np.uint8)
    for s, ln in INTRONS + PAIR:
        g[s], g[s + 1] = 2, 3
        g[s + ln - 2], g[s + ln - 1] = 0, 2
    # 30 copies of a 150 bp unit: reads on it have more hits than 24
    unit = rng.integers(0, 4, 150).astype(np.uint8)
    for k in range(30):
        g[2000 + 600 * k:2150 + 600 * k] = unit
    idx = build_fm_index([("chrT", g)])
    ta = TorchAligner(idx, spliced=True, k=24, device="cpu")
    assert ta.core_cands == 33
    B = 24
    codes, quals, lens = _batch(g, rng, B, np.full(B, 100))
    for i in range(0, B, 6):
        codes[i] = g[2020 + 600 * (i % 30):2120 + 600 * (i % 30)]
    # the repeat's 30 placements pass the spill rows: the dense layout
    out = _compare(idx, codes, quals, lens, False, full_out=True, k=24)
    assert (out["q2_score"] > -2 ** 29).any()
