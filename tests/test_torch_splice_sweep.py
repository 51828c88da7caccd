"""Port parity for the junction sweeps: the plain twins of K13 (pair_sweep),
K14 (select_pairs), K15 (second_sweep) and K16 (inject_known) against
hisat2_tpu.ops.splice on the CPU.

A seeded 80 kbp genome with planted GT-AG, GC-AG and AT-AC introns; reads
of one, two and three exons, with an indel, with sequencing errors and
with short tails; each lane's candidate diagonals hold its true exon
diagonals, near and far decoys and a dead slot.  The reference windows
and penalty planes come from the JAX package and go to both sides; the
site tables hold the planted junctions (from file, and temp sites with
discovery readids), with and without the bucket index.

Tolerance: exact (f32 fields compared by their bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.ops import extend as j_extend
from hisat2_tpu.ops import splice as j_splice
from hisat2_tpu_torch.ops import splice
from hisat2_tpu_torch.utils.intops import u32_to_tensor

L, M = 80, 16
SENT = 2 ** 31 - 2
# (donor dinucleotide, acceptor dinucleotide) of the planted introns
MOTIFS = (((2, 3), (0, 2)), ((2, 1), (0, 2)), ((0, 3), (0, 1)),
          ((1, 3), (0, 1)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(41)
    n = 80000
    g = rng.integers(0, 4, n).astype(np.uint8)
    introns = []
    s = 2000
    while s < n - 30000:
        ln = int(rng.choice([60, 300, 2000, 9000, 20000]))
        (d0, d1), (a0, a1) = MOTIFS[len(introns) % len(MOTIFS)]
        g[s], g[s + 1], g[s + ln - 2], g[s + ln - 1] = d0, d1, a0, a1
        introns.append((s, ln))
        s += int(rng.integers(900, 1500))
    words = np.zeros((n + 15) // 16, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     g.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    words = np.concatenate([words, np.zeros((-len(words)) % 128,
                                            np.uint32)])
    return rng, g, n, words, introns


def _lanes(world, N, C):
    """Reads and candidate diagonals: exon structures by lane % 6."""
    rng, g, n, words, introns = world
    reads = np.zeros((N, L), np.int32)
    starts = np.zeros((N, C), np.int32)
    valid = np.ones((N, C), bool)
    for i in range(N):
        k = i % 6
        s0, ln0 = introns[int(rng.integers(0, len(introns) - 1))]
        x1 = int(rng.integers(6, L - 20))
        if k in (0, 1, 2):          # one junction, exon split at x1
            s = s0 - x1
            r = np.concatenate([g[s:s0], g[s0 + ln0:s0 + ln0 + L - x1]])
            diags = [s, s + ln0]
        elif k == 3:                # two junctions through a short exon
            s1, ln1 = s0 + ln0 + 30, 0
            for t, (a, b) in enumerate(introns):
                if a > s0 + ln0 + 25:
                    s1, ln1 = a, b
                    break
            mid = s1 - (s0 + ln0)
            x1 = int(rng.integers(8, max(9, L - mid - 8)))
            s = s0 - x1
            r = np.concatenate([g[s:s0], g[s0 + ln0:s1],
                                g[s1 + ln1:s1 + ln1 + L]])[:L]
            diags = [s, s + ln0, s + ln0 + ln1]
        elif k == 4:                # a deletion or insertion
            s = int(rng.integers(100, n - 200))
            if i % 12 == 4:
                r = np.concatenate([g[s:s + x1], g[s + x1 + 3:s + L + 3]])
                diags = [s, s + 3]
            else:
                r = np.concatenate([g[s:s + x1], [1, 2], g[s + x1:s + L]])
                diags = [s, s - 2]
        else:                       # unspliced
            s = int(rng.integers(100, n - 200))
            r = g[s:s + L].copy()
            diags = [s]
        r = np.asarray(r[:L], np.int32).copy()
        if i % 4 == 1:
            for q in rng.choice(L, 2, replace=False):
                r[q] = (r[q] + 1) % 4
        if i % 9 == 2:
            r[int(rng.integers(0, L))] = 4
        reads[i] = r
        row = list(diags) + [diags[0] + int(rng.integers(-3, 4)),
                             diags[0] + 40000, diags[0] - 250,
                             int(rng.integers(0, n))]
        starts[i] = (row * C)[:C]
        valid[i, C - 1] = i % 5 != 0
    lens = np.full(N, L, np.int32)
    lens[::7] = L - 9
    for i in range(0, N, 7):
        reads[i, lens[i]:] = 4
    quals = rng.integers(5, 41, (N, L)).astype(np.int32)
    minsc = (-0.2 * lens).astype(np.int32)
    rdids = rng.integers(0, 3 * N, N).astype(np.int32)
    return reads, quals, lens, starts, valid, minsc, rdids


def _planes(world, reads, quals, lens, starts, valid):
    """The JAX windows and penalty planes (one jit: the op-by-op first
    run of these JAX functions costs tens of seconds on the CPU)."""
    _, _, n, words, _ = world
    mstart = np.where(valid, starts, -1).astype(np.int32)
    mm_pen = np.array([2 + min(q, 40) * 4 // 40 for q in range(64)],
                      np.int32)

    @jax.jit
    def f(words, reads, quals, lens, mstart, mm_pen):
        ch = j_splice.diag_chars(words, n, mstart, L, M)
        return ch, j_extend.pen_planes(words, n, reads, quals, lens, mstart,
                                       mm_pen, 1, win_chars=ch,
                                       win_margin=M)

    ch, pl = f(*(jnp.asarray(a) for a in (words, reads, quals, lens, mstart,
                                          mm_pen)))
    return ch, pl, mm_pen


def _site_tables(world, rdid_max, lob: bool):
    """The planted introns' sites as SpliceSiteDB.device_tables lays them
    out: half from file (rdid -1), half temp sites."""
    rng, _, n, _, introns = world
    kd = np.array([s - 1 for s, _ in introns], np.int64)
    ka = np.array([s + ln for s, ln in introns], np.int64)
    rd = np.where(np.arange(len(kd)) % 2 == 0, -1,
                  rng.integers(0, rdid_max, len(kd)))
    nn = len(kd)
    cap = 64
    while cap < nn + 1:
        cap *= 2
    o, o2 = np.lexsort((ka, kd)), np.lexsort((kd, ka))
    t = {}
    for nm, v, f in (("ss_kd", kd[o], SENT), ("ss_ka", ka[o], SENT),
                     ("ss_rdid", rd[o], -1), ("ss_ka_s", ka[o2], SENT),
                     ("ss_kd_s", kd[o2], SENT), ("ss_rdid_a", rd[o2], -1)):
        a = np.full(cap, f, np.int32)
        a[:nn] = v
        t[nm] = a
    if lob:
        shift = max(0, (n - 1).bit_length() - (1 << 19).bit_length() + 1)
        edges = np.arange((1 << 19) + 1, dtype=np.int64) << shift
        t["ss_kd_lob"] = np.searchsorted(t["ss_kd"][:nn], edges).astype(
            np.int32)
        t["ss_ka_lob"] = np.searchsorted(t["ss_ka_s"][:nn], edges).astype(
            np.int32)
        t["ss_shift"] = shift
    jt = {k: (jnp.asarray(v) if k != "ss_shift" else jnp.int32(v))
          for k, v in t.items()}
    tt = {k: (_t(v) if k != "ss_shift" else int(v)) for k, v in t.items()}
    return jt, tt


@pytest.fixture(scope="module")
def sweep(world):
    """One batch of 60 lanes over C = 6 candidates, swept by JAX."""
    N, C = 60, 6
    reads, quals, lens, starts, valid, minsc, rdids = _lanes(world, N, C)
    ch, pl, mm_pen = _planes(world, reads, quals, lens, starts, valid)
    prm = j_splice.SpliceParams()
    tables = tuple(jnp.asarray(t) for t in j_splice.junction_prob_tables())
    res = jax.jit(lambda *a: j_splice.pair_sweep(*a, tables, prm,
                                                 max_gap=5))(
        ch, pl.pen_raw, pl.pen, pl.mm_raw, jnp.asarray(starts),
        jnp.asarray(valid), jnp.asarray(lens), jnp.asarray(minsc))
    return dict(reads=reads, quals=quals, lens=lens, starts=starts,
                valid=valid, minsc=minsc, rdids=rdids, ch=ch, pl=pl,
                mm_pen=mm_pen, res=res, tables=tables, prm=prm)


def _tprm():
    return splice.SpliceParams()


def test_pair_sweep_plain_matches_jax(world, sweep):
    """K13's plain twin on the JAX planes, and through its own planes from
    the windows (pair_sweep_ref), against splice.py:300."""
    S = sweep
    lp = splice.lenpen_device(_tprm(), "cpu")
    got = splice.pair_sweep_plain(
        _t(S["ch"]), _t(S["pl"].pen_raw), _t(S["pl"].pen),
        _t(S["pl"].mm_raw), _t(S["starts"]), _t(S["valid"]), _t(S["lens"]),
        _t(S["minsc"]), _tprm(), lp[0][0], lp[0][1], max_gap=5, chunk=16)
    res = S["res"]
    for f in ("score", "x", "kind", "spldir", "splscore", "raw"):
        _eq(got[f], getattr(res, f), f)
    ref, _, _ = splice.pair_sweep_ref(
        _t(S["ch"]), _t(S["reads"]), _t(S["quals"]), _t(S["lens"]),
        _t(S["starts"]), _t(S["valid"]), _t(S["minsc"]), _t(S["mm_pen"]),
        1, world[2], _tprm(), lp, 5, M)
    for f in got:
        _eq(ref[f], got[f], f + " (ref)")
    score = np.asarray(res.score)
    kind = np.asarray(res.kind)
    assert ((score > -2 ** 29) & (kind == 1)).sum() >= 10     # splices
    assert ((score > -2 ** 29) & (kind >= 2)).sum() >= 3      # indels
    assert (np.asarray(res.spldir) >= 3).any()                # semi-canonical


def test_select_pairs_and_base_pairs_match_jax(sweep):
    """K14 (top 4 by score, ties to the lower flat index) and the two raw
    base pairs of pipeline.py:1389-1396."""
    S = sweep
    res = S["res"]
    tres = {f: _t(getattr(res, f)) for f in res._fields}
    want = j_splice.select_pairs(res, jnp.asarray(S["starts"]), top=4)
    got = splice.select_pairs_plain(tres, _t(S["starts"]), 4)
    for f in want:
        _eq(got[f], want[f], f)
    C = S["starts"].shape[1]
    rawf = np.asarray(res.raw).reshape(len(S["lens"]), C * C)
    b0 = rawf.argmax(1)
    rawf = rawf.copy()
    rawf[np.arange(len(b0)), b0] = -(2 ** 30)
    bsel = splice.raw_base_pairs(tres["raw"])
    _eq(bsel[:, 0], b0, "q2 base pair")
    _eq(bsel[:, 1], rawf.argmax(1), "r2 base pair")


@pytest.mark.parametrize("sites", ["none", "sorted", "lob"])
def test_second_sweep_plain_matches_jax(world, sweep, sites):
    """K15, both sides, off the raw-argmax base pairs: without site tables,
    with them (binary search) and with the bucket index."""
    S = sweep
    N, C = S["starts"].shape
    res = S["res"]
    rawf = np.asarray(res.raw).reshape(N, C * C)
    bs = rawf.argmax(1)
    gp = lambda a: np.take_along_axis(  # noqa: E731
        np.asarray(a).reshape(N, -1), bs[:, None], 1)[:, 0]
    b_i, b_j = (bs // C).astype(np.int32), (bs % C).astype(np.int32)
    b_score, b_x, b_kind = gp(res.raw), gp(res.x), gp(res.kind)
    b_ok = (b_score > -2 ** 29) & (b_kind != 0)
    jss = tss = None
    if sites != "none":
        jss, tss = _site_tables(world, 3 * N, sites == "lob")
    want = jax.jit(lambda ch, pr, mr, st, va, ln, ms, bi, bj, bx, bsc, bok,
                   ss, rd: j_splice.second_sweep(
                       ch, pr, mr, st, va, ln, ms, S["tables"], S["prm"],
                       bi, bj, bx, bsc, bok, ss=ss, rdids=rd))(
        S["ch"], S["pl"].pen_raw, S["pl"].mm_raw,
        *(jnp.asarray(a) for a in (S["starts"], S["valid"], S["lens"],
                                   S["minsc"], b_i, b_j, b_x, b_score,
                                   b_ok)), jss, jnp.asarray(S["rdids"]))
    lp = splice.lenpen_device(_tprm(), "cpu")
    got = splice.second_sweep_ref(
        _t(S["ch"]), _t(S["reads"]), _t(S["quals"]), _t(S["lens"]),
        _t(S["starts"]), _t(S["valid"]), _t(S["minsc"]), _t(S["mm_pen"]), 1,
        world[2], _tprm(), lp, M, _t(b_i), _t(b_j), _t(b_x), _t(b_score),
        _t(b_ok), tss, _t(S["rdids"]))
    for side in ("right", "left"):
        for f in want[side]:
            _eq(got[side][f], want[side][f], f"{side} {f}")
    assert sum(int((np.asarray(want[s]["uscore"]) > -2 ** 29).sum())
               for s in want) >= 3


@pytest.mark.parametrize("C,lob", [(6, False), (6, True), (14, False),
                                   (14, True)])
def test_inject_known_plain_matches_jax(world, C, lob):
    """K16 at the lite (C = 6) and full (C = 14) widths, with and without
    the bucket index, with inherited clips."""
    N = 48
    reads, quals, lens, starts, valid, minsc, rdids = _lanes(world, N, C)
    ch, pl, mm_pen = _planes(world, reads, quals, lens, starts, valid)
    jss, tss = _site_tables(world, 3 * N, lob)
    rng = np.random.default_rng(C)
    clip_l = np.where(rng.random((N, C)) < 0.3,
                      rng.integers(1, 6, (N, C)), 0).astype(np.int32)
    clip_r = np.where(rng.random((N, C)) < 0.3,
                      rng.integers(1, 6, (N, C)), 0).astype(np.int32)
    clip_pen = np.array([1 + min(q, 40) // 20 for q in range(64)], np.int32)
    zero3 = jnp.zeros((N, C, 1), jnp.int32)
    al3 = jnp.broadcast_to(jnp.asarray(lens)[:, None, None], (N, C, 1))
    Pm = jnp.concatenate([zero3, jnp.cumsum(pl.mm_raw.astype(jnp.int32),
                                            axis=2)], axis=2)
    P_fg = jnp.concatenate([zero3, jnp.cumsum(pl.pen, axis=2)], axis=2)
    take = lambda P: jnp.take_along_axis(P, al3, axis=2)[:, :, 0]  # noqa
    _, _, n, words, _ = world

    @jax.jit        # one compile instead of an op-by-op first run
    def jax_inject(words, reads, quals, lens, rdids, starts, valid, P_fg,
                   Pm, ss, mm_pen, minsc, clip_l, clip_r, clip_pen):
        return j_splice.inject_known(
            words, n, reads, quals, lens, rdids, starts, valid, P_fg,
            take(P_fg), Pm, take(Pm), ss["ss_kd"], ss["ss_ka"],
            ss["ss_rdid"], ss["ss_ka_s"], ss["ss_kd_s"], ss["ss_rdid_a"],
            mm_pen, 1, minsc, slots=2, src_clip_l=clip_l,
            src_clip_r=clip_r, clip_pen=clip_pen,
            snv_delta1=jnp.zeros(1, jnp.uint32),
            snv_delta2=jnp.zeros(1, jnp.uint32), kd_lob=ss.get("ss_kd_lob"),
            ka_lob=ss.get("ss_ka_lob"), ss_shift=ss.get("ss_shift"))

    want = jax_inject(*(jnp.asarray(a) for a in (
        words, reads, quals, lens, rdids, starts, valid)), P_fg, Pm, jss,
        *(jnp.asarray(a) for a in (mm_pen, minsc, clip_l, clip_r,
                                   clip_pen)))
    got = splice.inject_known_ref(
        u32_to_tensor(words, "cpu"), n, _t(reads), _t(quals), _t(lens),
        _t(rdids), _t(starts), _t(valid), _t(ch), M, tss, _t(mm_pen), 1,
        _t(minsc), 2, _t(clip_l), _t(clip_r), _t(clip_pen))
    for f in want:
        _eq(got[f], want[f], f)
    ok = np.asarray(want["score"]) > -2 ** 29
    assert ok.sum() >= 5
    assert (np.asarray(want["clip_l"])[ok] > 0).any() \
        or (np.asarray(want["clip_r"])[ok] > 0).any()
