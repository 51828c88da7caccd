"""Kernel 4's plain twin (ops/splice.py:self_indel_sweep_plain) against
hisat2_tpu.ops.splice.self_indel_sweep on the CPU where the int32 key
matters, and the dead-row invariant the kernel relies on.

- JAX packs each gap combo as ((min(pen, PCAP-1) * 64 + min(raw, 63)) * 64
  + cid) in int32.  From G = 17 on, cid reaches 64, and a saturated
  penalty with 63 raw mismatches wraps the key negative: JAX then emits a
  deletion or insertion row scoring +524288.  The twin mirrors the wrap.
- A candidate that is not valid gets the constant row (score -2^30,
  d1 = d2 = start, x = 0, kind 0, for the strict and the wide set): its
  output depends on `starts` alone, so the kernel writes it and skips the
  sweep.
Integer results: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align.scoring import Scoring
from hisat2_tpu.ops import splice as jsplice
from hisat2_tpu_torch.ops import splice as tsplice

FIELDS = ("score", "d1", "d2", "x", "kind")


def _both(ch, reads, quals, lens, starts, valid, minsc, max_gap,
          snv=None, gaps=(5, 3, 5, 3), n_pen=1, min_anchor=7):
    """(JAX's rows, the twin's rows) as numpy dicts."""
    rd_o, rd_e, rf_o, rf_e = gaps
    kw = dict(allow_spliced=False, rd_gap_open=rd_o, rd_gap_ext=rd_e,
              rf_gap_open=rf_o, rf_gap_ext=rf_e, min_anchor=min_anchor)
    mm_pen = Scoring().mm_pen_table()
    J, T = jnp.asarray, torch.from_numpy
    a = jsplice.self_indel_sweep(
        J(ch), J(reads), J(quals), J(lens), J(starts), J(valid), J(minsc),
        J(mm_pen), n_pen, jsplice.SpliceParams(**kw),
        *((J(snv[0]), J(snv[1])) if snv else (None, None)), max_gap=max_gap)
    b = tsplice.self_indel_sweep(
        T(ch), T(reads), T(quals), T(lens), T(starts), T(valid), T(minsc),
        T(mm_pen), n_pen, tsplice.SpliceParams(**kw), max_gap=max_gap,
        snv1_w=T(snv[0]) if snv else None,
        snv2_w=T(snv[1]) if snv else None)
    return ({k: np.asarray(v) for k, v in a.items()},
            {k: v.numpy() for k, v in b.items()})


def _assert_equal(a, b, what=""):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _wrap_case(G):
    """One lane, one candidate: a 300 bp read of A against a window of C
    with six N columns under read columns 100-105."""
    L = 300
    W = L + 2 * G
    ch = np.ones((1, 1, W), np.int32)
    ch[0, 0, G + 100:G + 106] = 4
    i32 = np.int32
    return (ch, np.zeros((1, L), i32), np.full((1, L), 40, i32),
            np.array([L], i32), np.zeros((1, 1), i32), np.ones((1, 1), bool),
            np.array([-60], i32), G)


@pytest.mark.parametrize("G", [16, 18])
def test_wrapped_key_matches_jax(G):
    """G = 18: JAX's key wraps and it emits a deletion scoring +524288 at
    x = 7; the twin gives the same row.  G = 16: cid stays below 64, the
    key cannot wrap, and neither emits a row."""
    a, b = _both(*_wrap_case(G))
    _assert_equal(a, b, f"G={G}")
    if G == 18:
        assert [int(a[f][0, 0]) for f in FIELDS] == [524288, -1, 0, 7, 2]
        assert int(a["w_score"][0, 0]) == 524288
        assert int(a["w_x"][0, 0]) == 1
    else:
        assert int(a["score"][0, 0]) == int(a["w_score"][0, 0]) == -2 ** 30


def _random_case(rng, N, C, L, G, live, n_frac=0.0, mm_frac=0.0, snv=False,
                 M=None):
    """Seeded windows (margin M, G by default) that hold the read with a
    planted gap of 1..G at a random split, dense mismatches and N runs at
    the given shares."""
    M = M or G
    W = L + 2 * M
    ch = rng.integers(0, 4, (N, C, W)).astype(np.int32)
    reads = rng.integers(0, 4, (N, L)).astype(np.int32)
    lens = np.full(N, L, np.int32)
    lens[::3] = L - rng.integers(1, L // 4 + 1, len(lens[::3]))
    for n in range(N):
        reads[n, lens[n]:] = 4
        for c in range(C):
            g = int(rng.integers(1, G + 1))
            x = int(rng.integers(1, L - g))
            src = np.concatenate([reads[n, :x], rng.integers(0, 4, g),
                                  reads[n, x:]]) if c % 2 else np.concatenate(
                [reads[n, :x], reads[n, x + g:], rng.integers(0, 4, g)])
            ch[n, c, M:M + L] = np.where(src[:L] > 3, 0, src[:L])
    ch[rng.random(ch.shape) < mm_frac] = rng.integers(0, 4)
    runs = rng.random((N, C)) < n_frac
    for n, c in zip(*np.nonzero(runs)):
        a = int(rng.integers(0, W - 8))
        ch[n, c, a:a + int(rng.integers(4, 40))] = 4
    reads[rng.random(reads.shape) < 0.01] = 4
    quals = rng.integers(0, 42, (N, L)).astype(np.int32)
    starts = rng.integers(-5, 10 ** 6, (N, C)).astype(np.int32)
    valid = rng.random((N, C)) < live
    minsc = (-(rng.integers(0, 4 * L // 5, N))).astype(np.int32)
    snvw = None
    if snv:
        d = lambda: np.where(rng.random((N, C, W)) < 0.05,  # noqa: E731
                             rng.integers(1, 4, (N, C, W)), 0).astype(
                                 np.int32)
        snvw = (d(), d())
    return (ch, reads, quals, lens, starts, valid, minsc, G), snvw


@pytest.mark.parametrize("live", [0.0, 0.4, 1.0])
def test_dead_rows_are_constant(live):
    """Every dead candidate's row, in JAX and in the twin, is the constant
    row (-2^30, start, start, 0, 0) of both sets; with some candidates
    live the two also agree everywhere."""
    rng = np.random.default_rng(int(live * 10) + 5)
    args, snv = _random_case(rng, 6, 5, 60, 5, live, n_frac=0.3,
                             mm_frac=0.05, snv=live == 0.4)
    a, b = _both(*args, snv=snv)
    _assert_equal(a, b, f"live={live}")
    starts, valid = args[4], args[5]
    dead = ~valid
    for out in (a, b):
        for p in ("", "w_"):
            assert (out[p + "score"][dead] == -2 ** 30).all()
            assert (out[p + "d1"][dead] == starts[dead]).all()
            assert (out[p + "d2"][dead] == starts[dead]).all()
            assert (out[p + "x"][dead] == 0).all()
            assert (out[p + "kind"][dead] == 0).all()
    if live == 1.0:
        assert (a["kind"] != 0).any()


@pytest.mark.parametrize("case,G", [("all_n", 27), ("n_mm", 17),
                                    ("n_mm", 27), ("gap_costs", 27)])
def test_plain_matches_jax_at_key_extremes(case, G):
    """L = 512 with SNV windows of margin 27: windows full of N (100000 a
    column: every key saturates), N runs mixed with dense mismatches at
    G = 17 and 27 (wrapped keys, and cids that carry into the raw field),
    and raised gap costs: the twin equals JAX on every plane."""
    rng = np.random.default_rng(G + len(case))
    args, snv = _random_case(rng, 2, 3, 512, G, 0.8,
                             n_frac=0.2 if case == "gap_costs" else 0.8,
                             mm_frac=0.6 if case == "n_mm" else 0.0,
                             snv=True, M=27)
    if case == "all_n":
        args[0][:] = 4
    args[6][:] = -10 ** 6
    a, b = _both(*args, snv=snv,
                 gaps=(40, 25, 33, 17) if case == "gap_costs" else
                 (5, 3, 5, 3))
    _assert_equal(a, b, f"{case} G={G}")
