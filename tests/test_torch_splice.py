"""Port parity: diagonal windows (kernel 2's plain twin) and the
single-anchor indel sweep (kernel 4's plain twin) against
hisat2_tpu.ops.splice on the CPU, with planted insertions and deletions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align.scoring import Scoring
from hisat2_tpu.ops import splice as jsplice
from hisat2_tpu_torch.ops import splice as tsplice
from hisat2_tpu_torch.utils.intops import u32_to_tensor


def _setup(seed, B=36, L=80, C=5, n=5000):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    words = np.zeros((n + 15) // 16, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     g.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    words = np.concatenate([words, np.zeros((-len(words)) % 128, np.uint32)])
    reads = np.zeros((B, L), np.int32)
    lens = np.full(B, L, np.int32)
    true = rng.integers(40, n - L - 40, B)
    for i in range(B):
        t = int(true[i])
        p = int(rng.integers(8, L - 8))
        k = int(rng.integers(1, 6))
        if i % 3 == 0:      # deletion of k ref chars after read pos p
            r = np.concatenate([g[t:t + p], g[t + p + k:t + L + k]])
        elif i % 3 == 1:    # insertion of k chars at read pos p
            r = np.concatenate([g[t:t + p], rng.integers(0, 4, k),
                                g[t + p:t + L - k]])
        else:
            r = g[t:t + L].copy()
            r[int(rng.integers(0, L))] = 4
        r = r.astype(np.int32)
        if i % 4 == 3:
            lens[i] = L - int(rng.integers(1, 15))
            r[lens[i]:] = 4
        reads[i] = r[:L]
    quals = rng.integers(5, 41, (B, L)).astype(np.int32)
    st = np.stack([true, true + rng.integers(-6, 7, B),
                   rng.integers(-30, n + 30, B), np.full(B, -1),
                   np.full(B, n - L // 2)][:C], 1).astype(np.int32)
    valid = st >= 0
    valid[::5, 1] = False
    minsc = np.array([int(-0.2 * x) for x in lens], np.int32) - 6
    return g, words, reads, quals, lens, st, valid, minsc


@pytest.mark.parametrize("L,margin", [(80, 16), (101, 16), (60, 7)])
def test_diag_chars_plain_matches_jax(L, margin):
    g, words, *_ , st, _, _ = _setup(L, L=L)
    n = len(g)
    a = jsplice.diag_chars(jnp.asarray(words), n, jnp.asarray(st), L, margin)
    b = tsplice.diag_chars(u32_to_tensor(words, "cpu"), n,
                           torch.from_numpy(st), L, margin)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("L,margins,nplanes", [(37, (16, 0), 3),
                                                (101, (0,), 2)])
def test_diag_chars_multi_plain_matches_jax(L, margins, nplanes):
    """K5's plain twin of every plane and start set of one launch (W % 4
    != 0, and margin 0) against JAX's ref_chars_block per (set, plane)."""
    from hisat2_tpu.ops import rank as jrank
    g, words, *_, st, _, _ = _setup(L + 1, L=L)
    n = len(g)
    rng = np.random.default_rng(L)
    planes = [words] + [np.concatenate([
        w, np.zeros((-len(w)) % 128, np.uint32)]) for w in (
        rng.integers(0, 2 ** 32, (n + 15) // 16, dtype=np.uint64).astype(
            np.uint32) for _ in range(nplanes - 1))]
    sets = [st, np.concatenate([st[:, :2], st[:, :1] - L], 1)][:len(margins)]
    got = tsplice.diag_chars_multi(
        [u32_to_tensor(w, "cpu") for w in planes], n,
        [torch.from_numpy(np.ascontiguousarray(s)) for s in sets],
        list(margins), L)
    assert len(got) == len(margins)
    for s, m, row in zip(sets, margins, got):
        assert len(row) == nplanes and (L + 2 * m) % 4 != 0
        for w, b in zip(planes, row):
            a = jrank.ref_chars_block(jnp.asarray(w), n, jnp.asarray(s - m),
                                      L + 2 * m)
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed,max_gap,margin", [
    (1, 5, 16), (2, 10, 16), (3, 7, 7)])
def test_self_indel_sweep_plain_matches_jax(seed, max_gap, margin):
    g, words, reads, quals, lens, st, valid, minsc = _setup(seed)
    n, L = len(g), reads.shape[1]
    sc = Scoring()
    mm_pen = sc.mm_pen_table()
    prm_j = jsplice.SpliceParams(allow_spliced=False)
    prm_t = tsplice.SpliceParams(allow_spliced=False)
    chj = jsplice.diag_chars(jnp.asarray(words), n, jnp.asarray(st), L,
                             margin)
    a = jsplice.self_indel_sweep(
        chj, jnp.asarray(reads), jnp.asarray(quals), jnp.asarray(lens),
        jnp.asarray(st), jnp.asarray(valid), jnp.asarray(minsc),
        jnp.asarray(mm_pen), 1, prm_j, max_gap=max_gap)
    T = torch.from_numpy
    cht = tsplice.diag_chars(u32_to_tensor(words, "cpu"), n, T(st), L,
                             margin)
    b = tsplice.self_indel_sweep(cht, T(reads), T(quals), T(lens), T(st),
                                 T(valid), T(minsc), T(mm_pen), 1, prm_t,
                                 max_gap=max_gap)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), b[k].numpy()
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    kinds = b["kind"].numpy()
    assert (kinds == tsplice.KIND_DEL).any() and (kinds
                                                  == tsplice.KIND_INS).any()
