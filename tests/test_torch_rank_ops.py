"""Port parity: rank/LF primitives, reference-char gathers, full-SA
resolution and the small-axis compaction helpers of hisat2_tpu_torch
against hisat2_tpu on the CPU.  Integers throughout: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.index.format import fuse_blocked
from hisat2_tpu.ops import compact as jcompact
from hisat2_tpu.ops import rank as jrank
from hisat2_tpu.ops import resolve as jresolve
from hisat2_tpu_torch.index.format import to_device
from hisat2_tpu_torch.ops import compact as tcompact
from hisat2_tpu_torch.ops import rank as trank
from hisat2_tpu_torch.ops import resolve as tresolve
from hisat2_tpu_torch.utils import intops


@pytest.fixture(scope="module")
def idx30():
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 30000).astype(np.int8)
    idx = build_fm_index([("c", g)])
    return idx, to_device(idx, "cpu")


def test_intops_match_uint32_semantics():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    t = intops.u32_to_tensor(w, "cpu")
    u = intops.as_u32(t)
    np.testing.assert_array_equal(u.numpy(), w.astype(np.int64))
    pc = np.array([bin(int(x)).count("1") for x in w])
    np.testing.assert_array_equal(intops.popcount32(u).numpy(), pc)
    np.testing.assert_array_equal(intops.wrap_i32(u).numpy(),
                                  w.view(np.int32))
    x = rng.integers(-2 ** 20, 2 ** 20, (4, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        intops.cumsum_i32(torch.from_numpy(x), 1).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


def test_rank_from_rows_matches_jax(idx30):
    idx, tdev = idx30
    m = idx.meta
    blocked = fuse_blocked(idx.occ, idx.bwt_words, idx.occ2, idx.bwt2_words)
    rng = np.random.default_rng(3)
    i = np.concatenate([rng.integers(0, m.rows + 1, 400),
                        [0, m.zrow, m.zrow + 1, m.zrow2, m.zrow2 + 1,
                         m.rows, (m.zrow // 128) * 128]]).astype(np.int32)
    c = rng.integers(0, 4, len(i)).astype(np.int32)
    c[-7:] = 0
    sym = rng.integers(0, 16, len(i)).astype(np.int32)
    sym[-7:] = 0
    rows_j = jnp.asarray(blocked)[jnp.asarray(i) >> 7]
    rows_t = trank.gather_rows(tdev.blocked, torch.from_numpy(i).long())
    a = jrank.rank_from_rows(rows_j, jnp.asarray(i), jnp.asarray(c), m.zrow)
    b = trank.rank_from_rows(rows_t, torch.from_numpy(i).long(),
                             torch.from_numpy(c).long(), m.zrow)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    a2 = jrank.rank2_from_rows(rows_j, jnp.asarray(i), jnp.asarray(sym),
                               m.zrow, m.zrow2)
    b2 = trank.rank2_from_rows(rows_t, torch.from_numpy(i).long(),
                               torch.from_numpy(sym).long(), m.zrow, m.zrow2)
    np.testing.assert_array_equal(np.asarray(a2), b2.numpy())


@pytest.mark.parametrize("L", [100, 132, 57])
def test_ref_chars_block_matches_jax(L):
    """Negative and out-of-text starts, window margins, odd widths."""
    rng = np.random.default_rng(9)
    n = 128 * 16 * 5 + 5
    g = rng.integers(0, 4, n).astype(np.uint32)
    words = np.zeros(((n + 15) // 16), np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     g << (2 * (np.arange(n) % 16)))
    pad = np.concatenate([words, np.zeros((-len(words)) % 128, np.uint32)])
    starts = np.concatenate([rng.integers(-40, n + 40, 301),
                             [0, -1, -17, n - 1, n - L, 5, n]]
                            ).astype(np.int32).reshape(-1, 7)
    a = jrank.ref_chars_block(jnp.asarray(pad), n, jnp.asarray(starts), L)
    b = trank.ref_chars_block(intops.u32_to_tensor(pad, "cpu"), n,
                              torch.from_numpy(starts), L)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_resolve_consecutive_full_sa_matches_jax(idx30):
    idx, tdev = idx30
    jdev = idx.to_device()
    rng = np.random.default_rng(4)
    ns = tdev.sa.shape[0]
    top = np.concatenate([rng.integers(0, idx.meta.rows, 200),
                          [0, ns - 1, ns - 3, ns + 5]]).astype(np.int32)
    top = top.reshape(-1, 2)
    for P in (10, 5, 16):
        a = jresolve.resolve_consecutive(
            jdev.blocked, jdev.fchr, jdev.mark_words, jdev.mark_chk,
            jdev.sa_marked, idx.meta.zrow, 0, jnp.asarray(top), P)
        b = tresolve.resolve_consecutive(tdev.sa, 0, torch.from_numpy(top),
                                         P)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_resolve_sampled_sa_is_queued():
    """Named when the sampled-SA branch was queued (ROADMAP Queue 1 item
    6); it is ported now, so the branch is held against JAX's: the same
    genome at off_rate 4, rows past the end included, dense and with a
    live mask (tests/test_torch_resolve.py covers it in depth)."""
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 30000).astype(np.int8)
    idx = build_fm_index([("c", g)], off_rate=4)
    jdev, tdev = idx.to_device(), to_device(idx, "cpu")
    top = np.concatenate([rng.integers(0, idx.meta.rows, 200),
                          [0, idx.meta.rows - 1, idx.meta.rows - 3]])
    top = top.astype(np.int32).reshape(-1, 1)
    live = rng.random((top.shape[0], 1, 10)) < 0.5
    for lv in (None, live):
        a = jresolve.resolve_consecutive(
            jdev.blocked, jdev.fchr, jdev.mark_words, jdev.mark_chk,
            jdev.sa_marked, idx.meta.zrow, 4, jnp.asarray(top), 10,
            live=None if lv is None else jnp.asarray(lv))
        b = tresolve.resolve_consecutive(
            tdev.sa, 4, torch.from_numpy(top), 10,
            live=None if lv is None else torch.from_numpy(lv),
            blocked=tdev.blocked, fchr=tdev.fchr, zrow=idx.meta.zrow)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_compact_helpers_match_jax():
    rng = np.random.default_rng(5)
    B, J, M = 40, 23, 9
    v = rng.integers(-50, 50, (B, J)).astype(np.int32)
    vb = rng.random((B, J)) < 0.5
    idx = rng.integers(-3, J + 3, (B, M)).astype(np.int32)
    for vv in (v, vb):
        a = jcompact.take_cols(jnp.asarray(vv), jnp.asarray(idx))
        b = tcompact.take_cols(torch.from_numpy(vv), torch.from_numpy(idx))
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    v3 = rng.integers(-9, 9, (B, 4, J)).astype(np.int32)
    i3 = rng.integers(-2, J + 2, (B, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jcompact.take_last(jnp.asarray(v3), jnp.asarray(i3))),
        tcompact.take_last(torch.from_numpy(v3),
                           torch.from_numpy(i3)).numpy())
    key = rng.integers(0, 6, (B, J)).astype(np.int32)      # many ties
    np.testing.assert_array_equal(
        np.asarray(jcompact.stable_rank_asc(jnp.asarray(key))),
        tcompact.stable_rank_asc(torch.from_numpy(key)).numpy())
    rank = np.asarray(jcompact.stable_rank_asc(jnp.asarray(key)))
    sel = rank[:, None, :] == np.arange(M)[None, :, None]
    sel[::3] = False                                       # empty slots
    for vv, fill in ((v, 0), (v, 7), (vb, 0)):
        a = jcompact.select_ranked(jnp.asarray(sel), jnp.asarray(vv), fill)
        b = tcompact.select_ranked(torch.from_numpy(sel),
                                   torch.from_numpy(vv), fill)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
