"""Port parity: the bigram FM search (kernel 1's plain twin) against
hisat2_tpu.ops.search.partial_search2, bit for bit on the CPU.

Same inputs from a seeded numpy generator go through both; every
PartialHits field must be equal (integers: exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.ops import search as jsearch
from hisat2_tpu_torch.index.format import to_device
from hisat2_tpu_torch.ops import search as tsearch


MOTIF_AT = [10000 * k for k in range(1, 6)]


@pytest.fixture(scope="module")
def idx120():
    """120 kbp random genome with one 17-mer planted 5 times: a read
    ending in it keeps >= 4 rows at 17 chars (the anchor-stop disarm
    threshold min_k + 8 with min_k = 9) and narrows right after."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 120000).astype(np.int8)
    motif = rng.integers(0, 4, 17).astype(np.int8)
    for at in MOTIF_AT:
        g[at:at + 17] = motif
    idx = build_fm_index([("c", g)])
    return idx, g, to_device(idx, "cpu")


def _reads(rng, g, B, L, var_lens):
    reads = np.zeros((B, L), np.int32)
    lens = np.full(B, L, np.int32)
    for i in range(B):
        o = int(rng.integers(0, len(g) - L))
        r = g[o:o + L].astype(np.int32)
        if i % 2:
            r = np.where(r < 4, 3 - r, r)[::-1].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, L))
            r[p] = (r[p] + 1 + int(rng.integers(3))) % 4
        if i % 7 == 0:
            r[int(rng.integers(0, L))] = 4
        if var_lens and i % 5 == 0:
            lens[i] = L - int(rng.integers(1, 30))
            r[lens[i]:] = 4
        reads[i] = r
    return reads, lens


@pytest.mark.parametrize("L,anchor_stop,var_lens", [
    (100, True, True), (101, True, True), (75, False, True),
    (100, True, False)])
def test_partial_search2_plain_matches_jax(idx120, L, anchor_stop,
                                           var_lens):
    idx, g, tdev = idx120
    rng = np.random.default_rng(L * 7 + anchor_stop)
    B = 48
    reads, lens = _reads(rng, g, B, L, var_lens)
    for i, at in enumerate(MOTIF_AT):         # reads ending in the motif
        reads[40 + i] = g[at + 17 - L:at + 17]
        lens[40 + i] = L
    uniform = not var_lens
    m = idx.meta
    jdev = idx.to_device()
    a = jsearch.partial_search2(
        jdev.blocked, jdev.fchr, jdev.ftab2_top, m.zrow, m.zrow2, m.rows,
        jnp.asarray(reads), jnp.asarray(lens), 6, 16, 9, uniform=uniform,
        anchor_stop=anchor_stop)
    b = tsearch.partial_search2(
        tdev.blocked, tdev.fchr, tdev.ftab2_top, m.zrow, m.zrow2, m.rows,
        torch.from_numpy(reads), torch.from_numpy(lens), 6, 16, 9,
        uniform=uniform, anchor_stop=anchor_stop)
    for f in a._fields:
        x = np.asarray(getattr(a, f))
        y = getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    # the searches really exercised hits, restarts and anchor stops
    assert np.asarray(a.nh).sum() > B // 2
    if anchor_stop:
        assert np.asarray(a.stopped).any()


@pytest.mark.parametrize("anchor_stop", [True, False])
def test_partial_search2_plain_matches_jax_one_row_steps(anchor_stop):
    """Kernel 1's plain twin on a 3 kbp genome (24 blocks of 128 rows),
    where top and bot lie in one block on most steps (kernel 1 then
    fetches one fused row), against JAX: every PartialHits field equal."""
    rng = np.random.default_rng(3000 + anchor_stop)
    g = rng.integers(0, 4, 3000).astype(np.int8)
    idx = build_fm_index([("c", g)])
    tdev = to_device(idx, "cpu")
    B, L = 40, 100
    reads, lens = _reads(rng, g, B, L, True)
    m = idx.meta
    jdev = idx.to_device()
    a = jsearch.partial_search2(
        jdev.blocked, jdev.fchr, jdev.ftab2_top, m.zrow, m.zrow2, m.rows,
        jnp.asarray(reads), jnp.asarray(lens), 6, 16, 3,
        anchor_stop=anchor_stop)
    stats = {}
    b = tsearch.partial_search2_plain(
        tdev.blocked, tdev.fchr, tdev.ftab2_top, m.zrow, m.zrow2, m.rows,
        torch.from_numpy(reads), torch.from_numpy(lens), 6, 16, 3,
        anchor_stop=anchor_stop, stats=stats)
    for f in a._fields:
        x = np.asarray(getattr(a, f))
        y = getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert stats["one_row"] > stats["steps"] // 2
    assert np.asarray(a.nh).sum() > B // 2


def test_search_wrapper_needs_kernel_on_cuda_only(idx120):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    from hisat2_tpu_torch import kernels
    idx, g, tdev = idx120
    kernels.reset_counts()
    reads, lens = _reads(np.random.default_rng(1), g, 4, 50, False)
    m = idx.meta
    tsearch.partial_search2(tdev.blocked, tdev.fchr, tdev.ftab2_top, m.zrow,
                            m.zrow2, m.rows, torch.from_numpy(reads),
                            torch.from_numpy(lens), 4, 16, 9)
    assert kernels.counts()["fm_search2"] == 0
