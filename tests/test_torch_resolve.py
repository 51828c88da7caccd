"""Port parity for the sampled-SA resolve walk (K19 + K20): the plain
twins of hisat2_tpu_torch/ops/resolve.py against hisat2_tpu.ops.resolve on
the CPU, and the sampled to_device layout against FMIndex.to_device.

- resolve_rows_plain against resolve_rows, resolve_rows_sparse_plain
  against resolve_rows_sparse at JAX chunk sizes 512, 1024 and M (the
  multi-chunk, two-chunk and dense branches), on a 20 kbp index built at
  off_rate 1, 2, 4 and 5, with live masks of 0%, 17% and 100%;
- resolve_consecutive's sampled branch (with and without a live mask)
  against JAX's;
- the 49-column fused block rows and the unpadded sa_marked of
  to_device against FMIndex.to_device's arrays.

Tolerance: exact (integer results).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.index.builder import build_fm_index, suffix_array
from hisat2_tpu.ops import resolve as j_resolve
from hisat2_tpu_torch.index.format import to_device
from hisat2_tpu_torch.ops import resolve

OFF_RATES = (1, 2, 4, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs in parallel
    workers, and torch's default of a thread per core oversubscribes the
    CPU (each small op then waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def indexes():
    seq = np.random.default_rng(777).integers(0, 4, 20000).astype(np.uint8)
    sa = suffix_array(seq)
    out = {}
    for orate in OFF_RATES:
        idx = build_fm_index([("chr_t", seq)], off_rate=orate)
        assert idx.meta.off_rate == orate
        out[orate] = (idx, idx.to_device(), to_device(idx, "cpu"))
    return sa, out


@pytest.mark.parametrize("off_rate", OFF_RATES)
def test_to_device_sampled_layout_matches_jax(indexes, off_rate):
    _, idxs = indexes
    idx, jd, td = idxs[off_rate]
    jb = np.asarray(jd.blocked)
    assert jb.shape[1] == 49 and tuple(td.blocked.shape) == jb.shape
    np.testing.assert_array_equal(td.blocked.numpy(), jb.view(np.int32))
    np.testing.assert_array_equal(td.sa.numpy(), np.asarray(jd.sa_marked))
    assert len(td.sa) == len(idx.sa_marked)          # unpadded
    np.testing.assert_array_equal(td.fchr.numpy(), np.asarray(jd.fchr))
    assert td.nbytes() == sum(t.numel() * t.element_size() for t in (
        td.blocked, td.fchr, td.ftab2_top, td.sa, td.ref_words))


def _jargs(jd, meta):
    return (jd.blocked, jd.fchr, jd.mark_words, jd.mark_chk, jd.sa_marked,
            meta.zrow, meta.off_rate)


def _targs(td, meta):
    return (td.blocked, td.fchr, td.sa, meta.zrow, meta.off_rate)


@pytest.mark.parametrize("off_rate", OFF_RATES)
def test_resolve_rows_matches_jax(indexes, off_rate):
    sa, idxs = indexes
    idx, jd, td = idxs[off_rate]
    r = np.random.default_rng(off_rate).integers(
        0, idx.meta.rows, 3000).astype(np.int32)
    want = np.asarray(j_resolve.resolve_rows(*_jargs(jd, idx.meta),
                                             jnp.asarray(r)))
    got = resolve.resolve_rows_plain(*_targs(td, idx.meta),
                                     torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sa[r])


@pytest.mark.parametrize("off_rate", OFF_RATES)
@pytest.mark.parametrize("density", (0.0, 0.17, 1.0))
def test_resolve_rows_sparse_matches_jax(indexes, off_rate, density):
    sa, idxs = indexes
    idx, jd, td = idxs[off_rate]
    M = 4096
    rng = np.random.default_rng(int(density * 100) + off_rate)
    r = rng.integers(0, idx.meta.rows, M).astype(np.int32)
    live = rng.random(M) < density
    got = resolve.resolve_rows_sparse(*_targs(td, idx.meta),
                                      torch.from_numpy(r),
                                      torch.from_numpy(live)).numpy()
    for chunk in (512, 1024, M):
        want = np.asarray(j_resolve.resolve_rows_sparse(
            *_jargs(jd, idx.meta), jnp.asarray(r), jnp.asarray(live),
            chunk=chunk))
        np.testing.assert_array_equal(got, want, err_msg=f"chunk {chunk}")
    np.testing.assert_array_equal(got[live], sa[r][live])
    assert not got[~live].any()


@pytest.mark.parametrize("with_live", (False, True))
def test_resolve_consecutive_sampled_matches_jax(indexes, with_live):
    _, idxs = indexes
    idx, jd, td = idxs[4]
    rng = np.random.default_rng(5)
    N, H, P = 64, 5, 10
    top = rng.integers(0, idx.meta.rows - P, (N, H)).astype(np.int32)
    live = rng.random((N, H, P)) < 0.3 if with_live else None
    want = np.asarray(j_resolve.resolve_consecutive(
        *_jargs(jd, idx.meta), jnp.asarray(top), P,
        live=None if live is None else jnp.asarray(live), chunk=1024))
    got = resolve.resolve_consecutive(
        td.sa, 4, torch.from_numpy(top), P,
        live=None if live is None else torch.from_numpy(live),
        blocked=td.blocked, fchr=td.fchr, zrow=idx.meta.zrow).numpy()
    np.testing.assert_array_equal(got, want)
