"""Port parity at read lengths above the kernels' former caps (512 bp for
the FM search, 1024 for the extension, the indel sweep and the rescue
window), on the CPU against hisat2_tpu:

- the whole DNA step at L = 600 (one 600 bp read, the rest 100-300 bp)
  gives the packed buffer of TPUAligner's step;
- kernel 3's plain twin equals JAX's extend_grouped on batches shaped like
  the pipeline's (90% of slots dead at -1, live starts repeated within a
  lane), at L = 36 and 600, with and without SNV windows;
- in JAX's result, the slots of a lane with equal starts have equal rows:
  the property the kernel's one evaluation per (lane, start) rests on.

The card runs the same lengths through the kernels in
tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.align.scoring import Scoring
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.ops import extend as jext
from hisat2_tpu.ops import splice as jsplice
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.ops import extend as text
from hisat2_tpu_torch.ops import splice as tsplice
from hisat2_tpu_torch.utils.intops import u32_to_tensor

FIELDS = ("score", "n_mm", "n_n", "n_snp", "clip_l", "clip_r", "ok",
          "alt_score")


def _words(rng, n):
    g = rng.integers(0, 4, n).astype(np.uint8)
    words = np.zeros((n + 15) // 16, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     g.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    words = np.concatenate([words, np.zeros((-len(words)) % 128, np.uint32)])
    return g, words


def test_step_matches_jax_at_600bp():
    rng = np.random.default_rng(600)
    seq = rng.integers(0, 4, 200_000).astype(np.uint8)
    idx = build_fm_index([("chr_long", seq)])
    B, L = 16, 600
    lens = np.concatenate([[L], rng.integers(100, 301, B - 1)]).astype(
        np.int32)
    codes = np.full((B, L), 4, np.uint8)
    starts = rng.integers(0, len(seq) - L, B)
    for i in range(B):
        r = seq[starts[i]:starts[i] + lens[i]].copy()
        if i % 3 == 0:
            r[rng.integers(5, lens[i] - 5, 2)] ^= 1
        if i % 4 == 1:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        if i == 2:                  # a 3 bp deletion (the indel sweep)
            s = int(starts[i])
            r = np.concatenate([seq[s:s + 60], seq[s + 63:s + lens[i] + 3]])
        codes[i, :lens[i]] = r
    quals = rng.integers(2, 41, (B, L)).astype(np.uint8)
    ja = TPUAligner(idx)
    ta = TorchAligner(idx, device="cpu")
    minsc = np.array([ja.scoring.min_score(int(x)) for x in lens], np.int64)
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    jp = ja._dispatch_packed(rd, qd, np.arange(B), False, h2d)[0]
    tp = ta._dispatch_packed(codes, quals, lens, minsc, False)[0]
    w = np.asarray(jp).shape[1]
    assert ja._out_specs[w] == ta._out_specs[w]
    np.testing.assert_array_equal(np.asarray(jp), tp[0].numpy())
    out = ta._fetch_out(tp)
    assert (out["u_dd"] != 0).any()         # the indel sweep's row


def _pipeline_batch(rng, g, B, L, C):
    """Reads from g with mismatches, Ns, clipped ends and variable lengths;
    starts as the pipeline gives them: 90% of slots -1, each lane's live
    starts drawn from a few diagonals (repeats within the lane), some
    across the text ends; two rows with clip-gain ties."""
    n = len(g)
    reads = np.full((B, L), 4, np.int32)
    lens = np.full(B, L, np.int32)
    true = rng.integers(0, n - L, B)
    for i in range(B):
        r = g[true[i]:true[i] + L].astype(np.int32)
        for p in rng.integers(0, L, int(rng.integers(0, 2 + L // 40))):
            r[p] = (r[p] + 1) % 4
        if i % 4 == 1:
            r[:int(rng.integers(1, 12))] = rng.integers(0, 4)
        if i % 4 == 2:
            r[L - int(rng.integers(1, 12)):] = (r[-1] + 1) % 4
        if i % 5 == 0:
            r[int(rng.integers(0, L))] = 4
        if i % 3 == 0:
            lens[i] = L - int(rng.integers(1, 20))
            r[lens[i]:] = 4
        reads[i] = r
    quals = rng.integers(0, 42, (B, L)).astype(np.int32)
    quals[::2] = 40
    st = np.full((B, C), -1, np.int64)
    for i in range(B):
        diag = [true[i], true[i] + int(rng.integers(-3, 4)),
                int(rng.integers(-60, n + 60)), n - L // 3, -(L // 4)]
        for j in range(C):
            if rng.random() < 0.05:
                st[i, j] = diag[int(rng.integers(0, len(diag)))]
        if rng.random() < 0.2:      # a repeated live start
            st[i, int(rng.integers(0, C))] = st[i, int(rng.integers(0, C))] \
                = true[i]
    for i in (0, 1):                # clip-gain ties (test_torch_extend.py)
        t = int(true[i])
        reads[i] = g[t:t + L]
        lens[i] = L
        quals[i] = 40
        st[i, 0] = t
    reads[0, [0, 8, 9]] = (reads[0, [0, 8, 9]] + 1) % 4
    quals[0, 1:8], quals[0, 8], quals[0, 9] = 0, 30, 20
    reads[1, [L - 10, L - 9, L - 1]] = (reads[1, [L - 10, L - 9, L - 1]]
                                        + 1) % 4
    quals[1, 1:10], quals[1, L - 10], quals[1, L - 9] = 0, 30, 20
    minsc = np.array([int(-0.6 - 0.6 * x) for x in lens], np.int32)
    return reads, quals, lens, st.astype(np.int32), minsc


_JAX = {}


def _extend_pair(L, snv):
    """JAX's extend_grouped and the port's plain twin on one pipeline-shaped
    batch (cached per case): (starts, jax result, port result)."""
    if (L, snv) in _JAX:
        return _JAX[(L, snv)]
    rng = np.random.default_rng(L + 7 * snv)
    n, B, C, margin = 12_000, 24, 6, 16
    g, words = _words(rng, n)
    reads, quals, lens, st, minsc = _pipeline_batch(rng, g, B, L, C)
    sc = Scoring()
    mm_pen, clip_pen = sc.mm_pen_table(), sc.clip_pen_table()
    J = jnp.asarray
    win_j = jsplice.diag_chars(J(words), n, J(st), L, margin)
    kw_j, kw_t = {}, {}
    T = torch.from_numpy
    win_t = tsplice.diag_chars(u32_to_tensor(words, "cpu"), n, T(st), L,
                               margin)
    if snv:
        d1 = _words(rng, n)[1]
        d2 = _words(rng, n)[1]
        kw_j = dict(snv_delta1=J(d1), snv_delta2=J(d2),
                    snv1_win=jsplice.diag_chars(J(d1), n, J(st), L, margin),
                    snv2_win=jsplice.diag_chars(J(d2), n, J(st), L, margin))
        kw_t = dict(snv1_win=tsplice.diag_chars(u32_to_tensor(d1, "cpu"), n,
                                                T(st), L, margin),
                    snv2_win=tsplice.diag_chars(u32_to_tensor(d2, "cpu"), n,
                                                T(st), L, margin))
    pj = jext.pen_planes(J(words), n, J(reads), J(quals), J(lens), J(st),
                         J(mm_pen), 1, win_chars=win_j, win_margin=margin,
                         **kw_j)
    ej = jext.extend_grouped(J(words), n, J(reads), J(quals), J(lens),
                             J(st), J(mm_pen), J(clip_pen), 1, planes=pj,
                             minsc=J(minsc), mm_min=2)
    et = text.extend_grouped(n, T(reads), T(quals), T(lens), T(st),
                             T(mm_pen), T(clip_pen), 1, win_t, margin,
                             minsc=T(minsc), mm_min=2, **kw_t)
    _JAX[(L, snv)] = (st, {f: np.asarray(getattr(ej, f)) for f in FIELDS},
                      {f: getattr(et, f).numpy() for f in FIELDS})
    return _JAX[(L, snv)]


@pytest.mark.parametrize("L,snv", [(36, False), (36, True), (600, False),
                                   (600, True)])
def test_extend_plain_matches_jax_on_pipeline_batches(L, snv):
    st, want, got = _extend_pair(L, snv)
    for f in FIELDS:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)
    # the batch holds dead slots, clips and alternate scores
    assert (st < 0).mean() > 0.8
    assert (want["clip_l"] > 0).any() and (want["clip_r"] > 0).any()
    assert (want["alt_score"] > jext.NO_ALT).any()


@pytest.mark.parametrize("L,snv", [(36, True), (600, False)])
def test_equal_starts_give_equal_rows_in_jax(L, snv):
    st, want, _ = _extend_pair(L, snv)
    B, C = st.shape
    pairs = 0
    for i in range(B):
        for j in range(C):
            for k in range(j):
                if st[i, j] == st[i, k]:
                    pairs += 1
                    for f in FIELDS:
                        assert want[f][i, j] == want[f][i, k], (f, i, j, k)
    # dead slots and repeated live starts both occur
    live_rep = sum(len(set(r[r >= 0])) < (r >= 0).sum() for r in st)
    assert pairs > B and live_rep > 0
