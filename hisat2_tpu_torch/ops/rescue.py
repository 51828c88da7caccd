"""Mate rescue: the anchored window search for the unaligned mate of a pair
(counterpart of hisat2_tpu/ops/rescue.py: rescue_candidates :25).

Each rescue job matches its mate against every diagonal of a window of W
diagonals and keeps the 8 best (`rescue_window`, K12), then rescores those
8 exactly with the reference windows (ops/splice.py:diag_chars_multi, K5,
one launch for the reference and, on a graph index, the SNV planes) and
the ungapped extension (ops/extend.py:extend_grouped, K6+K7), with the SNV
planes on a graph index.

`rescue_window` launches K12 (csrc/rescue_window.cu) on CUDA tensors and
runs `rescue_window_plain` on CPU tensors.  The plain version keeps the
two behaviours of the JAX one-hot convolution and lax.top_k that the
ranking depends on: each match count is rounded to bfloat16 (exact up to
256, so only mates longer than 256 bp see it), and ties go to the lower
diagonal.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import extend as extend_ops
from . import rank as rk
from . import splice as splice_ops

TOP = 8     # must exceed the reference's nelt cap of 5 (hi_aligner.h:4760)
# K12's diagonals a unit (csrc/rescue_window.cu:RW_UNIT): a job's window
# is ceil(W / UNIT) units, and its blocks' top-8 lists (a block a few
# units) meet in a scratch of at most that many lists
UNIT = 896
# per device: K12's tickets, one a job, zero between launches (the job's
# last block resets its own)
_TICKETS = {}


def rescue_window_plain(ref_words, n_text: int, reads, win_start, W: int):
    """The TOP best diagonals of each job's window (rescue.py:39-59):
    int32 [R, TOP] joined starts, best first.  reads: int32 [R, L] in the
    expected orientation (code 4 matches nothing); win_start: int32 [R]."""
    R, L = reads.shape
    refc = rk.ref_chars_block(ref_words, n_text, win_start, W + L - 1)
    cnt = torch.zeros((R, W), dtype=torch.int32, device=reads.device)
    for t in range(L):
        rt = reads[:, t:t + 1]
        cnt += ((refc[:, t:t + W] == rt) & (rt < 4)).to(torch.int32)
    # the bf16 convolution output, then lax.top_k's order: count
    # descending, ties to the lower diagonal (unique keys)
    rounded = cnt.to(torch.float32).to(torch.bfloat16).to(torch.int64)
    d = torch.arange(W, device=reads.device, dtype=torch.int64)
    key = rounded * (1 << 32) + (W - 1 - d)[None, :]
    didx = torch.topk(key, TOP, dim=1).indices
    return (win_start[:, None].to(torch.int64) + didx).to(torch.int32)


def _tickets(R: int, dev):
    """K12's zeroed tickets for R jobs on dev, kept across calls (the
    kernel leaves them zero); launches on one stream share them."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < R:
        t = torch.zeros(max(R, 128), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def rescue_window(ref_words, n_text: int, reads, win_start, W: int):
    """K12 on CUDA tensors, rescue_window_plain on CPU tensors."""
    if not reads.is_cuda:
        return rescue_window_plain(ref_words, n_text, reads, win_start, W)
    i32 = torch.int32
    R, L = reads.shape
    kernels.check_cuda("ref_words", ref_words, i32)
    kernels.check_cuda("reads", reads, i32, (R, L))
    kernels.check_cuda("win_start", win_start, i32, (R,))
    if W < TOP:
        raise ValueError(f"rescue_window: the window must be at least {TOP} "
                         f"wide")
    dev = reads.device
    out = torch.empty((R, TOP), dtype=i32, device=dev)
    part = torch.empty((R, -(-W // UNIT), TOP), dtype=torch.int64,
                       device=dev)
    kernels.KERNELS["rescue_window"].launch(
        ref_words.data_ptr(), ref_words.shape[0], n_text, reads.data_ptr(),
        win_start.data_ptr(), R, L, W, out.data_ptr(),
        _tickets(R, dev).data_ptr(), part.data_ptr(),
        part.numel() * part.element_size(), stream=kernels.stream_of(reads))
    return out


def rescue_candidates(ref_words, n_text: int, reads, quals, lens,
                      win_start, W: int, mm_pen, clip_pen, n_pen: int,
                      allow_softclip: bool = True, snv_delta1=None,
                      snv_delta2=None):
    """reads/quals: int32 [R, L], mate codes already in the expected
    orientation; lens: int32 [R]; win_start: int32 [R], the joined start
    of each job's window of W diagonals.  Returns (starts [R, TOP],
    ExtendResult) for the best-matching diagonals, as rescue.py:25 does.
    The windows of the rescoring have no margin (the extension reads
    columns 0..L-1 of them)."""
    L = reads.shape[1]
    starts = rescue_window(ref_words, n_text, reads, win_start, W)
    planes = [ref_words] + ([snv_delta1, snv_delta2]
                            if snv_delta1 is not None else [])
    ch, s1, s2 = (splice_ops.diag_chars_multi(planes, n_text, [starts], [0],
                                              L)[0] + [None, None])[:3]
    ext = extend_ops.extend_grouped(
        n_text, reads, quals, lens, starts, mm_pen, clip_pen, n_pen, ch, 0,
        allow_softclip=allow_softclip, uniform_len=False, minsc=None,
        snv1_win=s1, snv2_win=s2)
    return starts, ext
