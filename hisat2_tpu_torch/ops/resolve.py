"""SA resolution (counterpart of hisat2_tpu/ops/resolve.py).

Full SA (off_rate 0): resolve_consecutive's row gather (:174-186).  On the
card it is fused into kernel 5 (csrc/compact_cands.cu, K3+K4); the plain
version serves ops/compact.py:compact_candidates_plain, the kernel's twin.

Sampled SA (off_rate > 0, genomes and shards of >= 128 Mbp): the LF walk of
resolve_rows (:29, K19) over the live rows only (resolve_rows_sparse,
:107, K20).  `resolve_rows_sparse` launches the resolve_walk kernel
(csrc/resolve_walk.cu, K19+K20) on CUDA tensors and runs
`resolve_rows_sparse_plain` on CPU tensors.  The walk reads one fused
49-column block row per step (index/format.py:fuse_blocked: occ, 8 BWT
words, the bigram planes, 4 mark words and the mark-rank checkpoint),
which gives the BWT char, the LF rank, the mark bit and the mark rank; it
ends at the first marked row, after at most 2^off_rate + 1 fetches, and
reads sa_marked[min(mark rank, len - 1)] + steps once.  A row the walk never
finds marked, and every dead row, reads 0.

The JAX sparse walk compacts the live rows (a stable argsort) and walks
them in chunks under a while_loop; the result does not depend on the
order of the rows, so the plain twin walks the live rows in one pass and
the kernel puts each block's live rows on a list and walks the list (a
thread per row without a mask).  The kernel takes the first row of each
run of P consecutive rows and adds the offsets itself, so the walk's
callers make no [M] row tensor.  Packed words are held as int64 in
[0, 2^32) and counted with SWAR, as in ops/rank.py.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils.intops import U32, as_u32, popcount32
from .rank import rank_from_rows

_I32 = torch.int32
FUSED_WIDTH = 49            # 44 rank columns + 4 mark words + checkpoint


def resolve_rows_plain(blocked, fchr, sa_marked, zrow: int, off_rate: int,
                       row):
    """Plain twin of K19 (resolve.py:29): joined offsets [M] int32 of the
    SA rows `row` (int32 [M]).  blocked: int32 u32 bits [nblk + 1, 49]."""
    ns = sa_marked.shape[0]
    if off_rate == 0:
        return sa_marked[row.to(torch.int64).clamp(max=ns - 1)]
    done, mr_hit, st_hit, _ = walk_plain(blocked, fchr, zrow, off_rate, row)
    val = sa_marked[mr_hit.clamp(max=ns - 1)].to(torch.int64) + st_hit
    return torch.where(done, val, 0).to(_I32)


def walk_plain(blocked, fchr, zrow: int, off_rate: int, row):
    """The LF walk of K19 from the SA rows `row` (int32 [M]): for each row
    whether it found a mark, the mark rank, the steps taken, and the row it
    ended on (the marked row; for a row that found none, the row after its
    last fetch) [M] int64."""
    if blocked.shape[1] != FUSED_WIDTH:
        raise ValueError("the sampled-SA walk needs the 49-column fused "
                         "block rows (index/format.py:to_device)")
    dv = row.device
    Wm = FUSED_WIDTH - 5
    nb = blocked.shape[0]
    r = row.to(torch.int64)
    M = r.shape[0]
    steps = torch.zeros(M, dtype=torch.int64, device=dv)
    done = torch.zeros(M, dtype=torch.bool, device=dv)
    mr_hit = torch.zeros_like(steps)
    st_hit = torch.zeros_like(steps)
    w4 = torch.arange(4, device=dv)[None, :]
    fc = fchr.to(torch.int64)
    for _ in range((1 << off_rate) + 1):
        blk = r >> 7
        within = r & 127
        brow = as_u32(blocked[blk.clamp(max=nb - 1)])          # [M, 49]
        mw = brow[:, Wm:Wm + 4]
        chk = brow[:, Wm + 4]
        mword = mw.gather(1, ((r >> 5) & 3)[:, None])[:, 0]
        marked = ((mword >> (r & 31)) & 1) != 0
        nv_m = (within[:, None] - 32 * w4).clamp(0, 32)
        msk_m = torch.where(nv_m >= 32, torch.full_like(nv_m, U32),
                            (1 << nv_m.clamp(max=31)) - 1)
        mrank = chk + popcount32(mw & msk_m).sum(dim=1)
        m = marked & ~done
        mr_hit = torch.where(m, mrank, mr_hit)
        st_hit = torch.where(m, steps, st_hit)
        done = done | m
        word = brow[:, 4:12].gather(1, ((r >> 4) & 7)[:, None])[:, 0]
        c = (word >> (2 * (r & 15))) & 3
        r2 = fc[c] + rank_from_rows(brow, r, c, zrow)
        r = torch.where(done, r, r2)
        steps = steps + (~done).to(torch.int64)
    return done, mr_hit, st_hit, r


def resolve_rows_sparse_plain(blocked, fchr, sa_marked, zrow: int,
                              off_rate: int, row, live=None, P: int = 1):
    """Plain twin of K20 (resolve.py:107): K19 over the live rows only,
    0 for dead rows (live None: every row, as K19).  With P > 1, `row`
    holds the first of each run of P consecutive rows (walk_args)."""
    if P != 1:
        row = (row.to(torch.int64)[:, None]
               + torch.arange(P, device=row.device)).to(_I32).reshape(-1)
    if live is None:
        return resolve_rows_plain(blocked, fchr, sa_marked, zrow, off_rate,
                                  row)
    out = torch.zeros(row.shape, dtype=_I32, device=row.device)
    out[live] = resolve_rows_plain(blocked, fchr, sa_marked, zrow, off_rate,
                                   row[live])
    return out


def resolve_rows_sparse(blocked, fchr, sa_marked, zrow: int, off_rate: int,
                        row, live=None, P: int = 1):
    """The resolve_walk kernel (K19+K20) on CUDA tensors,
    resolve_rows_sparse_plain on CPU tensors.  row: int32 [M / P], the
    first of each run of P consecutive SA rows (the rows themselves at P
    = 1); live: bool [M] or None (every row).  Returns int32 [M]."""
    if not row.is_cuda:
        return resolve_rows_sparse_plain(blocked, fchr, sa_marked, zrow,
                                         off_rate, row, live, P)
    if not 0 < off_rate <= 16:
        raise ValueError("resolve_walk: off_rate must be in 1..16")
    if P < 1:
        raise ValueError("resolve_walk: P must be >= 1")
    M = row.shape[0] * P
    kernels.check_cuda("blocked", blocked, _I32)
    if blocked.dim() != 2 or blocked.shape[1] != FUSED_WIDTH:
        raise ValueError("resolve_walk: blocked must be [nblk + 1, 49]")
    kernels.check_cuda("fchr", fchr, _I32, (5,))
    kernels.check_cuda("sa_marked", sa_marked, _I32)
    kernels.check_cuda("row", row, _I32, (M // P,))
    if live is not None:
        kernels.check_cuda("live", live, torch.bool, (M,))
    out = torch.empty(M, dtype=_I32, device=row.device)
    kernels.KERNELS["resolve_walk"].launch(
        blocked.data_ptr(), blocked.shape[0], fchr.data_ptr(),
        sa_marked.data_ptr(), sa_marked.shape[0], zrow, off_rate,
        row.data_ptr(), P, live.data_ptr() if live is not None else None, M,
        out.data_ptr(), stream=kernels.stream_of(row))
    return out


def walk_args(sa_marked, off_rate: int, top, P: int, live, blocked, fchr,
              zrow: int) -> dict:
    """resolve_rows_sparse's arguments for the rows top..top+P-1 of a
    sampled SA (resolve_consecutive's sampled branch, resolve.py:187-195):
    the first rows `top` flattened to int32 [top.numel()] with P (the
    kernel adds the offsets, the plain twin expands them), `live` [..., P]
    (or None) flattened."""
    return dict(blocked=blocked, fchr=fchr, sa_marked=sa_marked, zrow=zrow,
                off_rate=off_rate, row=top.to(_I32).reshape(-1).contiguous(),
                P=P,
                live=None if live is None else live.reshape(-1).contiguous())


def resolve_consecutive(sa, off_rate: int, top, P: int, live=None,
                        blocked=None, fchr=None, zrow: int = -1):
    """SA values of the consecutive rows top..top+P-1: [..., P] int32.

    Full SA (off_rate 0; sa padded to a multiple of 8 entries): rows past
    the padded end read the last 8-entry row, exactly like the JAX row
    gather with clipped row indices.  Sampled SA: sa is sa_marked, and the
    rows go through the walk (K19, or K20 when a `live` [..., P] mask is
    given: dead rows read 0), with the fused rows `blocked` and `fchr`."""
    if off_rate != 0:
        return resolve_rows_sparse(**walk_args(
            sa, off_rate, top, P, live, blocked, fchr, zrow)).reshape(
                *top.shape, P)
    j = torch.arange(P, device=top.device)
    ns = sa.shape[0]
    if ns % 8:
        raise ValueError("the full SA must be padded to a multiple of 8")
    nr = ns // 8
    t = torch.clamp(top.to(torch.int64), max=ns - 1)
    off = (t & 7)[..., None] + j                      # within-row offsets
    row = torch.clamp((t >> 3)[..., None] + (off >> 3), 0, nr - 1)
    return sa[row * 8 + (off & 7)]
