"""SA resolution (counterpart of hisat2_tpu/ops/resolve.py).

Only the full-SA branch of resolve_consecutive (:174-186) is ported.  On
the card it is fused into kernel 5 (csrc/compact_cands.cu, K3+K4); this
plain version serves ops/compact.py:compact_candidates_plain, the
kernel's twin.
"""

from __future__ import annotations

import torch


def resolve_consecutive(sa, off_rate: int, top, P: int):
    """SA values of the consecutive rows top..top+P-1: [..., P] int32.

    sa: the device SA (padded to a multiple of 8 entries).  Rows past the
    padded end read the last 8-entry row, exactly like the JAX row gather
    with clipped row indices."""
    if off_rate != 0:
        raise NotImplementedError(
            "sampled-SA resolution (resolve_rows / resolve_rows_sparse) is "
            "not ported yet: ROADMAP.md Queue 1 item 6")
    ns = sa.shape[0]
    if ns % 8:
        raise ValueError("the full SA must be padded to a multiple of 8")
    nr = ns // 8
    t = torch.clamp(top.to(torch.int64), max=ns - 1)
    j = torch.arange(P, device=top.device)
    off = (t & 7)[..., None] + j                      # within-row offsets
    row = torch.clamp((t >> 3)[..., None] + (off >> 3), 0, nr - 1)
    return sa[row * 8 + (off & 7)]
