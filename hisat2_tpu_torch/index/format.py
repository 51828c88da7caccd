"""The device-resident FM index (counterpart of hisat2_tpu/index/format.py
FMIndex.to_device, :129-169).

The on-disk format and the numpy FMIndex are reused as they are
(`FMIndex.load` has no JAX in it).  `to_device` builds the same fused
blocked table with the numpy `fuse_blocked` and keeps the same padding:
ref_words to a multiple of 128 words, the full suffix array to a multiple
of 8 entries.  Packed uint32 tables travel as int32 bit patterns (see
utils/intops.py).  Only what the device step reads is uploaded: the
blocked table, fchr, ftab2_top, the full suffix array and ref_words
(sampled-SA indexes, and so the mark planes, are not ported yet).  The
host keeps ftab_top/ftab_bot (align/hostfm.py) and the fragment tables.

`graph_to_device` uploads a graph index's variant tables (the graph-DNA
part of pipeline.py:378-402, for one shard): the two 2-bit SNV planes,
padded like ref_words, and the padded indel event tables of
hisat2_tpu/index/graph.py:indel_device_tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hisat2_tpu.index.format import FMIndex, FMMeta, ShardedFMIndex, fuse_blocked

from ..utils.intops import u32_to_tensor


@dataclasses.dataclass
class TorchFMIndex:
    meta: FMMeta
    blocked: torch.Tensor     # int32 [nblocks + 1, 44] u32 bits
    fchr: torch.Tensor        # int32 [5]
    ftab2_top: torch.Tensor   # int32 [16]
    sa: torch.Tensor          # int32 [rows padded to a multiple of 8]
    ref_words: torch.Tensor   # int32 [multiple of 128] u32 bits
    device: torch.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.blocked, self.fchr, self.ftab2_top, self.sa,
            self.ref_words))


def to_device(index: FMIndex, device) -> TorchFMIndex:
    """Upload a numpy FMIndex to `device` (a torch device or its name)."""
    if isinstance(index, ShardedFMIndex):
        raise NotImplementedError(
            "sharded (genome-scale) indexes are not ported yet: "
            "ROADMAP.md Queue 1 item 6")
    if index.meta.off_rate > 0:
        raise NotImplementedError(
            "sampled-SA indexes (genomes >= 128 Mbp) are not ported yet: "
            "ROADMAP.md Queue 1 item 6")
    if index.ftab2_top is None or index.occ2 is None:
        raise ValueError("index has no bigram planes; rebuild it with "
                         "`python -m hisat2_tpu_torch build`")
    device = torch.device(device)
    blocked = fuse_blocked(index.occ, index.bwt_words, index.occ2,
                           index.bwt2_words)
    rw = _pad128(index.ref_words)
    sa = np.asarray(index.sa_marked, np.int32)
    if len(sa) % 8:
        sa = np.concatenate([sa, np.zeros(8 - len(sa) % 8, np.int32)])

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return TorchFMIndex(
        meta=index.meta,
        blocked=u32_to_tensor(blocked, device),
        fchr=i32(index.fchr), ftab2_top=i32(index.ftab2_top), sa=i32(sa),
        ref_words=u32_to_tensor(rw, device), device=device)


def _pad128(words: np.ndarray) -> np.ndarray:
    w = np.asarray(words, np.uint32)
    if len(w) % 128:
        w = np.concatenate([w, np.zeros(128 - len(w) % 128, np.uint32)])
    return w


def graph_to_device(graph, has_indels: bool, device):
    """A GraphArrays (hisat2_tpu/index/graph.py:build_graph_arrays) on
    `device`: {"snv1", "snv2"} (int32 u32 bits, 128-word padded) and, with
    indels, the event tables {"ind_ip", "ind_len", "ind_rkey", "ind_rlen",
    "ind_rrow"} [E] and "ind_chars" [E, 16] at their padded power-of-two
    capacity E.  Returns (tables, row_db): row_db maps a table row to its
    VariantDB record and stays on the host (None without indels)."""
    from hisat2_tpu.index.graph import indel_device_tables
    device = torch.device(device)
    tabs = {"snv1": u32_to_tensor(_pad128(graph.snv_delta1), device),
            "snv2": u32_to_tensor(_pad128(graph.snv_delta2), device)}
    row_db = None
    if has_indels:
        t = indel_device_tables(graph)
        row_db = t.pop("_row_db")
        tabs.update({k: torch.from_numpy(np.ascontiguousarray(
            v, np.int32)).to(device) for k, v in t.items()})
    return tabs, row_db


def score_tables(scoring, device) -> dict:
    """Per-quality penalty tables (pipeline.py:359-362): int32 [64] each."""
    return {
        "mm_pen": torch.from_numpy(
            np.asarray(scoring.mm_pen_table(), np.int32)).to(device),
        "clip_pen": torch.from_numpy(
            np.asarray(scoring.clip_pen_table(), np.int32)).to(device),
    }
