"""The FM index: its numpy form and on-disk format, and its device-resident
form (counterpart of hisat2_tpu/index/format.py).

FMMeta, FMIndex, ShardedFMIndex, fuse_blocked and the .npz save/load are
copied from hisat2_tpu/index/format.py (:45-127, :171-260) without its JAX
upload path (FMIndex.to_device, :129-169) and its pytree registration
(:263-282); the on-disk format is byte for byte the same, so an index
written by either package loads in the other.  The array layout is
described there.

`to_device` builds the same fused blocked table with `fuse_blocked` and
keeps the same padding: ref_words to a multiple of 128 words, the full
suffix array to a multiple of 8 entries (a sampled one unpadded, with the
mark planes fused into the block rows).  Packed uint32 tables travel as
int32 bit patterns (see utils/intops.py).  Only what the device step reads
is uploaded: the blocked table, fchr, ftab2_top, the suffix array (full or
sampled) and ref_words, one shard at a time.  The host keeps
ftab_top/ftab_bot (align/hostfm.py) and the fragment tables.

`graph_to_device` uploads a graph index's variant tables (the graph-DNA
part of pipeline.py:378-402, for one shard): the two 2-bit SNV planes,
padded like ref_words, and the padded indel event tables of
index/graph.py:indel_device_tables.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from ..utils.intops import u32_to_tensor

BLOCK_BASES = 128           # rank checkpoint interval (rows per occ block)


def fuse_blocked(occ, bwt_words, occ2=None, bwt2_words=None,
                 mark_words=None, mark_chk=None):
    """uint32 [nblocks+1, 12/44 (+5)]: per 128-row block, [occ c0..c3 |
    8 BWT words | occ2 s0..s15 | 16 bigram words | 4 mark words +
    mark-rank checkpoint] — the rank kernel's whole working set for a
    row, one gather.  Row width stays latency-flat on the gather path
    (PERF.md), so fusing the bigram planes is free; rank() reads only
    cols 0..11.  The mark columns (widths 17 and 49) let the resolve
    walk (ops/resolve.py) derive the mark bit AND the mark rank from
    the block row it already fetched — 2 fewer gathers per LF step."""
    occ = np.asarray(occ)
    bw = np.asarray(bwt_words).reshape(-1, 8)
    nblk = bw.shape[0]
    W = 12 if occ2 is None else 44
    Wm = W + (5 if mark_words is not None else 0)
    out = np.zeros((nblk + 1, Wm), np.uint32)
    out[:, :4] = occ.astype(np.uint32)
    out[:nblk, 4:12] = bw
    if occ2 is not None:
        out[:, 12:28] = np.asarray(occ2).astype(np.uint32)
        out[:nblk, 28:44] = np.asarray(bwt2_words).reshape(-1, 16)
    if mark_words is not None:
        out[:nblk, W:W + 4] = np.asarray(mark_words).reshape(-1, 4)
        out[:, W + 4] = np.asarray(mark_chk).astype(np.uint32)
    return out
WORDS_PER_BLOCK = BLOCK_BASES // 16
DEFAULT_OFF_RATE = 5        # SA sampled every 32 rows   (gfm.h:3909)
DEFAULT_FTAB_K = 10         # global k-mer jumpstart     (hisat2_build.cpp:101)


@dataclasses.dataclass(frozen=True)
class FMMeta:
    """Static (hashable) index geometry — safe to close over in jit."""
    n: int                  # joined text length (bases)
    rows: int               # n + 1
    zrow: int               # BWT row of '$'
    off_rate: int
    ftab_k: int
    ref_names: tuple[str, ...]
    ref_lens: tuple[int, ...]
    zrow2: int = -1         # BWT row with SA == 1 (bigram-plane special)

    @property
    def off_mask(self) -> int:
        return (1 << self.off_rate) - 1


@dataclasses.dataclass
class FMIndex:
    """Array bundle (host numpy or device jnp) + static meta."""
    meta: FMMeta
    bwt_words: Any          # uint32 [nblocks * WORDS_PER_BLOCK]
    occ: Any                # int32  [nblocks + 1, 4]
    mark_words: Any         # uint32 [nblocks * 4]
    mark_chk: Any           # int32  [nblocks + 1]
    sa_marked: Any          # int32  [n_marked]
    ftab_top: Any           # int32  [4^ftab_k]
    ftab_bot: Any           # int32  [4^ftab_k]
    fchr: Any               # int32  [5]
    ref_words: Any          # uint32 [ceil(n/16)]
    frag_joined: Any        # int32  [F + 1]
    frag_ref: Any           # int32  [F]
    frag_off: Any           # int32  [F]
    # bigram planes (optional; older indexes lack them and the search
    # falls back to single-char steps): 4-bit (prev2, prev1) symbols,
    # their occ checkpoints, and the 2-gram prefix block starts
    bwt2_words: Any = None  # uint32 [nblocks * 16]
    occ2: Any = None        # int32  [nblocks + 1, 16]
    ftab2_top: Any = None   # int32  [16]
    # derived, device-only (built by to_device, never persisted): the occ
    # checkpoint fused in front of each 128-row block's 8 BWT words (and
    # the bigram planes when present), so a rank query costs ONE row
    # gather instead of two separate gathers
    blocked: Any = None     # uint32 [nblocks + 1, 12 or 44]

    def arrays(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("meta", "blocked")
                and getattr(self, f.name) is not None}

    # ---- persistence (native format) ------------------------------------
    def save(self, path: str) -> None:
        meta = dataclasses.asdict(self.meta)
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 __meta__=np.frombuffer(
                     json.dumps(meta).encode(), dtype=np.uint8),
                 **{k: np.asarray(v) for k, v in self.arrays().items()})

    @staticmethod
    def load(path: str):
        if not path.endswith(".npz"):
            if not os.path.exists(path + ".npz"):
                from .ht2 import convert_ht2, is_ht2
                if is_ht2(path):
                    # a reference .ht2 index: convert to the native layout
                    # on first use (cached beside it or under the
                    # system temporary directory)
                    path = convert_ht2(path)
            path = path + ".npz"
        with np.load(path) as z:
            meta_d = json.loads(bytes(z["__meta__"]).decode())
            if "shard_bases" in meta_d:
                bases = meta_d["shard_bases"]
                base_path = path[:-len(".npz")]
                shards = [FMIndex.load(f"{base_path}.s{i}")
                          for i in range(len(bases))]
                return ShardedFMIndex(shards=shards, shard_bases=bases)
            meta_d["ref_names"] = tuple(meta_d["ref_names"])
            meta_d["ref_lens"] = tuple(meta_d["ref_lens"])
            meta = FMMeta(**meta_d)
            kw = {k: z[k] for k in z.files if k != "__meta__"}
        return FMIndex(meta=meta, **kw)


@dataclasses.dataclass
class ShardedFMIndex:
    """Whole-genome scale: sub-indexes over fragment groups, each a
    complete standalone FMIndex with SHARD-LOCAL joined coordinates; the
    aligner runs all shards and rebases candidates into a GLOBAL joined
    space (shard_bases[s] + local).  The reference handles >2^32 genomes
    with its 64-bit -align-l flavor (hisat2:444-457); int32 positions on
    the TPU favor sharding instead, which is also the natural multi-chip
    index-distribution axis."""
    shards: list
    shard_bases: list

    @property
    def meta(self) -> FMMeta:
        """Global meta: total joined length over the shards."""
        n = self.shard_bases[-1] + self.shards[-1].meta.n
        m0 = self.shards[0].meta
        return FMMeta(n=n, rows=n + 1, zrow=-1, off_rate=m0.off_rate,
                      ftab_k=m0.ftab_k, ref_names=m0.ref_names,
                      ref_lens=m0.ref_lens)

    # global fragment tables (concatenation, shard-local starts rebased)
    @property
    def frag_joined(self):
        parts = [np.asarray(sh.frag_joined[:-1]) + b
                 for sh, b in zip(self.shards, self.shard_bases)]
        return np.concatenate(parts + [[self.meta.n]]).astype(np.int64)

    @property
    def frag_ref(self):
        return np.concatenate(
            [np.asarray(sh.frag_ref) for sh in self.shards])

    @property
    def frag_off(self):
        return np.concatenate(
            [np.asarray(sh.frag_off) for sh in self.shards])

    @property
    def ref_words(self):
        raise AttributeError(
            "sharded index has no single packed reference; "
            "use per-shard ref_words")

    def global_ref_codes(self):
        from ..utils import bitops
        return np.concatenate([
            bitops.unpack_2bit(np.asarray(sh.ref_words), sh.meta.n)
            for sh in self.shards])

    def save(self, path: str) -> None:
        base = path[:-len(".npz")] if path.endswith(".npz") else path
        meta = {"shard_bases": [int(b) for b in self.shard_bases]}
        np.savez(base + ".npz", __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8))
        for i, sh in enumerate(self.shards):
            sh.save(f"{base}.s{i}")



@dataclasses.dataclass
class TorchFMIndex:
    meta: FMMeta
    blocked: torch.Tensor     # int32 [nblocks + 1, 44 (49 sampled)] u32 bits
    fchr: torch.Tensor        # int32 [5]
    ftab2_top: torch.Tensor   # int32 [16]
    sa: torch.Tensor          # int32: the full SA [rows padded to a
                              # multiple of 8], or sa_marked (sampled)
    ref_words: torch.Tensor   # int32 [multiple of 128] u32 bits
    device: torch.device

    def nbytes(self) -> int:
        """Device bytes of the uploaded index."""
        return sum(t.numel() * t.element_size() for t in (
            self.blocked, self.fchr, self.ftab2_top, self.sa,
            self.ref_words))


def to_device(index: FMIndex, device) -> TorchFMIndex:
    """Upload a numpy FMIndex to `device` (a torch device or its name), as
    FMIndex.to_device (:129-170) lays it out.  A sampled-SA index
    (off_rate > 0) fuses its mark words and mark-rank checkpoints into the
    block rows (49 columns) and keeps sa_marked unpadded: the walk reads
    sa_marked[min(rank, len - 1)].  A ShardedFMIndex uploads shard by
    shard (TorchAligner keeps one bundle per shard)."""
    if hasattr(index, "shards"):
        raise TypeError("upload a ShardedFMIndex shard by shard: "
                        "[to_device(sh, device) for sh in index.shards]")
    if index.ftab2_top is None or index.occ2 is None:
        raise ValueError("index has no bigram planes; rebuild it with "
                         "`python -m hisat2_tpu_torch build`")
    device = torch.device(device)
    sampled = index.meta.off_rate > 0
    blocked = fuse_blocked(index.occ, index.bwt_words, index.occ2,
                           index.bwt2_words,
                           mark_words=index.mark_words if sampled else None,
                           mark_chk=index.mark_chk if sampled else None)
    rw = _pad128(index.ref_words)
    sa = np.asarray(index.sa_marked, np.int32)
    if not sampled and len(sa) % 8:
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
    """A GraphArrays (index/graph.py:build_graph_arrays) on
    `device`: {"snv1", "snv2"} (int32 u32 bits, 128-word padded) and, with
    indels, the event tables {"ind_ip", "ind_len", "ind_rkey", "ind_rlen",
    "ind_rrow"} [E] and "ind_chars" [E, 16] at their padded power-of-two
    capacity E.  Returns (tables, row_db): row_db maps a table row to its
    VariantDB record and stays on the host (None without indels)."""
    from .graph import indel_device_tables
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
