"""Rank / LF primitives and reference-char gathers, plain torch
(counterpart of hisat2_tpu/ops/rank.py).

These are the plain versions the CPU tests hold against the JAX package
and the CUDA kernels are held against on the card: kernel 1
(csrc/fm_search2.cu) does rank_from_rows/rank2_from_rows per lane with
__popc, kernel 2 (csrc/ref_window.cu) does ref_chars_block per char.
Rows and words arrive as int32 bit patterns and are widened with
utils.intops.as_u32.
"""

from __future__ import annotations

import torch

from ..utils.intops import U32, as_u32, popcount32

_PAIR_LO = 0x55555555
_NIB_LO = 0x11111111


def rank_from_rows(row, i, c, zrow: int):
    """# of char c in bwt[0:i), '$' excluded, from the pre-gathered fused
    rows of positions i (rank.py:38).  row: int64 [B, >=12] unsigned
    words; i, c: int64 [B].  Returns int64 [B]."""
    blk = i >> 7
    within = i & 127
    base = row[:, :4].gather(1, c[:, None])[:, 0]
    w = row[:, 4:12]
    pat = (c * _PAIR_LO)[:, None]
    x = (w ^ pat) ^ U32
    pairs = x & (x >> 1) & _PAIR_LO
    woff = torch.arange(8, device=row.device)[None, :]
    nvalid = (within[:, None] - 16 * woff).clamp(0, 16)
    mask = torch.where(nvalid >= 16, torch.full_like(nvalid, U32),
                       (1 << (2 * nvalid).clamp(max=31)) - 1)
    cnt = popcount32(pairs & mask).sum(dim=1)
    corr = ((c == 0) & (zrow >= (blk << 7)) & (i > zrow)).to(torch.int64)
    return base + cnt - corr


def rank2_from_rows(row, i, sym, zrow: int, zrow2: int):
    """Bigram rank on pre-gathered 44-column rows (rank.py:219): # rows
    j < i whose two preceding text chars form 4-bit symbol `sym`."""
    blk = i >> 7
    within = i & 127
    base = row[:, 12:28].gather(1, sym[:, None])[:, 0]
    w = row[:, 28:44]
    pat = (sym * _NIB_LO)[:, None]
    x = w ^ pat
    m = x | (x >> 1) | (x >> 2) | (x >> 3)
    hit = (m ^ U32) & _NIB_LO
    woff = torch.arange(16, device=row.device)[None, :]
    nvalid = (within[:, None] - 8 * woff).clamp(0, 8)
    mask = torch.where(nvalid >= 8, torch.full_like(nvalid, U32),
                       (1 << (4 * nvalid).clamp(max=31)) - 1)
    cnt = popcount32(hit & mask).sum(dim=1)
    corr = torch.zeros_like(cnt)
    for zr in (zrow, zrow2):
        if zr >= 0:
            corr = corr + ((sym == 0) & (zr >= (blk << 7))
                           & (i > zr)).to(torch.int64)
    return base + cnt - corr


def gather_rows(blocked, i):
    """Fused rows for positions i (int64 [B]) as unsigned int64 words."""
    return as_u32(blocked[i >> 7])


# JAX's ref_chars_block (rank.py:123-129) picks its gather lowering by the
# word count: 128-word rows above this many words (on a 128-padded
# array), 8-word rows below it.  Module constant so tests can force the
# 128-word rows on small fixtures, as JAX's tests do with its own.
ROW8_MAX_WORDS = 8 << 20


def clamp_row(nw: int) -> int:
    """The row width, in words, of JAX's ref_chars_block lowering for a
    plane of nw words (rank.py:151, :174, :202): 128 on a 128-padded
    plane above ROW8_MAX_WORDS, 8 on an 8-padded one, else 1.  It only
    shows where a position lies past the words but inside the text (a
    sharded index's rescue reads shard 0's words at global positions):
    there the gather clamps the ROW to the last one and keeps the word's
    place in its row."""
    if nw % 128 == 0 and nw > ROW8_MAX_WORDS:
        return 128
    return 8 if nw % 8 == 0 else 1


def clamp_words(gw, nw: int, row: int):
    """The word that JAX's gather reads for word index gw >= 0 of a plane
    of nw words whose rows are `row` words: gw itself below nw, else word
    gw % row of the last row (row 1: the last word, as ref_char's clamped
    gather reads it, rank.py:115-119)."""
    return (gw // row).clamp(max=nw // row - 1) * row + gw % row


def ref_chars_block(ref_words, n_text: int, start, L: int, row=None):
    """Chars ref[start + t] for t in [0, L): int32 [..., L], 4 where the
    position leaves the text (rank.py:132; its three TPU lowerings are
    not ported, only what they read: `clamp_words` with the row width of
    the lowering JAX takes for these words, or `row` words, 1 for
    ref_char's clamp).  ref_words: int32 u32 bits; start: [...]."""
    t = torch.arange(L, device=start.device)
    pos = start.to(torch.int64)[..., None] + t
    nw = ref_words.shape[0]
    row = clamp_row(nw) if row is None else row
    w = as_u32(ref_words[clamp_words((pos >> 4).clamp(min=0), nw, row)])
    ch = (w >> (2 * (pos & 15))) & 3
    return torch.where((pos < 0) | (pos >= n_text), 4, ch).to(torch.int32)
