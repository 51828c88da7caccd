"""Alignment scoring policy (reference: hisat2's scoring.{h,cpp}).

Defaults replicate HISAT2 end-to-end scoring (scoring.h:29-87,
hisat2.cpp:414-432):
  match bonus 0, mismatch penalty MX,MN = 6,2 scaled by quality
  (COST_MODEL_QUAL, scoring.h:107-131: pen = MN + trunc(min(q,40)/40*(MX-MN))),
  N penalty 1 (constant), read/ref gap open 5 extend 3,
  score-min L,0,-0.2 (SimpleFunc linear, simple_func.h).

Copied verbatim from hisat2_tpu/align/scoring.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SimpleFunc:
    """const/linear/log/sqrt function of read length (simple_func.h)."""
    kind: str = "L"          # C, L, S, G
    const: float = 0.0
    coef: float = 0.0

    def __call__(self, x: float) -> float:
        if self.kind == "C":
            return self.const
        if self.kind == "L":
            return self.const + self.coef * x
        if self.kind == "S":
            return self.const + self.coef * math.sqrt(x)
        if self.kind == "G":
            return self.const + self.coef * math.log(x)
        raise ValueError(self.kind)

    @staticmethod
    def parse(spec: str) -> "SimpleFunc":
        kind, const, coef = spec.split(",")
        return SimpleFunc(kind, float(const), float(coef))


@dataclasses.dataclass(frozen=True)
class Scoring:
    match_bonus: int = 0             # end-to-end default (scoring.h:30)
    mm_max: int = 6                  # --mp 6,2
    mm_min: int = 2
    n_pen: int = 1                   # --np 1
    rd_gap_open: int = 5             # --rdg 5,3
    rd_gap_ext: int = 3
    rf_gap_open: int = 5             # --rfg 5,3
    rf_gap_ext: int = 3
    sp_max: int = 2                  # --sp 2,1 soft-clip penalty
    sp_min: int = 1
    no_softclip: bool = False        # --no-softclip
    score_min: SimpleFunc = SimpleFunc("L", 0.0, -0.2)   # --score-min
    n_ceil: SimpleFunc = SimpleFunc("L", 0.0, 0.15)      # --n-ceil
    ignore_quals: bool = False
    # spliced-alignment penalties (tp.h / hisat2.cpp:481-492), used by the
    # splice layer:
    pen_can_splice: int = 0
    pen_noncan_splice: int = 12
    # conflicting splice-strand evidence within one read: the align
    # driver's default is 1,000,000 (hisat2.cpp:483 sets
    # penConflictSplice before option parsing; Scoring's own ctor
    # default of 24 at scoring.h:159 is never what the binary runs
    # with) — effectively discarding multi-junction alignments whose
    # junction strands disagree (hi_aligner.h:3644-3705)
    pen_conflict_splice: int = 1_000_000
    pen_can_intron_len: SimpleFunc = SimpleFunc("G", -8.0, 1.0)
    pen_noncan_intron_len: SimpleFunc = SimpleFunc("G", -8.0, 1.0)
    min_intron_len: int = 20
    max_intron_len: int = 500000
    # novel-splice anchor minimums (tpol ctor, hisat2.cpp:3845-3848;
    # --dta raises them to 15/20 and noncan length penalty to G,-8,2)
    min_anchor: int = 7
    min_anchor_noncan: int = 14

    def mm_pen_table(self) -> np.ndarray:
        """Penalty per quality value 0..63 (scoring.h initPens, QUAL model)."""
        q = np.minimum(np.arange(64), 40)
        if self.ignore_quals:
            return np.full(64, self.mm_max, np.int32)
        return (self.mm_min
                + (q / 40.0 * (self.mm_max - self.mm_min)).astype(np.int32)
                ).astype(np.int32)

    def clip_pen_table(self) -> np.ndarray:
        """Soft-clip penalty per quality 0..63 (Scoring::sc, scoring.h:312:
        operates on the ASCII char q+33; <= '!' -> sp_min, else scaled)."""
        q = np.minimum(np.arange(64), 40)
        return (q / 40.0 * (self.sp_max - self.sp_min)
                + self.sp_min).astype(np.int32)

    def min_score(self, rdlen: int) -> int:
        # SimpleFunc::f returns float; the caller casts to TAlScore
        # (C truncation toward zero), hisat2.cpp:3276
        return int(self.score_min(float(rdlen)))

    def perfect_score(self, rdlen: int) -> int:
        return self.match_bonus * rdlen

    def max_n(self, rdlen: int) -> int:
        return min(int(self.n_ceil(float(rdlen))), rdlen)
