"""MAPQ calculation — exact port of the *semantics* of BowtieMapq2
(hisat2's unique.h:169-416), HISAT2's default (--mapqv 2,
hisat2.cpp:468).

The dominant HISAT2 path: a read whose best alignment has no equal-scoring
second best gets MAPQ 60 (unique.h:211-217).  Otherwise MAPQ comes from the
end-to-end (monotone) decision table over (bestdiff, bestOver) fractions of
the perfect..min score interval.  Vectorized over reads with numpy.

Copied verbatim from hisat2_tpu/align/mapq.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np


def mapq_v2(best, secbest, has_secbest, perfect, minsc,
            exhausted=None, can_max=None):
    """All args int/bool arrays [B] (paired callers pass summed scores).

    best/secbest: alignment scores; has_secbest False -> secbest ignored.
    perfect: perfect score for the read (0 for end-to-end default).
    minsc: minimum valid score.
    exhausted/can_max: reporting-state flags (ReportingState); default the
    common case (search not exhausted, no -M cap hit) like the reference's
    default -k mode."""
    best = np.asarray(best, np.int64)
    secbest = np.asarray(secbest, np.int64)
    has_secbest = np.asarray(has_secbest, bool)
    perfect = np.asarray(perfect, np.int64)
    minsc = np.asarray(minsc, np.int64)
    B = best.shape[0]
    if exhausted is None:
        exhausted = np.zeros(B, bool)
    if can_max is None:
        can_max = np.zeros(B, bool)

    equal_secbest = has_secbest & (best == secbest)
    unique60 = ~can_max & ~exhausted & ~equal_secbest

    diff = np.maximum(perfect - minsc, 1)
    best_over = best - minsc
    bestdiff = np.abs(np.abs(best) - np.abs(secbest))

    # --- no (valid) secbest table (unique.h:236-244)
    frac = best_over.astype(np.float64) / diff
    no_sec = np.select(
        [frac >= 0.8, frac >= 0.7, frac >= 0.6, frac >= 0.5,
         frac >= 0.4, frac >= 0.3],
        [42, 40, 24, 23, 8, 3], default=0)

    # --- secbest table (unique.h:245-338)
    bo_eq = best_over == diff
    bo = best_over.astype(np.float64)
    d = diff.astype(np.float64)
    bd = bestdiff.astype(np.float64)

    def tier(hi_eq, mid_thresh_hi, mid_hi, mid_thresh_lo, mid_lo, lo):
        return np.where(bo_eq, hi_eq,
                        np.where(bo >= d * mid_thresh_hi, mid_hi,
                                 np.where(bo >= d * mid_thresh_lo, mid_lo,
                                          lo)))

    sec = np.select(
        [bd >= d * 0.9, bd >= d * 0.8, bd >= d * 0.7, bd >= d * 0.6,
         bd >= d * 0.5, bd >= d * 0.4, bd >= d * 0.3, bd >= d * 0.2,
         bd >= d * 0.1, bd > 0],
        [np.where(bo_eq, 39, 33),
         np.where(bo_eq, 38, 27),
         np.where(bo_eq, 37, 26),
         np.where(bo_eq, 36, 22),
         tier(35, 0.84, 25, 0.68, 16, 5),
         tier(34, 0.84, 21, 0.68, 14, 4),
         tier(32, 0.88, 18, 0.67, 15, 3),
         tier(31, 0.88, 17, 0.67, 11, 0),
         tier(30, 0.88, 12, 0.67, 7, 0),
         np.where(bo >= d * 0.67, 6, 2)],
        default=np.where(bo >= d * 0.67, 1, 0))

    mapq = np.where(has_secbest, sec, no_sec)
    return np.where(unique60, 60, mapq).astype(np.int32)


# --- V3 binned tables (unique.cpp:26-58) ---
_UNP_NOSEC_PERF = 44
_UNP_NOSEC = np.array([43, 42, 41, 36, 32, 27, 20, 11, 4, 1, 0], np.int32)
_UNP_SEC_PERF = np.array([2, 16, 23, 30, 31, 32, 34, 36, 38, 40, 42],
                         np.int32)
_UNP_SEC = np.array([
    [2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0],
    [20, 14, 7, 3, 2, 1, 0, 0, 0, 0, 0],
    [20, 16, 10, 6, 3, 1, 0, 0, 0, 0, 0],
    [20, 17, 13, 9, 3, 1, 1, 0, 0, 0, 0],
    [21, 19, 15, 9, 5, 2, 2, 0, 0, 0, 0],
    [22, 21, 16, 11, 10, 5, 0, 0, 0, 0, 0],
    [23, 22, 19, 16, 11, 0, 0, 0, 0, 0, 0],
    [24, 25, 21, 30, 0, 0, 0, 0, 0, 0, 0],
    [30, 26, 29, 0, 0, 0, 0, 0, 0, 0, 0],
    [30, 27, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [30, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
_PAIR_NOSEC_PERF = 44


def mapq_v3(best, secbest, has_secbest, perfect, minsc,
            exhausted=None, can_max=None, paired=False):
    """BowtieMapq3 (unique.h:95-165): 11x11 binned tables.

    Paired summaries always map to pair_nosec_perf=44 (unique.h:120-121);
    the unique-unexhausted-no-secbest case returns 255."""
    best = np.asarray(best, np.int64)
    secbest = np.asarray(secbest, np.int64)
    has_secbest = np.asarray(has_secbest, bool)
    perfect = np.asarray(perfect, np.int64)
    minsc = np.asarray(minsc, np.int64)
    B = best.shape[0]
    if paired:
        return np.full(B, _PAIR_NOSEC_PERF, np.int32)
    if exhausted is None:
        exhausted = np.zeros(B, bool)
    if can_max is None:
        can_max = np.zeros(B, bool)
    span = np.maximum(perfect - minsc, 1).astype(np.float64)
    bdist = (perfect - best).astype(np.float64)   # 0 = perfect
    best_bin = np.clip((bdist * (10.0 / span) + 0.5).astype(np.int64), 0, 10)
    ddist = np.where(has_secbest, best - secbest, 0).astype(np.float64)
    diff_bin = np.clip((ddist * (10.0 / span) + 0.5).astype(np.int64), 0, 10)
    is_perf = best == perfect
    with_sec = np.where(is_perf, _UNP_SEC_PERF[best_bin],
                        _UNP_SEC[diff_bin, best_bin])
    no_sec = np.where(is_perf, _UNP_NOSEC_PERF, _UNP_NOSEC[best_bin])
    mapq = np.where(has_secbest, with_sec, no_sec)
    return np.where(~can_max & ~exhausted & ~has_secbest,
                    255, mapq).astype(np.int32)


def mapq_v1(best, secbest, has_secbest, perfect, minsc,
            exhausted=None, can_max=None, paired=False):
    """BowtieMapq (V1, unique.h:430-510): sixth-interval thresholds."""
    best = np.asarray(best, np.int64)
    secbest = np.asarray(secbest, np.int64)
    has_secbest = np.asarray(has_secbest, bool)
    perfect = np.asarray(perfect, np.int64)
    minsc = np.asarray(minsc, np.int64)
    B = best.shape[0]
    if exhausted is None:
        exhausted = np.zeros(B, bool)
    if can_max is None:
        can_max = np.zeros(B, bool)
    diff = (perfect - minsc).astype(np.float64)
    sixth_2 = perfect - diff * 0.1666 * 2
    sixth_3 = perfect - diff * 0.1666 * 3
    no_sec = np.select([best >= sixth_2, best >= sixth_3], [37, 25],
                       default=10)
    bd = np.abs(np.abs(best) - np.abs(secbest)).astype(np.float64)
    sec = np.select([bd >= diff * 0.1666 * 5, bd >= diff * 0.1666 * 4,
                     bd >= diff * 0.1666 * 3, bd >= diff * 0.1666 * 2,
                     bd >= diff * 0.1666 * 1],
                    [6, 5, 4, 3, 2], default=1)
    mapq = np.where(has_secbest, sec, no_sec)
    return np.where(~can_max & ~exhausted & ~has_secbest,
                    255, mapq).astype(np.int32)


# module-selected version (--mapq-v; hisat2.cpp:468 default 2).  The CLI
# sets VERSION once before alignment; every internal MAPQ computation
# funnels through mapq_selected.
VERSION = 2
_FNS = {1: mapq_v1, 2: mapq_v2, 3: mapq_v3}


def mapq_selected(best, secbest, has_secbest, perfect, minsc,
                  exhausted=None, can_max=None, paired=False):
    fn = _FNS[VERSION]
    if VERSION == 2:
        return fn(best, secbest, has_secbest, perfect, minsc,
                  exhausted, can_max)
    return fn(best, secbest, has_secbest, perfect, minsc,
              exhausted, can_max, paired=paired)
