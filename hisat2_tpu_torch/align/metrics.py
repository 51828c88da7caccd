"""--met/--met-file/--met-stderr metrics (reference: PerfMetrics /
OuterLoopMetrics, hisat2.cpp:1927-2290 `reportInterval`).

The reference emits one tab-separated snapshot of ~140 counters every
--met seconds.  The column set is reproduced verbatim; columns that
count work inside the reference's engine internals (SSE DP lanes,
cache pools) stay zero here — they measure a CPU engine this framework
replaces.  The columns with direct equivalents (reads, bases, alignment
outcome tallies, search/extension tallies) are populated from the batch
pipeline's counters.

Copied verbatim from hisat2_tpu/align/metrics.py; only the imports are
rewritten, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sys
import time

_COLUMNS = (
    "Time Read Base SameRead SameReadBase UnfilteredRead UnfilteredBase "
    "Paired Unpaired AlConUni AlConRep AlConFail AlDis AlConFailUni "
    "AlConFailRep AlConFailFail AlConRepUni AlConRepRep AlConRepFail "
    "AlUnpUni AlUnpRep AlUnpFail SeedSearch IntraSCacheHit InterSCacheHit "
    "OutOfMemory AlBWOp AlBWBranch ResBWOp ResBWBranch ResResolve "
    "ResReport RedundantSHit BestMinEdit0 BestMinEdit1 BestMinEdit2 "
    "ExactAttempts ExactSucc ExactRanges ExactRows ExactOOMs 1mmAttempts "
    "1mmSucc 1mmRanges 1mmRows 1mmOOMs UngappedSucc UngappedFail "
    "UngappedNoDec DPExLt10Gaps DPExLt5Gaps DPExLt3Gaps DPMateLt10Gaps "
    "DPMateLt5Gaps DPMateLt3Gaps DP16ExDps DP16ExDpSat DP16ExDpFail "
    "DP16ExDpSucc DP16ExCol DP16ExCell DP16ExInner DP16ExFixup "
    "DP16ExGathSol DP16ExBt DP16ExBtFail DP16ExBtSucc DP16ExBtCell "
    "DP16ExCoreRej DP16ExNRej DP8ExDps DP8ExDpSat DP8ExDpFail DP8ExDpSucc "
    "DP8ExCol DP8ExCell DP8ExInner DP8ExFixup DP8ExGathSol DP8ExBt "
    "DP8ExBtFail DP8ExBtSucc DP8ExBtCell DP8ExCoreRej DP8ExNRej "
    "DP16MateDps DP16MateDpSat DP16MateDpFail DP16MateDpSucc DP16MateCol "
    "DP16MateCell DP16MateInner DP16MateFixup DP16MateGathSol DP16MateBt "
    "DP16MateBtFail DP16MateBtSucc DP16MateBtCell DP16MateCoreRej "
    "DP16MateNRej DP8MateDps DP8MateDpSat DP8MateDpFail DP8MateDpSucc "
    "DP8MateCol DP8MateCell DP8MateInner DP8MateFixup DP8MateGathSol "
    "DP8MateBt DP8MateBtFail DP8MateBtSucc DP8MateBtCell DP8MateCoreRej "
    "DP8MateNRej DPBtFiltStart DPBtFiltScore DpBtFiltDom MemPeak "
    "UncatMemPeak EbwtMemPeak CacheMemPeak ResolveMemPeak AlignMemPeak "
    "DPMemPeak MiscMemPeak DebugMemPeak LocalSearch AnchorSearch "
    "LocalIndexSearch LocalExtSearch LocalSearchRecur GlobalGenomeCoords "
    "LocalGenomeCoords").split()


class MetricsSink:
    def __init__(self, path: str = None, to_stderr: bool = False,
                 interval: float = 1.0, per_read: bool = False):
        self.f = open(path, "w") if path else None
        self.to_stderr = to_stderr
        self.interval = max(float(interval), 0.0)
        self.per_read = per_read   # --met-read: one tuple per read
        self._reads_reported = 0
        self.last = 0.0
        self._write("\t".join(_COLUMNS) + "\t\n")

    def _write(self, line: str):
        if self.f:
            self.f.write(line)
            self.f.flush()
        if self.to_stderr:
            sys.stderr.write(line)

    def maybe_report(self, writer, n_bases: int, force: bool = False):
        now = time.time()
        if self.per_read:
            # one snapshot line per finished read (metricsPerRead,
            # hisat2.cpp:3222; counters are cumulative like the
            # reference's)
            total = (writer.n_pairs * 2 if writer.n_pairs
                     else writer.n_reads)
            while self._reads_reported < total:
                self._reads_reported += 1
                self._snapshot(writer, n_bases, now)
            return
        if not force and now - self.last < self.interval:
            return
        self.last = now
        self._snapshot(writer, n_bases, now)

    def _snapshot(self, writer, n_bases: int, now: float):
        v = {c: 0 for c in _COLUMNS}
        v["Time"] = int(now)
        paired = writer.n_pairs > 0
        reads = (writer.n_pairs * 2) if paired else writer.n_reads
        v["Read"] = reads
        v["Base"] = n_bases
        v["UnfilteredRead"] = reads
        v["UnfilteredBase"] = n_bases
        v["Paired"] = writer.n_pairs
        v["Unpaired"] = 0 if paired else writer.n_reads
        v["AlConUni"] = writer.n_conc_uniq
        v["AlConRep"] = writer.n_conc_multi
        v["AlConFail"] = (writer.n_pairs - writer.n_conc_uniq
                          - writer.n_conc_multi) if paired else 0
        v["AlDis"] = writer.n_disc
        v["AlUnpUni"] = (writer.n_mate_uniq if paired else writer.n_uniq)
        v["AlUnpRep"] = (writer.n_mate_multi if paired else writer.n_multi)
        v["AlUnpFail"] = (writer.n_mate_unal if paired else writer.n_unal)
        self._write("\t".join(str(v[c]) for c in _COLUMNS) + "\t\n")

    def close(self, writer, n_bases: int):
        self.maybe_report(writer, n_bases, force=True)
        if self.f:
            self.f.close()
