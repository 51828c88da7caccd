"""Host alignment driver on the torch aligner, carried from
hisat2_tpu/align/driver.py (make_scoring and the unpaired branch of
run_align, :28-372).

The JAX driver imports hisat2_tpu.align.pipeline (and with it jax) at
module scope, so this copy exists until the JAX package is split
(ROADMAP.md).  Linear and graph (.var.npz, two-tier) indexes run; modes
the port does not run yet are refused with the ROADMAP item that will
bring them: paired reads (on any index), spliced alignment and multi-host
runs.
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque

import numpy as np

from hisat2_tpu.align import rng as rng_mod
from hisat2_tpu.align.scoring import Scoring, SimpleFunc
from hisat2_tpu.index.format import FMIndex
from hisat2_tpu.io import demux
from hisat2_tpu.io.fasta import (batch_stream, iter_cmdline, iter_tabbed,
                                 read_batches)
from hisat2_tpu.io.sam import SamWriter

from . import host as host_mod
from . import replay_glue
from .pipeline import TorchAligner


def make_scoring(args) -> Scoring:
    mp_max, mp_min = (int(x) for x in args.mp.split(","))
    sp_max, sp_min = (int(x) for x in args.sp.split(","))
    rdg_o, rdg_e = (int(x) for x in args.rdg.split(","))
    rfg_o, rfg_e = (int(x) for x in args.rfg.split(","))
    dta = getattr(args, "dta", False)
    canlen = getattr(args, "pen_canintronlen", None)
    nclen = getattr(args, "pen_noncanintronlen", None)
    return Scoring(mm_max=mp_max, mm_min=mp_min, n_pen=args.npen,
                   sp_max=sp_max, sp_min=sp_min,
                   rd_gap_open=rdg_o, rd_gap_ext=rdg_e,
                   rf_gap_open=rfg_o, rf_gap_ext=rfg_e,
                   no_softclip=args.no_softclip,
                   score_min=SimpleFunc.parse(args.score_min),
                   n_ceil=SimpleFunc.parse(args.n_ceil),
                   ignore_quals=args.ignore_quals,
                   pen_can_splice=args.pen_cansplice,
                   pen_noncan_splice=args.pen_noncansplice,
                   pen_conflict_splice=getattr(args, "pen_conflictsplice",
                                               1_000_000),
                   pen_can_intron_len=(SimpleFunc.parse(canlen)
                                       if canlen else
                                       SimpleFunc("G", -8.0, 1.0)),
                   pen_noncan_intron_len=(
                       SimpleFunc.parse(nclen) if nclen else
                       SimpleFunc("G", -8.0, 2.0) if dta else
                       SimpleFunc("G", -8.0, 1.0)),
                   min_intron_len=args.min_intronlen,
                   max_intron_len=args.max_intronlen,
                   min_anchor=15 if dta else 7,
                   min_anchor_noncan=20 if dta else 14)


def _refusal(args, index_base):
    """The reason this port cannot run `args` yet, or None."""
    if args.m1 or args.m2:
        return "paired-end reads (-1/-2): ROADMAP.md Queue 1 item 4"
    if not args.no_spliced_alignment:
        return ("spliced alignment is not ported yet (ROADMAP.md Queue 1 "
                "item 5); pass --no-spliced-alignment")
    if (getattr(args, "n_hosts", 1) or 1) > 1:
        return "multi-host runs (--n-hosts > 1): ROADMAP.md Queue 1 item 7"
    return None


def run_align(args) -> int:
    t0 = time.time()
    if getattr(args, "sra_acc", None):
        print("error: --sra-acc needs NCBI SRA network access, which "
              "this offline build does not have; download FASTQ with "
              "prefetch/fasterq-dump and pass it via -U",
              file=sys.stderr)
        return 1
    if getattr(args, "tab5", None) or getattr(args, "tab6", None):
        args.tab12 = args.tab5 or args.tab6
    if getattr(args, "dta_cufflinks", False):
        args.dta = True
    if getattr(args, "non_deterministic", False):
        args.seed = int(time.time() * 1e6) & 0x7FFFFFFF
    if getattr(args, "local_mode", False):
        print("error: this build implements end-to-end alignment only "
              "(HI_Aligner local mode is not ported); remove --local",
              file=sys.stderr)
        return 1
    if getattr(args, "ma", 0) > 0:
        print("Warning: Match bonus always = 0 in --end-to-end mode; "
              "ignoring user setting", file=sys.stderr)
        args.ma = 0
    index_base = args.index
    if not os.path.exists(index_base + ".npz"):
        from hisat2_tpu.index.ht2 import convert_ht2, is_ht2
        if is_ht2(index_base):
            index_base = convert_ht2(index_base)
    why = _refusal(args, index_base)
    tab12 = getattr(args, "tab12", None)
    if why is None and tab12:
        from hisat2_tpu.io.fasta import _open
        with _open(tab12.split(",")[0]) as f:
            if len(f.readline().rstrip(b"\n").split(b"\t")) >= 5:
                why = "paired tabbed reads: ROADMAP.md Queue 1 item 4"
    if why is not None:
        print(f"error: hisat2_tpu_torch does not run {why}",
              file=sys.stderr)
        return 1
    index = FMIndex.load(index_base)
    scoring = make_scoring(args)
    variants = None
    if os.path.exists(index_base + ".var.npz"):
        from hisat2_tpu_torch.index import VariantDB
        variants = VariantDB.load(index_base)
    if args.khits is None:
        # -k default: 5 on linear, 10 on graph indexes (hisat2.cpp:3701)
        args.khits = 10 if (variants is not None
                            and variants.n_snps) else 5
    aligner = TorchAligner(index, scoring, k=args.khits,
                           no_fw=args.nofw, no_rc=args.norc,
                           variants=variants, lane_meta=True,
                           max_seeds=getattr(args, "max_seeds", 0),
                           all_hits=getattr(args, "all_hits", False),
                           anchor_stop=not getattr(args, "no_anchorstop",
                                                   False),
                           device=args.device)
    out = open(args.sam, "w") if args.sam else sys.stdout
    disp_names = list(index.meta.ref_names)
    if getattr(args, "remove_chrname", False):
        disp_names = [n[3:] if n.startswith("chr") else n
                      for n in disp_names]
    elif getattr(args, "add_chrname", False):
        disp_names = ["chr" + n if not n.startswith("chr") else n
                      for n in disp_names]
    seed_map = {}
    if getattr(args, "show_rand_seed", False):
        out = _SeedTagOut(out, seed_map)
    writer = SamWriter(out, disp_names, index.meta.ref_lens,
                       cmdline=" ".join(sys.argv[1:]),
                       no_head=args.no_hd,
                       no_sq=getattr(args, "no_sq", False),
                       no_unal=args.no_unal,
                       rg_id=args.rg_id, rg=args.rg,
                       annotator=(aligner.annotate_snps
                                  if variants is not None else None),
                       rna_strandness=args.rna_strandness,
                       omit_sec_seq=getattr(args, "omit_sec_seq", False))
    met = None
    if getattr(args, "met_file", None) or getattr(args, "met_stderr", False) \
            or getattr(args, "met_read", False):
        from hisat2_tpu.align.metrics import MetricsSink
        met = MetricsSink(getattr(args, "met_file", None),
                          getattr(args, "met_stderr", False),
                          getattr(args, "met", 1.0),
                          per_read=getattr(args, "met_read", False))
    n_bases = 0
    fmt = ("fastq" if args.fastq else "fasta" if args.fasta else
           "raw" if getattr(args, "raw", False) else
           "qseq" if getattr(args, "qseq", False) else "auto")
    qmode = getattr(args, "qual_mode", "phred33")
    trim5, trim3 = getattr(args, "trim5", 0), getattr(args, "trim3", 0)

    def _fastq_out() -> bool:
        if fmt in ("fastq", "qseq"):
            return True
        if fmt != "auto":
            return False
        src = args.unpaired or tab12
        p = src.split(",")[0] if src else None
        if p is None or getattr(args, "cmdline_reads", False):
            return False
        from hisat2_tpu.io.fasta import _open
        with _open(p) as f:
            return f.read(1) == b"@"

    def _sink(plain, gz):
        path = plain or (gz if gz is None or gz.endswith(".gz")
                         else gz + ".gz")
        if path is None:
            return None
        return demux.ReadSink(path, _fastq_out())

    sink_un = _sink(getattr(args, "un", None), getattr(args, "un_gz", None))
    sink_al = _sink(getattr(args, "al", None), getattr(args, "al_gz", None))

    def unpaired_batches():
        bs, sk, up = args.batch_size, args.skip, args.upto
        if tab12:
            for path in tab12.split(","):
                yield from batch_stream(iter_tabbed(path, qmode), bs,
                                        skip=sk, limit=up,
                                        trim5=trim5, trim3=trim3)
            return
        if getattr(args, "cmdline_reads", False):
            yield from batch_stream(iter_cmdline(args.unpaired), bs,
                                    skip=sk, limit=up,
                                    trim5=trim5, trim3=trim3)
            return
        for path in args.unpaired.split(","):
            yield from read_batches(path, bs, skip=sk, limit=up, fmt=fmt,
                                    qc_filter=getattr(args, "qc_filter",
                                                      False),
                                    qual_mode=qmode, trim5=trim5,
                                    trim3=trim3)

    if not (args.unpaired or tab12):
        print("error: provide -U or --12", file=sys.stderr)
        return 1
    secondary = getattr(args, "secondary", False)
    k_rep = 10 ** 9 if getattr(args, "all_hits", False) else args.khits

    def emit(pend):
        nonlocal n_bases
        handle, b, b_rdids = pend
        res = aligner.collect(handle)
        n_bases += int(b.lens.sum())
        seeds = rng_mod.gen_rand_seeds(b.codes, b.lens, b.quals, b.names,
                                       seed=getattr(args, "seed", 0))
        if getattr(args, "show_rand_seed", False):
            seed_map.update(zip(b.names, (int(x) for x in seeds)))
        ranks = (None if res.orient_ranks is None
                 else [list(r) for r in res.orient_ranks])
        inlen = np.arange(b.codes.shape[1])[None, :] < b.lens[:, None]
        ncnt = ((b.codes > 3) & inlen).sum(axis=1)
        maxn = np.array([aligner.scoring.max_n(int(x)) for x in b.lens])
        # 0 = pass, 1 = YF:Z:NS (N ceiling), 2 = YF:Z:QC (--qc-filter)
        nfv = (ncnt > maxn).astype(np.int8)
        qcf = getattr(b, "qc_fail", None)
        if qcf is not None and qcf.any():
            nfv = np.where(qcf, np.int8(2), nfv)
        # per-read hybridSearch replay for search-path-sensitive reads
        overrides = replay_glue.substitute_batch(
            aligner, res, b.codes, b.quals, b.lens, seeds,
            secondary=secondary,
            exact=getattr(args, "exact_replay", False), rdids=b_rdids)

        def finalize(i, raw=res.raw):
            if i in overrides:
                return overrides[i]
            return rng_mod.finalize_unpaired(
                host_mod.read_alignments(raw, i), int(seeds[i]), k_rep,
                aligner.ref_codes,
                orient_rank=ranks[i] if ranks else None,
                secondary=secondary)

        writer.write_batch_raw(b.names, b.codes, b.quals, b.lens, res.raw,
                               aligner.ref_codes, n_filtered=nfv,
                               finalize=finalize)
        if sink_al is not None or sink_un is not None:
            has = np.zeros(len(b.names), bool)
            if res.raw is not None and len(res.raw["cols"][0]):
                has[np.asarray(res.raw["cols"][0])] = True
            for i, name in enumerate(b.names):
                L = int(b.lens[i])
                sink = sink_al if has[i] else sink_un
                if sink is not None:
                    sink.write(name, b.codes[i, :L], b.quals[i, :L])
        if met is not None:
            met.maybe_report(writer, n_bases)

    # 3-deep dispatch pipeline: the device runs batches i+1..i+2 while the
    # host renders batch i's SAM
    n_batches = 0
    rdid0 = 0
    pend = deque()
    for b in unpaired_batches():
        rdids = rdid0 + np.arange(len(b.names), dtype=np.int64)
        rdid0 += len(b.names)
        n_batches += 1
        pend.append((aligner.dispatch(b.codes, b.quals, b.lens, rdids), b,
                     rdids))
        if len(pend) >= 2:
            # advance the mid-queue two-pass handle: its pass-2 bucket
            # dispatches now and overlaps the newer batches' pass 1
            # (driver.py:359-364; no-op for a single-pass aligner)
            h, bb, rr = pend[-2]
            pend[-2] = (aligner.advance(h), bb, rr)
        if len(pend) >= 3:
            emit(pend.popleft())
    while pend:
        emit(pend.popleft())
    for s in (sink_un, sink_al):
        if s is not None:
            s.close()
    if met is not None:
        met.close(writer, n_bases)
    summ = writer.summary(new=getattr(args, "new_summary", False))
    if not args.quiet:
        sys.stderr.write(summ)
    if args.summary_file:
        with open(args.summary_file, "w") as f:
            f.write(summ)
    if args.time:
        sys.stderr.write(f"Time: {time.time() - t0:.2f}s "
                         f"({n_batches} device batches)\n")
    if args.sam:
        writer.close()
    return 0


class _SeedTagOut:
    """--show-rand-seed: append ZS:i:<seed> to every record (carried from
    hisat2_tpu/align/driver.py:478-509)."""

    def __init__(self, out, seed_map):
        self._out = out
        self._seeds = seed_map
        self._buf = ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line and not line.startswith("@"):
                sd = self._seeds.get(line.split("\t", 1)[0])
                if sd is not None:
                    fields = line.split("\t")
                    at = len(fields)
                    for t, f in enumerate(fields):
                        if f.startswith("MD:Z:"):
                            at = t + 1
                            break
                        if f.startswith("YT:Z:"):
                            at = t
                            break
                    fields.insert(at, f"ZS:i:{sd}")
                    line = "\t".join(fields)
            self._out.write(line + "\n")

    def __getattr__(self, nm):
        return getattr(self._out, nm)
