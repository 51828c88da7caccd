"""`python -m hisat2_tpu_torch align`: the JAX CLI's option table plus
--device.

`_base_parser` is copied verbatim from hisat2_tpu/cli/align.py:17-268
(build_parser), but for the help of --coordinator (a torch.distributed
address here); that module's `main` imports the JAX driver, so `main`
here is its own: the same `-A <argfile>` mode (hisat2_tpu/cli/align.py:
274-295, its messages and return codes), then the port's driver.
"""

from __future__ import annotations

import argparse
import sys


def _base_parser():
    p = argparse.ArgumentParser(
        prog="hisat2-tpu", description="TPU-native spliced read aligner")
    p.add_argument("-x", dest="index", required=True, help="index basename")
    p.add_argument("-U", dest="unpaired", default=None,
                   help="comma-separated unpaired read files")
    p.add_argument("-1", dest="m1", default=None, help="mate-1 files")
    p.add_argument("-2", dest="m2", default=None, help="mate-2 files")
    p.add_argument("-S", dest="sam", default=None, help="output SAM file")
    p.add_argument("--12", dest="tab12", default=None,
                   help="tabbed-format reads file (pat.h:1025)")
    p.add_argument("-c", dest="cmdline_reads", action="store_true",
                   help="-U/-1/-2 operands are sequences themselves")
    p.add_argument("-r", dest="raw", action="store_true",
                   help="raw one-sequence-per-line input")
    p.add_argument("--qseq", action="store_true",
                   help="Illumina qseq input")
    p.add_argument("--phred33", "--phred33-quals", dest="qual_mode",
                   action="store_const", const="phred33",
                   default="phred33")
    p.add_argument("--phred64", "--phred64-quals", "--solexa1.3-quals",
                   dest="qual_mode", action="store_const", const="phred64")
    p.add_argument("--solexa-quals", dest="qual_mode", action="store_const",
                   const="solexa")
    p.add_argument("--int-quals", "--integer-quals", dest="qual_mode",
                   action="store_const", const="int")
    p.add_argument("--tab5", default=None,
                   help="5-field tabbed paired reads "
                        "(name, seq1, qual1, seq2, qual2; pat.h tab5)")
    p.add_argument("--tab6", default=None,
                   help="6-field tabbed paired reads (tab5 + mate-2 name)")
    p.add_argument("--sra-acc", dest="sra_acc", default=None,
                   help="SRA accession (requires network; unsupported "
                        "in this offline build)")
    p.add_argument("--qc-filter", dest="qc_filter", action="store_true",
                   help="filter out reads whose qseq filter field is 0 "
                        "(reported unaligned with YF:Z:QC)")
    p.add_argument("--non-deterministic", "--nondeterministic",
                   dest="non_deterministic", action="store_true",
                   help="seed the per-read RNG from the clock instead of "
                        "read name/sequence (hisat2.cpp:1046)")
    p.add_argument("-5", "--trim5", type=int, default=0,
                   help="trim N bases from 5' end")
    p.add_argument("-3", "--trim3", type=int, default=0,
                   help="trim N bases from 3' end")
    p.add_argument("--un", default=None,
                   help="write unpaired reads that fail to align")
    p.add_argument("--al", default=None,
                   help="write unpaired reads that align >=1 time")
    p.add_argument("--un-conc", default=None,
                   help="write pairs that fail to align concordantly")
    p.add_argument("--al-conc", default=None,
                   help="write pairs that align concordantly >=1 time")
    p.add_argument("--un-gz", dest="un_gz", default=None)
    p.add_argument("--al-gz", dest="al_gz", default=None)
    p.add_argument("--un-conc-gz", dest="un_conc_gz", default=None)
    p.add_argument("--al-conc-gz", dest="al_conc_gz", default=None)
    p.add_argument("--remove-chrname", action="store_true",
                   help="strip leading 'chr' from reference names")
    p.add_argument("--add-chrname", action="store_true",
                   help="prepend 'chr' to reference names")
    p.add_argument("--omit-sec-seq", "--sam-omit-sec-seq",
                   action="store_true",
                   help="print * for SEQ/QUAL of secondary alignments")
    p.add_argument("--reorder", action="store_true",
                   help="accepted; output is already in input order")
    p.add_argument("--exact-replay", dest="exact_replay",
                   action="store_true",
                   help="replay EVERY imperfect read through the "
                        "per-read reference evaluation model (full "
                        "byte parity; slower on edit-dense data). "
                        "Default replays only gap/clip/multimap-gap/"
                        "unaligned reads")
    p.add_argument("--mm", action="store_true",
                   help="accepted; index load is memory-mapped already")
    p.add_argument("-q", dest="fastq", action="store_true",
                   help="inputs are FASTQ (default: sniffed)")
    p.add_argument("-f", dest="fasta", action="store_true",
                   help="inputs are FASTA")
    p.add_argument("-k", "--khits", dest="khits", type=int,
                   default=None,
                   help="max # distinct alignments to report "
                        "(default 5 linear / 10 graph, hisat2.cpp:3701)")
    p.add_argument("-a", "--all", dest="all_hits", action="store_true",
                   help="report all alignments (device cap: 64 per read)")
    p.add_argument("--secondary", action="store_true",
                   help="report worse-scoring alignments as secondary")
    p.add_argument("--max-seeds", dest="max_seeds", type=int, default=0,
                   help="max seed placements considered "
                        "(default max(5, 2k), hisat2.cpp:3073)")
    p.add_argument("--n-hosts", dest="n_hosts", type=int, default=1,
                   help="total hosts in a multi-host run (each host "
                        "processes batches i with i %% n_hosts == rank "
                        "and writes a SAM shard; rank 0 merges)")
    p.add_argument("--host-rank", dest="host_rank", type=int, default=0,
                   help="this host's rank in [0, n_hosts)")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed coordinator address:port: "
                        "the hosts join one process group (NCCL with "
                        "--device cuda, gloo with --device cpu)")
    p.add_argument("-u", "--upto", "--qupto", dest="upto", type=int,
                   default=None, help="align at most this many reads")
    p.add_argument("-s", "--skip", dest="skip", type=int, default=0,
                   help="skip the first N reads")
    p.add_argument("--refidx", action="store_true",
                   help="accepted; with a named index the reference "
                        "keeps SN/RNAME unchanged too (verified v2.1.0)")
    p.add_argument("--end-to-end", action="store_true",
                   help="accepted; end-to-end is the only mode (the "
                        "reference removed bowtie2's --local)")
    p.add_argument("--local", "--fast-local", "--sensitive-local",
                   "--very-fast-local", "--very-sensitive-local",
                   dest="local_mode", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--ma", type=int, default=0,
                   help="match bonus (forced to 0 in end-to-end mode, "
                        "like the reference's scoring setup)")
    p.add_argument("--mapq-v", type=int, default=2, choices=(1, 2, 3),
                   help="MAPQ model version (unique.h new_mapq: 1 = "
                        "BowtieMapq, 2 = BowtieMapq2 default, 3 = "
                        "BowtieMapq3 binned tables)")
    p.add_argument("--gbar", type=int, default=4,
                   help="accepted; the SW layer it gates is off the "
                        "reference's own hot path (SURVEY 2.4)")
    p.add_argument("--show-rand-seed", action="store_true",
                   help="append ZS:i:<seed> (the read's pseudo-random "
                        "seed) to each record, like sam.h:683")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="reads per device batch")
    p.add_argument("--mp", default="6,2", help="max,min mismatch penalty")
    p.add_argument("--np", dest="npen", type=int, default=1,
                   help="penalty per read N")
    p.add_argument("--sp", default="2,1", help="max,min soft-clip penalty")
    p.add_argument("--no-softclip", action="store_true")
    p.add_argument("--rdg", default="5,3", help="read gap open,extend")
    p.add_argument("--rfg", default="5,3", help="ref gap open,extend")
    p.add_argument("--score-min", "--min-score", dest="score_min",
                   default="L,0,-0.2")
    p.add_argument("--n-ceil", default="L,0,0.15")
    p.add_argument("--ignore-quals", action="store_true")
    p.add_argument("--pen-cansplice", type=int, default=0)
    p.add_argument("--pen-noncansplice", type=int, default=12)
    p.add_argument("--pen-conflictsplice", type=int, default=1_000_000,
                   help="penalty for a read whose junctions imply "
                        "conflicting strands (hisat2.cpp:483)")
    p.add_argument("--pen-canintronlen", default=None,
                   help="canonical intron length penalty function "
                        "(default G,-8,1)")
    p.add_argument("--pen-noncanintronlen", default=None,
                   help="non-canonical intron length penalty function "
                        "(default G,-8,1; G,-8,2 under --dta)")
    p.add_argument("--min-intronlen", type=int, default=20)
    p.add_argument("--max-intronlen", type=int, default=500000)
    p.add_argument("--known-splicesite-infile", default=None)
    p.add_argument("--novel-splicesite-outfile", default=None)
    p.add_argument("--novel-splicesite-infile", default=None)
    p.add_argument("--no-temp-splicesite", action="store_true")
    # parsed-but-never-read in the reference (hisat2.cpp:259,494,1656:
    # splicesite_db_only is set and never consulted); accepted for CLI
    # compatibility with the same no-op semantics
    p.add_argument("--splicesite-db-only", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--rna-strandness", default="unstranded",
                   choices=["unstranded", "F", "R", "FR", "RF"])
    p.add_argument("--dta", "--downstream-transcriptome-assembly",
                   dest="dta", action="store_true")
    p.add_argument("--dta-cufflinks", dest="dta_cufflinks",
                   action="store_true",
                   help="like --dta, and report only spliced alignments "
                        "with canonical or known junctions")
    p.add_argument("--tmo", "--transcriptome-mapping-only", dest="tmo",
                   action="store_true",
                   help="report only alignments whose junctions are all "
                        "known splice sites (novel discovery disabled)")
    p.add_argument("--avoid-pseudogene", action="store_true",
                   help="accepted for compatibility (needs gene "
                        "annotation analysis the index does not carry)")
    p.add_argument("--no-templatelen-adjustment",
                   dest="no_templatelen_adjustment", action="store_true",
                   help="disable intron-aware TLEN adjustment for "
                        "RNA-seq pairs")
    p.add_argument("--max-altstried", type=int, default=16,
                   help="accepted for compatibility: the vectorized "
                        "extension evaluates every in-window ALT "
                        "combination, so no alt-budget applies")
    p.add_argument("--no-anchorstop", dest="no_anchorstop",
                   action="store_true",
                   help="do not stop the per-orientation search at a "
                        "long unique anchor (hisat2.cpp ARG_NO_ANCHORSTOP)")
    p.add_argument("--nofw", action="store_true")
    p.add_argument("--norc", action="store_true")
    p.add_argument("--no-unal", action="store_true",
                   help="suppress SAM records for unaligned reads")
    p.add_argument("--no-hd", "--sam-no-hd", "--sam-nohead", "--no-head",
                   "--sam-no-head", "--sam-noHD", "--no-HD",
                   dest="no_hd", action="store_true",
                   help="suppress header")
    p.add_argument("--no-sq", "--sam-no-sq", "--sam-nosq",
                   "--sam-noSQ", "--no-SQ", dest="no_sq",
                   action="store_true", help="suppress @SQ header lines")
    p.add_argument("--rg-id", "--sam-rg-id", dest="rg_id", default=None)
    p.add_argument("--rg", "--sam-rg", "--sam-RG", "--RG",
                   dest="rg", action="append",
                   default=[])
    p.add_argument("-I", "--minins", type=int, default=0)
    p.add_argument("-X", "--maxins", type=int, default=500)
    p.add_argument("--fr", dest="orient", action="store_const", const="fr",
                   default="fr")
    p.add_argument("--rf", dest="orient", action="store_const", const="rf")
    p.add_argument("--ff", dest="orient", action="store_const", const="ff")
    p.add_argument("--no-mixed", action="store_true")
    p.add_argument("--no-dovetail", dest="no_dovetail",
                   action="store_true",
                   help="accepted alias: dovetailing already rejected "
                        "by default (pe.h default)")
    p.add_argument("--dovetail", action="store_true",
                   help="concordant when mates extend past each other")
    p.add_argument("--no-contain", action="store_true",
                   help="not concordant when one mate contains the other")
    p.add_argument("--no-overlap", action="store_true",
                   help="not concordant when mates overlap")
    p.add_argument("--no-discordant", action="store_true")
    p.add_argument("--no-spliced-alignment", action="store_true")
    p.add_argument("--summary-file", default=None)
    p.add_argument("--new-summary", dest="new_summary",
                   action="store_true",
                   help="machine-friendly summary style "
                        "(aln_sink.h:1506-1526)")
    p.add_argument("-t", "--time", action="store_true")
    p.add_argument("-p", "--threads", type=int, default=1,
                   help="accepted for compatibility (device batching)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for pseudo-random tie-breaking")
    p.add_argument("--met", type=float, default=1.0,
                   help="metrics snapshot interval in seconds")
    p.add_argument("--met-file", "--metrics-file", dest="met_file",
                   default=None)
    p.add_argument("--met-stderr", "--metrics-stderr", dest="met_stderr",
                   action="store_true")
    p.add_argument("--met-read", "--metrics-per-read", dest="met_read",
                   action="store_true",
                   help="emit a metrics tuple for every read "
                        "(ARG_METRIC_PER_READ, hisat2.cpp:1288)")
    p.add_argument("--version", action="version",
                   version="hisat2-tpu 0.1.0 (hisat2 2.1.0 compatible)")
    # presets are accepted like the reference (they expand to Bowtie 2
    # multiseed policies HISAT2's spliced path does not consult,
    # presets.cpp:30-80)
    for pr in ("--very-fast", "--fast", "--sensitive", "--very-sensitive"):
        p.add_argument(pr, action="store_true",
                       help="accepted for compatibility")
    return p


def build_parser():
    p = _base_parser()
    p.prog = "hisat2-tpu-torch"
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the aligner: 'cuda' runs the "
                        "hand-written kernels (and fails without a GPU), "
                        "'cpu' their plain torch versions")
    return p


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    # -A <argfile>: run one alignment per non-empty line of arguments
    # (hisat2_main.cpp:43-66); each line names its own --device
    if len(argv) >= 2 and argv[0] == "-A":
        lastret = -1
        try:
            f_test = open(argv[1])
            f_test.close()
        except OSError as e:
            print(f"Error: could not open arg file {argv[1]}: {e}",
                  file=sys.stderr)
            return 1
        with open(argv[1]) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                lastret = main(toks)
        if lastret == -1:
            print(f"Warning: No arg strings parsed from {argv[1]}",
                  file=sys.stderr)
            return 0
        return lastret
    args = build_parser().parse_args(argv)
    from ..align import mapq as mapq_mod
    mapq_mod.VERSION = args.mapq_v
    from ..align.driver import run_align
    return run_align(args)


if __name__ == "__main__":
    sys.exit(main())
