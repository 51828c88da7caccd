#!/usr/bin/env python3
"""Smoke run of hisat2_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths through the aligner's own entry points, at the
config-2 genome size (a seeded 40 Mbp genome, as bench.py config 2), and
checks them:

  1 card    nvidia-smi name and power limit, torch's device name
  2 build   the CUDA kernels from hisat2_tpu_torch/csrc (one nvcc per
            source, in parallel)
  3 index   build (cached under the temp dir) and upload the index; the
            genome carries 16 distinct 120 bp units, each 24 times at
            18 kbp spacing, so that mates inside them need mate rescue in
            phase 9 (tests/test_rescue.py's shape, 15 copies, is enough
            at k = 5; at the graph default k = 10 the search reports up
            to 20 placements, and a mate with 15 copies aligns alone)
  4 kernels linear path: each kernel on the real intermediates of one
            4096-read batch (K6+K7 on its core and its extra-slot launch),
            against its plain torch twin on the card: exact equality,
            median times of both; the launch (registers, shared memory,
            blocks per SM) of K6+K7, with its live share, lanes by live
            slots and distinct (lane, start) groups, and of K8, with its
            gap budget and live share, as on every step below that holds
            them against their twins (`step_shapes`), K6+K7's launch at
            L = 151, 250, 512 and 2000 (with its local bytes) and K8's
            at L = 151 and 512 with G up to 32; K1's launch on 44- and
            49-column tables and the share of its lanes' steps that fetch
            one fused row
  5 step    the whole linear device step on the card (kernels) against
            the step on the CPU (plain versions): equal packed buffers and
            layouts, spill and full_out
  6 slice   16 batches through dispatch/collect, 8 deep, SAM rendered to
            memory: reads/s, aligned share, share of unmodified reads
            placed at their true position (>= 99%), and the launch count
            of every kernel of the path in that run (> 0)
  7 cli     `python -m hisat2_tpu_torch align --device cuda` on the mm3
            corpus: SAM body equal to tests/data/mm3_ref_k10.sam.gz
  8 graph   the graph-DNA two-tier path on the same genome with a variant
            catalog at the density of HISAT2's GRCh38 graph (12.3 M
            variants over 3.1 Gbp: 11 M SNVs, 728 K deletions, 555 K
            insertions): every kernel on the lite and the full pass's
            intermediates (K5's one launch of the reference and SNV
            planes for the core and extra start sets, K6+K7 and K8 with
            SNVs, K10+K11, with K10's live slots) against its plain twin; the whole lite and full step
            against the CPU step; 4 batches of reads carrying catalog
            alleles through dispatch/advance/collect, SAM with Zs
            tags: reads/s, aligned share, SNV-only reads at their true
            position (>= 99%), known-indel alignments (> 0), routed share,
            launch counts (all seven > 0); and the CLI on the committed
            graph corpus (tests/data/gdna_*) against its oracle
  9 paired  paired-end DNA at the shape of bench.py config 3 (paired
            100 bp mates, --fr, against the graph index, k = 10), 4096
            pairs per batch, one fused batch of 8192 mates: K12
            (rescue_window) on each rescue chunk of the phase's first
            batch (the last with its all-N padding jobs) against its
            plain twin, on the first with the whole rescue_candidates
            call and K6+K7 on the chunk's rescoring, and timed
            beside the library yardstick (a grouped bf16 conv1d plus
            topk); K4 and K9 on the fused lite and full step's arguments
            against their twins, and the steps of its first 1024 pairs
            against the CPU step;
            4 batches through align/driver.py's _dispatch_pair_batch /
            advance / _align_pair_batch with SAM to memory: pairs/s,
            host ms per stage, concordant share (>= 0.95 among pairs
            without a repeat or random mate), SNV-only mates at their
            true position (>= 0.99), rescue jobs and rescued mates (> 0),
            launch counts (all eight > 0); and the paired CLI on the
            committed corpus (tests/data/pe_*) against its oracles, on
            the linear and the graph index
 10 spliced spliced RNA, the CLI's default mode, on the same linear index:
            400 GT-AG introns the genome already has (half 80-400 bp,
            half log-uniform 400 bp-50 kbp), 40 GC-AG / AT-AC and 40
            non-canonical ones, and 40 pairs around a 20-40 bp exon;
            8 batches of 4096 reads (a third across one junction, one in
            twelve across two, the rest phase 4's mix) through
            dispatch/advance/collect with the temp-site fixed point:
            reads/s, host ms per stage, routed share, sites, K18 merges,
            canonical single-junction reads with both anchors >= 20 bp at
            their true position with an N of the planted length (>= 95%),
            unmodified reads at their true position (>= 99%), launch
            counts (K13-K18 > 0, one K15 launch per K13 launch: both base
            pairs of a full step in one); then K13+K14, K15, K16 (lite and
            full; one full step launches K13 and K15 once each, and their
            registers, shared memory and blocks per SM are printed),
            K8 and K17 on a whole 4096-read full step (8192 lanes) and
            K18 on the slice's first merge against their plain twins, the
            lite and full step on the batch's first 1024 reads against
            the CPU step (phase 14 holds every kernel of a fused
            16,384-lane spliced step against its twin, and the step of
            its first 1024 pairs against the CPU), and the CLI on the nss
            round trip and mj3x
            against their oracles
 11 genome  genome scale, the shape of config 6 (BENCH_EXTRA.md:84-112)
            cut to two seeded 140 Mbp chromosomes: build_fm_index with a
            150 Mbp shard limit gives a ShardedFMIndex of two shards, each
            sampled at off_rate 4 (the builder's own choice at >= 2^27
            bp; cached under the temp dir); (a) every kernel a step of
            this path launches, against its plain twin on the arguments
            that step gave it (one 4096-read batch): the linear step of
            shard 0, the graph lite and full and the config-6 lite and
            full steps of shard 1 (fm_search2 on the 49-column rows,
            K19+K20 on the real rows and live masks, kernel 5 on the walk's
            offsets, the rest on shard-local tables); (b) the linear step
            of both shards against the CPU steps (1024-read batches); (c)
            8 batches of
            phase 4's mix over both chromosomes through dispatch/collect,
            8 deep, SAM to memory: reads/s, host ms per stage, unmodified
            reads at their true chromosome and position (>= 99%), reads on
            the second shard (>= 30%), launches (resolve_walk and
            compact_cands > 0); (d) a catalog at phase 8's density over
            280 Mbp attached shard by shard, 2 batches through
            dispatch/advance/collect: SNV-only reads true (>= 99%),
            known-indel alignments on each shard (> 0); (e) config 6's
            real mix in one aligner: the catalog of (d) with a junction
            SNV for each canonical intron, half of those introns baked in
            as --ss sites, spliced at k = 10; K13+K14, K15 and K16 (lite
            and full, with their SNV inputs) on shard 1's own step
            arguments, both steps against the CPU (1024 reads), then 4
            batches of phase 10's mix on both chromosomes (a fifth of the
            junction reads carrying their junction SNV) with the temp-site
            fixed point: canonical single-junction reads true with the
            planted N (>= 95%), unmodified reads (>= 99%), alignments
            through known sites on each shard (> 0), and K18 on each of
            the slice's incremental merges against its twin; (f)
            `align --device cuda --no-spliced-alignment` on the saved
            index: both chromosomes in the header at their lengths, >= 99%
            of 4096 unmodified reads at their true position
 12 multi   several devices and hosts (hisat2_tpu_torch/parallel): (a) K21,
            the dp-sharded step, as a world-1 NCCL group on cuda:0 on one
            4096-read batch of phase 4's index: its outputs equal to the
            single-device step's, n_cand equal to their valid-slot count;
            the step's and the all-reduce's median times; (b) MPMD on the
            committed shard corpus's index (tests/data/shard_*, built at
            --shard-bp 150000 --offrate 4): its shards on ["cuda:0",
            "cpu"] and on ["cuda:0", "cuda:0"] give equal alignments of
            256 reads; (c) `align --device cuda --n-hosts 2` as two
            processes on the card (mm3, -k 10, 8-read batches): the merged
            SAM body equal to the single-host run's and to mm3_ref_k10,
            and the dry-run twin (python -m hisat2_tpu_torch.parallel.dryrun
            --world 1 --device cuda) beside them
 13 long    reads above the kernels' former caps on phase 3's index: a
            128-read batch whose longest read is LONG_L = 1100 bp (the
            rest 100-300 bp) through the step on the card and on the CPU
            (K4 and K9 on its arguments against their twins, as on the
            spliced steps below), and 64 pairs (one of 1100 bp mates, a
            quarter needing mate rescue) through align/driver.py's
            paired batch on both: equal packed buffers and SAM, rescue
            jobs at 1100 bp, and K1,
            K6+K7, K8 and K12 launched at that width; a spliced batch of
            64 reads whose longest is SPLICED_LONG_L = 600 bp (half across
            phase 10's introns) through dispatch/advance/collect, then its
            lite and full steps on the card against the CPU's, with K13,
            K15 and K16 launched at that width; the full step of the same
            batch with its longest read at SPLICED_GLOBAL_L = 1100 bp,
            where K13 and K15 stage their planes in global memory: both
            against their twins on its lanes, and on those lanes tiled to
            three times the global grid and more (each block then walks
            3-4 lanes); K13's and K15's launches (shared or global
            staging) at 600 bp and at config 6's C = 19 with SNV windows
            at L = 500
 14 pairs   paired reads on every index the unpaired path takes: (a)
            spliced paired reads (the CLI's default for -1/-2) on phase
            3's index with phase 10's introns, driver defaults (k = 5, a
            spliced PairPolicy, intron lengths from the site table, the
            temp-site fixed point): 4 batches of 4096 pairs (8,192 fused
            mates, 16,384 lanes) through _dispatch_pair_batch / advance /
            _align_pair_batch, phase 9's mix with a third of the pairs
            carrying one mate across a junction and a tenth a fragment
            over an intron: pairs/s, host ms per stage, concordant share
            (>= 0.95 among pairs without a repeat or random mate),
            canonical junction mates with both anchors >= 20 bp at their
            true position with the planted N (>= 95%), rescued mates (>
            0), launches of K12 and K13-K18 (> 0); then the fused lite
            and full step of the first batch's first 1024 pairs against
            the CPU step, and every kernel of the whole fused batch's
            lite and full steps (16,384 lanes) on their arguments against
            its twin;
            (b)
            phase 11's two-shard index, the linear aligner, DNA mode (the
            JAX package fails on spliced paired runs over several shards,
            and the port refuses them): 2 batches of 4096 pairs over both
            chromosomes, concordant share (>= 0.95), aligned mates on the
            second shard (>= 30%), and one rescue chunk of jobs anchored on
            shard 1, whose windows read past shard 0's words as JAX's do,
            through K12 and K5 against their twins; (c) `align --device
            cuda` -1/-2 on the committed pes oracles (spliced on a linear
            and a --snp --ss index, DNA on two shards), the nss and shard
            corpora paired, and the sharded graph and sharded spliced runs
            refused with the JAX fault named
 15 genotype the genotype callers, typing through TorchAligner on the card
            (hisat2_tpu_torch/genotype/driver.py, each run with the launch
            counts set to 0 just before): (a) `--alleles` at HLA-A scale,
            400 alleles of a 3,000 bp locus (2-12 SNVs each), one batch
            of 4,096 reads of 150 bp, 2:1 from two alleles, through
            run_genotype (k = 16, max_seeds = 10**6: msize 64, hits
            hundreds of rows wide): the planted pair ranked on top, a
            call, K1, K4 and K9 launched; the driver's aligner's step on
            the batch, every kernel (K4 and K9 among them) against its
            plain twin on its arguments; the report on the first 512
            reads equal on --device cuda and cpu; (b) `--msa --assembly`
            on an STR locus, 1,000 alleles on a 3,464 bp backbone (SNVs
            and [TCTA]n[TCTG]m repeat lengths, the indels K10+K11 inject
            as catalog events), 4,096 reads: the planted pair on top,
            K10+K11 launched, both assembled haplotypes equal the planted
            alleles a read length away from the locus ends and the
            repeat block; the driver's graph aligner's lite and full
            steps on the first batch, every kernel (K10+K11 among them,
            with live injected events) against its plain twin; the report
            and the assembly on the first 512 reads equal on --device
            cuda and cpu; (c) `--run` on phase 8's saved 40 Mbp graph
            index (its cache base, no new build): three 1,200 bp locus
            windows with MSAs of 50 alleles mutated from them, 2 batches
            of 4,096 reads, 5% from the loci as 2:1 mixes and the rest
            phase 8's mix: each locus ranks its planted pair on top; the
            genome pass's aligner (k = 10, lane_meta) and the last
            locus's, the lite and full steps of each on a batch (the
            first batch; the locus's planted reads), every kernel against
            its plain twin; each part's reads/s and host seconds; (d) the CLI on the card:
            `genotype --device cuda` on the committed geno corpus
            (tests/data/make_geno.py) byte-equal to its four JAX oracles,
            and `align -A` on a two-line arg file (--device cuda, mm3)
            whose SAM bodies equal mm3_ref_k10 and mm3_ref_sec

Each kernel's bound (the kernels line's bound_ms) is the larger of the
bytes it must move over 3.35 TB/s and its operations over the peak rate
of their type (`work` below states the count for each kernel).  K19+K20,
a chain of dependent loads, also reports a latency floor
(latency_floor_ms): the longest walk's chain of dependent loads on the
genome linear step (`walk_chain`) at the dependent-load latency a pointer
chase over a buffer of its table's size measures in the same run
(dependent_load_ns, `chase_ns`).  K16's live slots and K20's live rows
are printed as shares on every step they are held on (`[live]`).

Any failed check raises and exits non-zero.  Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.  The line
before the last is a JSON object with per-kernel numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import gzip
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import deque

REPO = os.path.dirname(os.path.abspath(__file__))
B, L, N_BATCHES, DEPTH = 4096, 100, 16, 8
# phase 13: the longest read of its batches, above every former kernel cap,
# and of its spliced batch, above the junction sweeps' former 512 bp cap
LONG_L, SPLICED_LONG_L, SPLICED_GLOBAL_L = 1100, 600, 1100
# the graph slice's SAM render (the carried quadratic read_alignments behind
# the Zs annotator) takes about 3 s per batch: 4 batches still route reads
# and launch every kernel
G_BATCHES = 4
GENOME = 40_000_000
# phase 9: 16 distinct 120 bp units, each 24 times at 18 kbp spacing
REP_UNITS, REP_COPIES, REP_SPACING, REP_BASE = 16, 24, 18_000, 2_000_000
P_BATCHES = 4
# phase 9's fused step against the CPU: the first P_CMP_B pairs of a batch
P_CMP_B = 1024
# the card's peaks (H100 SXM data sheet): HBM bytes/s, bf16 and int8
# tensor-core operations/s, and the CUDA-core rate (its fp32 figure) used
# for the integer work of the kernels
HBM, BF16, INT8, CUDA_CORE = 3.35e12, 989e12, 1979e12, 67e12
# HISAT2's GRCh38 graph: 11 M SNVs, 728 K deletions, 555 K insertions over
# 3.1 Gbp (SURVEY.md), scaled to the genome
N_SNV = round(11_000_000 * GENOME / 3.1e9)
N_DEL = round(728_000 * GENOME / 3.1e9)
N_INS = round(555_000 * GENOME / 3.1e9)


# the kernels of the DNA paths (phases 4-9) and of the spliced path
DNA_KERNELS = ("fm_search2", "ref_window", "extend_ungapped", "indel_sweep",
               "compact_cands", "pack_slots", "inject_indels",
               "rescue_window")
SPLICED_KERNELS = ("search_lanes_live", "pair_sweep", "second_sweep",
                   "inject_known", "merge_sites")
# the kernels only a sampled-SA (genome-scale) index runs (phase 11)
GENOME_KERNELS = ("resolve_walk",)
# phase 10: 8 batches; introns (canonical short / long, semi-canonical,
# non-canonical) and two-junction pairs
S_BATCHES = 8
# phase 10's step against the CPU: the first S_CMP_B reads of its batch
S_CMP_B = 1024
N_CAN, N_SEMI, N_NONCAN, N_PAIRS = 400, 40, 40, 40
# phase 11: the shape of config 6 (BENCH_EXTRA.md:84-112) at chromosome
# scale: two 140 Mbp chromosomes, one shard each (150 Mbp shard limit), each
# sampled at the builder's off_rate 4; the graph catalog at the phase-8
# density over 280 Mbp
GS_CHR, GS_SHARD_BP = 140_000_000, 150_000_000
GS_BATCHES, GS_G_BATCHES, GS_S_BATCHES, GS_CMP_B = 8, 2, 4, 1024
GS_COUNTS = tuple(round(x * 2 * GS_CHR / 3.1e9)
                  for x in (11_000_000, 728_000, 555_000))
# phase 14: spliced paired batches on phase 3's index, paired batches on
# phase 11's two-shard index
PS_BATCHES, PG_BATCHES = 4, 2
# phase 14 (a): its warm-up batch's junctions use the first PS_INTRONS
# canonical introns, each later batch PS_NEW more (the site tables stay
# inside one capacity, 256 rows, so they grow by K18's merges)
PS_INTRONS, PS_NEW = 200, 10
# phase 15 (a): `genotype --alleles` at HLA-A scale (k = 16, max_seeds =
# 10**6 in the driver), the two planted alleles and the reads held against
# the CPU's report
GA_ALLELES, GA_BP, GA_RL, GA_PICKS, GA_CMP_B = 400, 3000, 150, (37, 311), 512
# (b): `genotype --msa --assembly` on an STR locus of 1,000 alleles
GB_ALLELES, GB_FLANK, GB_PICKS = 1000, 1700, (123, 789)
# (c): `genotype --run` on phase 8's saved graph index: three locus
# windows of the genome, 50 alleles each, 2 batches with 5% locus reads
GC_LOCI, GC_BP, GC_ALLELES = (12_000_000, 24_000_000, 33_000_000), 1200, 50
GC_BATCHES, GC_SHARE = 2, 0.05


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def simulate(np, rng, g, B, L):
    """B reads from genome g: half reverse-complemented; 0-4 mismatches,
    some Ns, some 1-5 bp indels, a few shorter reads.  Returns codes and
    quals uint8 [B, L] (padding: code 4, qual 0), lens int32 [B], the
    true start, and which reads are unmodified."""
    n = len(g)
    start = rng.integers(0, n - L - 8, B)
    win = g[start[:, None] + np.arange(L + 8)].astype(np.uint8)
    codes = win[:, :L].copy()
    clean = rng.random(B) < 0.4
    nmm = np.where(clean, 0, rng.integers(0, 5, B))
    for k in range(4):
        sel = nmm > k
        p = rng.integers(0, L, B)[sel]
        rows = np.flatnonzero(sel)
        codes[rows, p] = (codes[rows, p] + rng.integers(1, 4, len(rows))) % 4
    has_n = ~clean & (rng.random(B) < 0.1)
    codes[np.flatnonzero(has_n), rng.integers(0, L, B)[has_n]] = 4
    indel = np.flatnonzero(~clean & (rng.random(B) < 0.15))
    for i in indel:
        k = int(rng.integers(1, 6))
        p = int(rng.integers(10, L - 10))
        if rng.random() < 0.5:      # deletion of k reference chars
            codes[i] = np.concatenate([win[i, :p], win[i, p + k:L + k]])
        else:                       # insertion of k chars
            codes[i] = np.concatenate([win[i, :p],
                                       rng.integers(0, 4, k).astype(np.uint8),
                                       win[i, p:L - k]])
    lens = np.full(B, L, np.int32)
    short = np.flatnonzero(~clean & (rng.random(B) < 0.05))
    lens[short] = L - rng.integers(1, 30, len(short))
    rc = rng.random(B) < 0.5
    codes[rc] = np.where(codes[rc] < 4, 3 - codes[rc], 4)[:, ::-1]
    quals = rng.integers(20, 41, (B, L)).astype(np.uint8)
    col = np.arange(L)[None, :]
    codes[col >= lens[:, None]] = 4
    quals[col >= lens[:, None]] = 0
    return codes, quals, lens, start, clean, rc


def make_catalog(np, rng, g, path, counts=(N_SNV, N_DEL, N_INS),
                 chroms=None):
    """A seeded variant catalog over g at GRCh38-graph density, written as
    a hisat2 .snp file.  Indels are 1-16 bp, mostly 1-3.  chroms: the
    chromosomes [(name, joined start)] of a genome of several (default:
    one, "c2").  Returns the catalog as arrays (kind 0 SNV / 1 deletion /
    2 insertion, joined pos, alt or length, inserted chars)."""
    n = len(g)
    nv = sum(counts)
    chroms = chroms or [("c2", 0)]
    pos = np.sort(rng.choice(n - 400, nv, replace=False) + 200)
    kind = rng.permutation(np.repeat([0, 1, 2], counts))
    ln = np.where(rng.random(nv) < 0.85, rng.integers(1, 4, nv),
                  rng.integers(4, 17, nv))
    alt = (g[pos].astype(np.int64) + rng.integers(1, 4, nv)) % 4
    ins = rng.integers(0, 4, (nv, 16)).astype(np.uint8)
    acgt = np.array(list("ACGT"))
    cstart = np.array([c[1] for c in chroms])
    ci = np.searchsorted(cstart, pos, "right") - 1
    with open(path, "w") as f:
        for i in range(nv):
            k = int(kind[i])
            c, p = chroms[ci[i]][0], pos[i] - cstart[ci[i]]
            if k == 0:
                f.write(f"v{i}\tsingle\t{c}\t{p}\t{acgt[alt[i]]}\n")
            elif k == 1:
                f.write(f"v{i}\tdeletion\t{c}\t{p}\t{ln[i]}\n")
            else:
                f.write(f"v{i}\tinsertion\t{c}\t{p}\t"
                        f"{''.join(acgt[ins[i, :ln[i]]])}\n")
    return kind, pos, alt, ln, ins


def simulate_graph(np, rng, g, cat, B, L):
    """B reads carrying catalog alleles: 40% one catalog SNV and nothing
    else, 25% one catalog indel (1-16 bp), 20% 1-3 sequencing mismatches,
    15% reference copies; half reverse-complemented.  Returns codes,
    quals, lens, the true start, and which reads carry only catalog
    SNVs."""
    kind, pos, alt, ln, ins = cat
    n = len(g)
    r = rng.random(B)
    snv_only = r < 0.4
    has_indel = (r >= 0.4) & (r < 0.65)
    errs = (r >= 0.65) & (r < 0.85)
    snvs = np.flatnonzero(kind == 0)
    indels = np.flatnonzero(kind > 0)
    off = rng.integers(12, L - 12, B)
    vid = np.where(snv_only, rng.choice(snvs, B), rng.choice(indels, B))
    start = np.where(snv_only | has_indel, pos[vid] - off,
                     rng.integers(0, n - L - 20, B))
    start = np.clip(start, 0, n - L - 20)
    codes = g[start[:, None] + np.arange(L)].astype(np.uint8)
    rows = np.flatnonzero(snv_only)
    codes[rows, pos[vid[rows]] - start[rows]] = alt[vid[rows]]
    for i in np.flatnonzero(has_indel):
        v = vid[i]
        s, p, k = int(start[i]), int(pos[v]), int(ln[v])
        if kind[v] == 1:
            codes[i] = g[np.r_[s:p, p + k:s + L + k]]
        else:
            codes[i] = np.concatenate([g[s:p], ins[v, :k], g[p:s + L]])[:L]
    for k in range(3):
        sel = errs & (rng.random(B) < 0.7 if k else True)
        rr = np.flatnonzero(sel)
        p = rng.integers(0, L, len(rr))
        codes[rr, p] = (codes[rr, p] + rng.integers(1, 4, len(rr))) % 4
    rc = rng.random(B) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    quals = rng.integers(20, 41, (B, L)).astype(np.uint8)
    return codes, quals, np.full(B, L, np.int32), start, snv_only, rc


def plant_repeats(np, g):
    """Overwrite 16 distinct 120 bp units into g, each 24 times at 18 kbp
    spacing, inside the one chromosome; returns the copies' starts
    [unit][copy]."""
    rng = np.random.default_rng(31)
    spots = []
    for u in range(REP_UNITS):
        unit = rng.integers(0, 4, 120).astype(np.uint8)
        base = REP_BASE + u * (REP_COPIES + 1) * REP_SPACING
        spots.append([base + REP_SPACING * c for c in range(REP_COPIES)])
        for at in spots[-1]:
            g[at:at + 120] = unit
    return spots


def simulate_pairs(np, rng, g, cat, spots, B, L):
    """B read pairs, --fr, fragments of 200-500 bp.  The left mate
    carries phase 8's allele mix (40% one catalog SNV only, 25% one
    catalog indel, 20% 1-3 sequencing mismatches, 15% a reference copy);
    5% of pairs have their left mate inside a planted repeat copy, 2% a
    right mate of random sequence; half the pairs come from the reverse
    strand (mate 1 is then the right mate).  Returns mate codes and quals
    (uint8 [B, L]), each mate's true leftmost position, which mates carry
    one catalog SNV only, and which pairs have no repeat or random mate."""
    kind, pos, alt, ln, ins = cat
    n = len(g)
    r = rng.random(B)
    rep = r < 0.05
    rnd = (r >= 0.05) & (r < 0.07)
    plain = ~rep & ~rnd
    r2 = rng.random(B)
    snv_only = plain & (r2 < 0.4)
    has_indel = plain & (r2 >= 0.4) & (r2 < 0.65)
    errs = plain & (r2 >= 0.65) & (r2 < 0.85)
    snvs = np.flatnonzero(kind == 0)
    indels = np.flatnonzero(kind > 0)
    vid = np.where(snv_only, rng.choice(snvs, B), rng.choice(indels, B))
    off = rng.integers(12, L - 12, B)
    F = rng.integers(200, 501, B)
    s = np.where(snv_only | has_indel, pos[vid] - off,
                 rng.integers(0, n - 700, B))
    u = rng.integers(0, REP_UNITS, B)
    c = rng.integers(0, REP_COPIES, B)
    s = np.where(rep, np.asarray(spots)[u, c] + 10, s)
    s = np.clip(s, 0, n - 700)
    left = g[s[:, None] + np.arange(L)].astype(np.uint8)
    rows = np.flatnonzero(snv_only)
    left[rows, pos[vid[rows]] - s[rows]] = alt[vid[rows]]
    for i in np.flatnonzero(has_indel):
        v = vid[i]
        a, p, k = int(s[i]), int(pos[v]), int(ln[v])
        if kind[v] == 1:
            left[i] = g[np.r_[a:p, p + k:a + L + k]]
        else:
            left[i] = np.concatenate([g[a:p], ins[v, :k], g[p:a + L]])[:L]
    rs = s + F - L
    right = (3 - g[rs[:, None] + np.arange(L)])[:, ::-1].astype(np.uint8)
    right[rnd] = rng.integers(0, 4, (int(rnd.sum()), L))
    for m in (left, right):
        for k in range(3):
            sel = errs & (rng.random(B) < 0.7 if k else True)
            rr = np.flatnonzero(sel)
            p = rng.integers(0, L, len(rr))
            m[rr, p] = (m[rr, p] + rng.integers(1, 4, len(rr))) % 4
    fw = rng.random(B) < 0.5
    m1 = np.where(fw[:, None], left, right)
    m2 = np.where(fw[:, None], right, left)
    q1, q2 = (rng.integers(20, 41, (B, L)).astype(np.uint8) for _ in (0, 1))
    pos1, pos2 = np.where(fw, s, rs), np.where(fw, rs, s)
    snv1, snv2 = snv_only & fw, snv_only & ~fw
    return m1, m2, q1, q2, pos1, pos2, snv1, snv2, plain


def nbytes(torch, *ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def work(torch, name, kw, out):
    """(bytes, operations, peak rate, what bounds it) of one kernel call
    on these inputs.  Bytes: the dense inputs read once, the outputs
    written once, and of a large table only what these inputs touch.
    Operations: the kernel's per-element work at the CUDA-core rate,
    except K12, whose JAX original is a one-hot product (2 * 4 * W * L
    operations per job), at the int8 tensor-core rate its kernel runs it
    at (rescue_bf16_bound: the same count at the bf16 rate)."""
    ob = nbytes(torch, *flat_outputs(out))
    dense = nbytes(torch, *(v for k, v in kw.items() if k not in (
        "blocked", "sa", "sa_marked", "ref_words", "snv_delta1",
        "snv_delta2", "ip",
        "ilen", "ins_chars", "rkey", "r_ilen", "r_row")))
    rate = CUDA_CORE
    if name == "fm_search2":
        rows = fm_rows(kw, kw["reads"], kw["lens"])
        extra, ops = rows * 176, rows * 40       # the 44 words K1 reads
    elif name == "compact_cands":
        # the rows of the live hits (and of the spliced re-search's live
        # hits), each resolved once from the SA or read from the walk's
        # offsets (so offs / offs2 count by those rows, not in full); the
        # sorts' J log2 J compares a lane over its J slots
        from hisat2_tpu_torch.ops.compact import research_live, resolve_live
        N, H = kw["top"].shape
        P = kw["P"]
        hv, _ = resolve_live(kw["top"], kw["bot"], kw["lo"], kw["hi"],
                             kw["nh"], P, kw["min_k"], kw["maxsize"],
                             kw["short_rows"], kw["lite_cap"])
        rows = int(torch.where(hv, (kw["bot"] - kw["top"]).clamp(0, P),
                               0).sum())
        J = H * P
        if kw.get("top2") is not None:
            P2 = kw["P2"]
            hv2, _ = research_live(kw["top2"], kw["bot2"], kw["nh2"], P2)
            rows += int(torch.where(hv2, (kw["bot2"] - kw["top2"]).clamp(
                0, P2), 0).sum())
            J += kw["top2"].shape[1] * P2
        dense -= nbytes(torch, kw.get("offs"), kw.get("offs2"))
        extra = rows * 4
        ops = N * J * max(1, (J - 1).bit_length())
    elif name == "ref_window":
        # the starts of every set, a packed word per 16 chars of every
        # window, the windows written once
        dense = nbytes(torch, *kw["starts"])
        extra, ops = ob // 16, ob
    elif name == "extend_ungapped":
        # what the result needs: each lane's read and quals, the len
        # columns [margin, margin + len) of each distinct (lane, start)
        # group's window (and SNV windows), the window of the dead start
        # -1 once (it is the same for every lane), the starts, lens, minsc
        # and tables, the eight output planes; ~30 integer ops per column
        # of each group
        st, lens = kw["cand_start"], kw["lens"].long()
        B, C = st.shape
        nwin = 1 if kw.get("snv1_win") is None else 3
        live_g, dead_g = extend_groups(st)
        cols = int((live_g * lens).sum())
        dense = (int(lens.sum()) * 2 * 4 + (cols + int(lens.max())) * 4
                 * nwin + B * C * 4 + B * 8 + 2 * 64 * 4)
        extra, ob = 0, B * C * (7 * 4 + 1)
        ops = int(((live_g + dead_g) * lens).sum()) * 30
    elif name == "indel_sweep":
        # a dead candidate's row needs only its start: the read and quals
        # of each lane with a live candidate, the len + 2G columns
        # [M - G, M + G + len) of each live window (and SNV window) that
        # some shift reads, valid, starts, lens and minsc, the ten output
        # planes; 8 integer ops for each of the 4G combos at each of the
        # len + 1 split points of a live candidate
        from hisat2_tpu_torch.ops.splice import indel_sweep_gap
        N, C, W = kw["ch"].shape
        G = indel_sweep_gap(kw["reads"].shape[1], W, kw["max_gap"],
                            kw["prm"])
        valid, lens = kw["valid"], kw["lens"].long()
        live = int(valid.sum())
        live_cols = int((valid.sum(1) * lens).sum())
        nwin = 1 if kw.get("snv1_w") is None else 3
        dense = ((live_cols + 2 * G * live) * 4 * nwin
                 + int(lens[valid.any(1)].sum()) * 8 + N * C * 5 + N * 8)
        extra, ob = 0, 10 * N * C * 4
        ops = (live_cols + live) * G * 4 * 8
    elif name == "pack_slots":
        # the schema's planes read once, whatever reads them: each
        # distinct tensor once (a plane that fills two fields, as d1 and
        # d2 of the ungapped slots, is read once), by the elements it
        # spans (a broadcast plane reads one row); a constant or absent
        # field, or a block's key outside the schema, reads nothing; ~4
        # integer ops per slot key and ~40 per selected slot (a round of
        # the selection, its field loads and the packing)
        from hisat2_tpu_torch.ops.compact import SLOT_FIELDS
        blocks = kw["blocks"]
        fields = SLOT_FIELDS[:17 if kw.get("has_event") else 16]
        planes = {(v.data_ptr(), tuple(v.shape), v.stride(), v.dtype): v
                  for b in blocks for f in fields
                  if torch.is_tensor(v := b.get(f))}
        dense = sum(math.prod(n for n, s in zip(v.shape, v.stride()) if s)
                    * v.element_size() for v in planes.values())
        N = blocks[0]["score"].shape[0]
        K = sum(b["score"].shape[1] for b in blocks)
        extra, ops = 0, N * (4 * K + 40 * kw["Mdev"])
    elif name == "inject_indels":
        # only what the call must read: indel_work
        dense, ops = indel_work(torch, kw)
        extra = 0
    elif name == "rescue_window":
        R, L = kw["reads"].shape
        extra = R * ((kw["W"] + L - 1 + 15) // 16) * 4   # 2-bit windows
        ops, rate = 2 * 4 * kw["W"] * L * R, INT8
    elif name == "search_lanes_live":
        live = kw["cut"] >= kw["min_hit_len"]
        rows = fm_rows(kw, kw["reads"][live], kw["cut"][live])
        extra, ops = rows * 176, rows * 40
    elif name == "pair_sweep":
        # planes (48 PWM factors + prefixes per column), then ~25 integer
        # ops per (pair, x)
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        extra = 0
        ops = N * C * (Lr + 1) * 60 + N * C * C * (Lr + 2) * 25
    elif name == "second_sweep":
        # one plane prologue, then four sides (two base pairs), ~30
        # integer ops per cell each
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        extra = 0
        ops = N * C * (Lr + 1) * (60 + 4 * 30)
    elif name == "inject_known":
        # Dense: the candidates' starts, valid flags and clips, the lanes'
        # lens, read ids and minsc, the two 64-entry tables.  Of the reads,
        # qualities and windows only what the live slots walk: a lane's read
        # and qualities once if it has a live slot, the len columns of each
        # (lane, candidate) window a live slot reads (and its SNV windows),
        # the fresh diagonal's packed words of each live slot (and SNV
        # planes).  Extra: the site tables once (6 columns of S rows, the
        # two bucket entries a probe reads), the words of the four junction
        # chars (two a slot).  ~40 integer ops a slot, ~30 a walked column
        N, C, W = kw["ch"].shape
        J = out["score"].shape[1]
        _, _, ok = known_live(torch, kw)
        lens = kw["lens"].long()
        nwin = 1 if kw.get("snv1_w") is None else 3
        lnc = ok.view(N, -1, C).any(1)
        walked = int((ok.sum(1) * lens).sum())
        dense = (N * C * 13 + N * 12 + 2 * 64 * 4
                 + int(lens[ok.any(1)].sum()) * 8
                 + int((lnc.sum(1) * lens).sum()) * 4 * nwin
                 + (walked // 16 + 2 * int(ok.sum())) * 4 * nwin)
        tabs = kw["tabs"]
        extra = (6 * tabs["ss_kd"].numel() * 4 + N * J * 2 * 4
                 + (N * C * 2 * 2 * 4 if tabs.get("ss_kd_lob") is not None
                    else 0))
        ops = N * J * 40 + walked * 30
    elif name == "merge_sites":
        extra, ops = 0, kw["kd"].shape[0] * 6 * 10
    elif name == "resolve_walk":
        # Each distinct live row (rows that repeat walk the same path) is
        # walked to its mark, and each fetch counted by the 32 B sectors
        # it needs (walk_sectors); then one sa_marked entry per marked
        # row; ~60 integer ops a fetch.  Dense: the mask of every row and
        # the first row of each run of P rows (walk_rows) that holds a
        # live row
        rows = walk_rows(torch, kw)
        live = kw["live"] if kw["live"] is not None else torch.ones_like(
            rows, dtype=torch.bool)
        P = kw.get("P", 1)
        dense = rows.numel() * (kw["live"] is not None) \
            + int(live.view(-1, P).any(1).sum()) * 4
        sectors, fetches, marked = walk_sectors(
            torch, kw, torch.unique(rows[live]))
        extra = sectors * 32 + marked * 4
        ops = fetches * 60
    else:
        raise KeyError(name)
    by = dense + extra + ob
    t_b, t_o = by / HBM * 1e3, ops / rate * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def indel_live(torch, kw):
    """K10's slots on these arguments: (live slots, all slots, the live
    mask [N, J]); a slot is live where an event lies in the read span of a
    valid candidate, inside the read's bounds, with its allele in the read
    (splice.indel_probes), and only the live slots walk the read."""
    from hisat2_tpu_torch.ops.splice import indel_probes
    live = indel_probes(*(kw[k] for k in (
        "starts", "valid", "lens", "reads", "ip", "ilen", "ins_chars",
        "rkey", "r_ilen", "r_row")), kw["slots"])["live"]
    return int(live.sum()), live.numel(), live


def _union(torch, lo, hi):
    """The count of integers in the union of the intervals [lo, hi)."""
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    if lo.numel() == 0:
        return 0
    lo, order = lo.sort()
    hi = hi[order]
    # each interval adds what lies past the furthest end before it
    reach = hi.cummax(0).values
    before = torch.cat([lo[:1], reach[:-1]])
    return int((hi - lo.maximum(before)).clamp(min=0).sum())


def _search_rows(torch, tab, key):
    """Per row of the sorted table tab [E], whether a lower-bound search
    for any of the keys reads it, and each key's result."""
    E = tab.shape[0]
    lo = torch.zeros_like(key, dtype=torch.int64)
    hi = torch.full_like(lo, E)
    seen = torch.zeros(E, dtype=torch.bool, device=tab.device)
    while True:
        act = lo < hi
        if not bool(act.any()):
            return seen, lo
        mid = (lo + hi) >> 1
        seen[mid[act]] = True
        less = tab[mid.clamp(max=E - 1)] < key
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)


def indel_work(torch, kw):
    """K10's input bytes and integer operations on these arguments, by
    what the call must read.  Each candidate's start and valid flag, each
    lane's len, the 64-entry table, minsc of a lane with a live slot.  Of
    the event tables, the rows the probes touch, each once: each search's
    keys and, of a valid candidate, its slots' keys (ip / rkey); each
    slot's length (ilen / r_ilen, which d1 and d2 need dead or live); a
    live right-keyed slot's r_row; the I allele chars of each insertion an
    in-read slot checks.  Of the reads, qualities and windows what the
    walks and the allele checks read, each column once: a lane's read
    over the union of its live slots' runs and checked alleles, its
    qualities over its live slots' runs, each (lane, candidate) source
    window and its SNV windows over its live slots' source runs, the
    packed words (ref and SNV) of the live slots' fresh runs.  A live
    slot's two runs: left-keyed, the source window below x and the fresh
    diagonal from x + I to the read's end; right-keyed, the reverse.
    Operations: ~40 integer ops a slot, ~30 a walked column."""
    from hisat2_tpu_torch.ops.splice import MAX_INS, indel_probes
    pr = indel_probes(*(kw[k] for k in (
        "starts", "valid", "lens", "reads", "ip", "ilen", "ins_chars",
        "rkey", "r_ilen", "r_row")), kw["slots"])
    i64 = torch.int64
    starts, valid = kw["starts"], kw["valid"]
    N, C = starts.shape
    L = kw["reads"].shape[1]
    E = kw["ip"].shape[0]
    slots = kw["slots"]
    dev = starts.device
    x, fresh, ev, elen = (pr[k].to(i64) for k in ("x", "fresh", "event",
                                                   "elen"))
    live, J = pr["live"], pr["x"].shape[1]
    I = (-elen).clamp(min=0)
    ln = kw["lens"].to(i64)[:, None].expand(N, J)
    lim = ln.clamp(max=L)
    xr = (x + I).clamp(max=L)
    j = torch.arange(J, device=dev)
    left = (j < slots * C)[None, :].expand(N, J)
    n = torch.arange(N, device=dev)[:, None].expand(N, J)
    c = j % C
    by = N * C * 5 + N * 4 + 64 * 4 + int(live.any(1).sum()) * 4
    # an insertion an in-read slot checks the allele of
    chk = (pr["okd"] & (x >= 1) & (x + I <= ln - 1) & (elen < 0))
    for side, tab in ((0, kw["ip"]), (1, kw["rkey"])):
        seen, lo = _search_rows(torch, tab, starts + 1)
        used = torch.zeros(E, dtype=torch.bool, device=dev)
        keyed, event = torch.zeros_like(used), torch.zeros_like(used)
        for t in range(slots):
            idx = (lo + t).clamp(max=E - 1)
            used[idx.reshape(-1)] = True
            keyed[idx[valid & (lo + t < E)]] = True
            if side:                    # r_row, the event of a slot
                at = slice((slots + t) * C, (slots + t + 1) * C)
                event[idx[live[:, at] | chk[:, at]]] = True
        by += 4 * int((seen | keyed).sum() + used.sum() + event.sum())
    allele = torch.zeros(E, dtype=i64, device=dev)
    allele[ev[chk].clamp(min=0)] = I[chk].clamp(max=MAX_INS)
    by += int(allele.sum()) * 4
    # the runs of the live slots: below x, and from x + I to the read's end
    lv = live
    below = (torch.zeros_like(x[lv]), torch.minimum(x, lim)[lv])
    after = (xr.clamp(min=0)[lv], lim[lv])
    lf = left[lv]
    key = n[lv] * (L + 1)
    quals = _union(torch, torch.cat([key + below[0], key + after[0]]),
                   torch.cat([key + below[1], key + after[1]]))
    ck, cx = n[chk] * (L + 1), x[chk]
    reads = _union(torch, torch.cat([key + below[0], key + after[0],
                                     ck + cx]),
                   torch.cat([key + below[1], key + after[1],
                              ck + cx + I[chk]]))
    src = [torch.where(lf, b, a) for b, a in zip(below, after)]
    frs = [torch.where(lf, a, b) for b, a in zip(below, after)]
    wkey = (n * C + c)[lv] * (L + 1)
    wins = _union(torch, wkey + src[0], wkey + src[1])
    nwin = 1 if kw.get("snv1_w") is None else 3
    # the fresh runs' packed words (positions past the text read none)
    tl = min(int(kw["n_text"]), 16 * kw["ref_words"].shape[0])
    p0 = (fresh[lv] + frs[0]).clamp(0, tl)
    p1 = (fresh[lv] + frs[1]).clamp(0, tl)
    on = p1 > p0
    words = _union(torch, p0[on] // 16, (p1[on] - 1) // 16 + 1)
    nsnv = 2 if kw["snv_delta1"].numel() > 0 else 0
    by += ((reads + quals) * 4 + wins * 4 * nwin
           + words * 4 * (1 + nsnv))
    walked = int((below[1] - below[0]).clamp(min=0).sum()
                 + (after[1] - after[0]).clamp(min=0).sum())
    return by, live.numel() * 40 + walked * 30


def known_live(torch, kw):
    """K16's slots on these arguments: (live slots, all slots, the live
    mask [N, J]); a slot is live where a visible site lies in the read
    span of a valid candidate, and only the live slots walk the read."""
    from hisat2_tpu_torch.ops.splice import known_probes
    _, _, ok = known_probes(kw["starts"], kw["valid"], kw["lens"],
                            kw["rdids"], kw["tabs"], kw["slots"])
    return int(ok.sum()), ok.numel(), ok


def walk_rows(torch, kw):
    """K20's SA rows [M] on these arguments: `row` holds the first of each
    run of P consecutive rows."""
    P = kw.get("P", 1)
    row = kw["row"]
    if P == 1:
        return row
    return (row.long()[:, None] + torch.arange(P, device=row.device)).to(
        torch.int32).reshape(-1)


def walk_live(torch, kw):
    """K20's rows on these arguments: (live rows, rows, distinct live
    rows)."""
    row, live = walk_rows(torch, kw), kw["live"]
    lv = live if live is not None else torch.ones_like(row, dtype=bool)
    return int(lv.sum()), row.numel(), int(torch.unique(row[lv]).numel())


def walk_chain(torch, kw):
    """The longest chain of dependent loads among K20's walks on these
    rows: the mask byte and the row index (read together), the walk's
    block-row fetches (its steps + 1) and its sa_marked entry (a walk that
    never finds a mark: 2^off_rate + 1 fetches, no entry)."""
    from hisat2_tpu_torch.ops.resolve import walk_plain
    row, live = walk_rows(torch, kw), kw["live"]
    rows = torch.unique(row if live is None else row[live])
    if rows.numel() == 0:
        return 0
    done, _, steps, _ = walk_plain(kw["blocked"], kw["fchr"], kw["zrow"],
                                   kw["off_rate"], rows)
    chain = torch.where(done, steps + 3, (1 << kw["off_rate"]) + 2)
    return int(chain.max())


def live_text(torch, key, kw):
    """K16's live slots or K20's live rows on one captured call, as a
    share (and K20's distinct live rows and latency floor, once the
    pointer chase has run)."""
    if key.startswith("inject_known"):
        live, tot, _ = known_live(torch, kw)
        return (f"{key}: {live} live slots of {tot} (share "
                f"{live / max(tot, 1):.4f})")
    live, M, dist = walk_live(torch, kw)
    text = (f"{key}: {live} live rows of {M} (share {live / max(M, 1):.4f}"
            f", {dist} distinct)")
    if "ns" in CHASE:
        chain = walk_chain(torch, kw)
        text += (f", latency floor {chain * CHASE['ns'] * 1e-6:.4f} ms "
                 f"({chain} dependent loads)")
    return text


# the pointer chase's library and its latency (ns), once measured
CHASE = {}
# A pointer chase: one thread follows dependent loads (cached in L2 only)
# through a random cycle of nodes 128 bytes apart; its time a load is the
# card's dependent-load latency, the unit of K20's latency floor.
CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* __restrict__ next, int start, int steps,
                      int* sink) {
  int p = start;
  for (int s = 0; s < steps; ++s) p = __ldcg(next + p);
  *sink = p;
}
extern "C" int h2_chase(const void* next, int start, int steps, void* sink,
                        void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, start, steps,
                                           (int*)sink);
  return (int)cudaGetLastError();
}
"""


def chase_build(kernels):
    """Start nvcc on CHASE_SRC; returns (the process, the library)."""
    out = os.path.join(kernels.BUILD_DIR, "chase")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "chase.cu"), os.path.join(out, "libchase.so")
    with open(cu, "w") as f:
        f.write(CHASE_SRC)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.ARCH_FLAGS, "-O3", "-Xcompiler", "-fPIC",
         "-shared", "-o", so, cu], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), so


def chase_ns(torch, so, nbytes, steps=20_000):
    """The dependent-load latency (ns) of a chase over a buffer of
    `nbytes` (the size of the table the walk reads), CUDA events around
    one launch of `steps` loads, median of 3."""
    import ctypes
    fn = ctypes.CDLL(so).h2_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nodes = max(2, nbytes // 128)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    perm = (torch.randperm(nodes, device="cuda", generator=gen) * 32).to(
        torch.int32)
    nxt = torch.zeros(nodes * 32, dtype=torch.int32, device="cuda")
    nxt[perm.long()] = torch.roll(perm, -1)
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def run(k, at):
        check(fn(nxt.data_ptr(), int(perm[at % nodes]), k, sink.data_ptr(),
                 st) == 0, "pointer chase: launch error")
    run(1000, 0)
    times = []
    for i in range(3):
        # each run on its own stretch of the cycle, so that no load finds
        # its node in a cache from an earlier run
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run(steps, (i + 1) * (steps + 1000))
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e6 / steps)
    del nxt, perm
    return statistics.median(times)


def fm_rows(kw, reads, lens):
    """The fused rows K1 (or K17) fetches searching these lanes: two a
    search step, one where top and bot lie in one 128-row block, as the
    plain twin counts them on the same index arguments."""
    from hisat2_tpu_torch.ops.search import partial_search2_plain
    st = {}
    partial_search2_plain(
        kw["blocked"], kw["fchr"], kw["ftab2_top"], kw["zrow"], kw["zrow2"],
        kw["rows"], reads, lens, kw["max_hits"], kw["min_hit_len"],
        kw["min_k"], uniform=kw.get("uniform", False),
        anchor_stop=kw.get("anchor_stop", True), stats=st)
    return 2 * st.get("steps", 0) - st.get("one_row", 0)


def walk_sectors(torch, kw, row):
    """resolve_walk's LF walk of the SA rows `row`, step by step: the 32 B
    sectors its fetches need, the fetches, and the rows that found a mark.
    A step past an unmarked row needs bytes [0, 48) (occ, BWT words) and
    [176, 196) (mark words, checkpoint) of its 196 B block row, the marked
    row's fetch only [176, 196); each counted at the row's real offset in
    its first sector, 196 * blk mod 32."""
    from hisat2_tpu_torch.ops.rank import rank_from_rows
    from hisat2_tpu_torch.utils.intops import as_u32
    bl, fc = kw["blocked"], kw["fchr"].long()
    r = row.long()
    sectors = fetches = marked = 0
    for _ in range((1 << kw["off_rate"]) + 1):
        blk = (r >> 7).clamp(max=bl.shape[0] - 1)
        a = blk * 196 % 32
        brow = as_u32(bl[blk])
        mw = brow[:, 44:48].gather(1, ((r >> 5) & 3)[:, None])[:, 0]
        hit = ((mw >> (r & 31)) & 1) != 0
        head = (a + 47) // 32 - a // 32 + 1
        tail = (a + 195) // 32 - (a + 176) // 32 + 1
        sectors += int(tail.sum() + head[~hit].sum())
        fetches += r.numel()
        marked += int(hit.sum())
        r, brow = r[~hit], brow[~hit]
        w = brow[:, 4:12].gather(1, ((r >> 4) & 7)[:, None])[:, 0]
        c = (w >> (2 * (r & 15))) & 3
        r = fc[c] + rank_from_rows(brow, r, c, kw["zrow"])
    return sectors, fetches, marked


def rescue_bf16_bound(kw):
    """K12's one-hot product (work's count) at the bf16 tensor-core rate
    of the JAX original's convolution, ms."""
    R, L = kw["reads"].shape
    return 2 * 4 * kw["W"] * L * R / BF16 * 1e3


def rescue_library_ms(torch, kw):
    """The library yardstick of K12: one grouped bf16 conv1d of the
    one-hot window against the one-hot mates, then torch.topk (the JAX
    original's computation; the port never calls it)."""
    from hisat2_tpu_torch.ops import rank
    R, L = kw["reads"].shape
    W = kw["W"]
    refc = rank.ref_chars_block(kw["ref_words"], kw["n_text"],
                                kw["win_start"], W + L - 1)
    ar = torch.arange(4, device=refc.device)[None, :, None]
    x = (refc[:, None, :] == ar).to(torch.bfloat16).reshape(1, R * 4, -1)
    w = (kw["reads"][:, None, :] == ar).to(torch.bfloat16)

    def lib(x, w):
        m = torch.nn.functional.conv1d(x, w, groups=R)[0]
        return torch.topk(m.float(), 8, dim=1)

    return median_ms(torch, lib, {"x": x, "w": w})


def median_ms(torch, fn, kw, reps=10):
    for _ in range(2):
        fn(**kw)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(**kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flat_outputs(x):
    """A kernel's outputs as a flat list of tensors (named tuples, dicts
    by sorted key, tuples; nested)."""
    if hasattr(x, "_fields"):
        return [getattr(x, f) for f in x._fields]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat_outputs(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in flat_outputs(e)]
    return [x]


def extend_groups(st):
    """Per lane of K6+K7's starts [B, C]: its count of distinct live
    starts, and 1 where it has a dead slot (start < 0).  The kernel
    evaluates each distinct (lane, start) once; every dead slot of a lane
    has start -1."""
    srt = st.sort(1).values
    first = srt.new_ones(srt.shape, dtype=bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return ((srt >= 0) & first).sum(1), (srt < 0).any(1).long()


def launch_shape(splice, name, kw):
    """K6+K7's, K8's, K13's or K15's launch on these arguments, as the CUDA
    runtime reports it: K6+K7's with its live share, its lanes by their
    count of live slots, its distinct (lane, start) groups and its bound
    (`work`), K8's with its gap budget and its share of live
    candidates."""
    Lr = kw["reads"].shape[1]
    if name == "extend_ungapped":
        from hisat2_tpu_torch.ops import extend
        st = kw["cand_start"]
        N, C = st.shape
        snv = kw.get("snv1_win") is not None
        info = extend.launch_info(Lr, snv)
        live = st >= 0
        by = live.sum(1).bincount(minlength=C + 1).tolist()
        live_g, dead_g = extend_groups(st)
        import torch
        bound, by_what = work(torch, name, kw, extend.extend_grouped(**kw))
        more = (f", live share {float(live.float().mean()):.4f}, lanes by "
                f"live slots {by}, {int((live_g + dead_g).sum())} distinct "
                f"(lane, start) groups of {N * C} slots, bound {bound:.4f} "
                f"ms ({by_what})")
    else:
        N, C, W = kw["ch"].shape
        snv = kw.get("snv1_w") is not None
        if name == "indel_sweep":
            LP, G = 0, splice.indel_sweep_gap(Lr, W, kw["max_gap"],
                                              kw["prm"])
            more = (f", G = {G}, live share "
                    f"{float(kw['valid'].float().mean()):.4f}")
        else:
            LP, G, more = kw["lenpen"][1].shape[1], 0, ""
        info = splice.sweep_launch_info(name, C, Lr, W, LP, snv, G)
    check(info["blocks_per_sm"] >= 1, f"{name}: no block fits an SM")
    return f"C = {C}, L = {Lr}{', SNV windows' if snv else ''}{more}: " + \
        shape_text(info)


def shape_text(info):
    local = (f", {info['local_bytes']} local bytes per thread"
             if "local_bytes" in info else "")
    if "scratch_per_block" in info:
        local += (f", planes in global scratch, {info['scratch_per_block']}"
                  f" bytes per block" if info["scratch_per_block"] else
                  ", planes in shared memory")
    return (f"{info['regs']} registers, {info['smem']} + "
            f"{info['static_smem']} bytes of shared memory per block, "
            f"{info['threads']} threads, {info['blocks_per_sm']} blocks per "
            f"SM{local}")


# the kernels of a captured step whose launch launch_shape reports
SHAPED = ("extend_ungapped", "extend_ungapped/extra", "indel_sweep",
          "pair_sweep", "second_sweep")


def step_shapes(splice, step, cap, k5=None):
    """Print the launch of each kernel of the captured step `step` that
    launch_shape reports on, K5's launches in the step (k5, where the
    caller counted them) and K10's live slots (sweep_ab.py wraps this
    function to time the step's kernels against an earlier tree's)."""
    for key in SHAPED:
        if key in cap:
            shape = launch_shape(splice, key.split("/")[0], cap[key])
            print(f"[launch] {step} {key}: {shape}")
    if k5 is not None:
        wins = sum(len(v["planes"]) * len(v["starts"]) for k, v in
                   cap.items() if k.split("/")[0] == "ref_window")
        print(f"[launch] {step} ref_window: {k5} launches in the step for "
              f"its {wins} windows (planes x start sets)")
    if "inject_indels" in cap:
        import torch
        live, tot, _ = indel_live(torch, cap["inject_indels"])
        print(f"[launch] {step} inject_indels: {live} live slots of {tot} "
              f"(share {live / max(tot, 1):.4f})")


def compare(torch, name, kern, plain, kw, time_plain=True):
    """Kernel vs plain twin on the same inputs: exact equality.  Returns
    the max abs error (0) and both median times (the plain twin's None
    without time_plain)."""
    ko, po = flat_outputs(kern(**kw)), flat_outputs(plain(**kw))
    torch.cuda.synchronize()
    check(len(ko) == len(po), f"{name}: output arity")
    err = 0.0
    for a, b in zip(ko, po):
        if a is None or b is None:
            check(a is None and b is None, f"{name}: optional output")
            continue
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: shape/dtype {a.shape} {b.shape}")
        err = max(err, float((a.double() - b.double()).abs().max())
                  if a.numel() else 0.0)
        check(torch.equal(a, b), f"{name}: kernel != plain")
    return err, median_ms(torch, kern, kw), (
        median_ms(torch, plain, kw) if time_plain else None)


def hold_slots(torch, tag, cap):
    """K4 (compact_cands) and K9 (pack_slots) on one captured step's
    arguments against their plain twins: exact equality."""
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    for name in ("compact_cands", "pack_slots"):
        err, ms, pms = compare(torch, name, *twins[name], cap[name])
        print(f"[{tag}] {name}: equal to plain (tolerance: exact), "
              f"max_abs_err {err}; kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(median of 10)")


def run_cli(args, cwd, env, timeout):
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    check(r.returncode == 0, f"CLI {args[0]} failed: {r.stderr[-2000:]}")


def run_clis(argss, cwd, env, timeout, ok=True):
    """The CLI once per argument list, the runs side by side (one torch
    thread each); returns each run's (exit code, standard error), and with
    `ok` checks that each exited 0."""
    env1 = dict(env, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "hisat2_tpu_torch"]
                              + a, cwd=cwd, env=env1, text=True,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE) for a in argss]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, (rc, err) in zip(argss, out):
        check(not ok or rc == 0, f"CLI {a[0]} failed: {err[-2000:]}")
    return out


def pick_introns(np, rng, g, first_slot=8_000_000):
    """The phase-10 introns on dinucleotides the genome already has
    (nothing is planted, so the index stays phase 3's): donors in 8-38
    Mbp (from first_slot), one per 55 kbp slot, clear of phase 9's repeat
    block.  Returns
    (introns [(donor d, acceptor e, class)], pairs [((d1, e1), (d2, e2))]):
    the intron is g[d:e], classes 0 GT-AG, 1 GC-AG / AT-AC, 2 none."""
    dn = (g[:-1].astype(np.int16) * 4 + g[1:]).astype(np.int8)
    GT, GC, AT, AG, AC = 11, 9, 3, 2, 1
    pos = {k: np.flatnonzero(dn == k) for k in (GT, GC, AT, AG, AC)}

    def first(k, at):
        i = int(np.searchsorted(pos[k], at))
        return int(pos[k][i])

    def donor_acc(dk, ak, d0, ln):
        d = first(dk, d0)
        e = first(ak, d + ln - 2) + 2
        return d, e

    slots = iter(first_slot + 55_000 * np.arange(540))
    introns = []
    for k in range(N_CAN):
        ln = (int(rng.integers(80, 400)) if k % 2 == 0 else
              int(np.exp(rng.uniform(np.log(400), np.log(50_000)))))
        introns.append(donor_acc(GT, AG, next(slots), ln) + (0,))
    for k in range(N_SEMI):
        dk, ak = (GC, AG) if k % 2 == 0 else (AT, AC)
        introns.append(donor_acc(dk, ak, next(slots),
                                 int(rng.integers(80, 3000))) + (1,))
    classified = {(GT, AG), (GC, AG), (AT, AC), (3 * 4 + 1, AC),
                  (3 * 4 + 1, GC), (GT, AT)}
    for k in range(N_NONCAN):
        d = int(next(slots))
        while True:
            e = d + int(rng.integers(80, 3000))
            if (int(dn[d]), int(dn[e - 2])) not in classified:
                break
            d += 1
        introns.append((d, e, 2))
    pairs = []
    for k in range(N_PAIRS):
        d1, e1 = donor_acc(GT, AG, next(slots), int(rng.integers(80, 400)))
        while True:
            d2 = first(GT, e1 + 20)
            if d2 <= e1 + 40:
                break
            d1, e1 = donor_acc(GT, AG, e1 + 500, int(rng.integers(80, 400)))
        e2 = first(AG, d2 + int(rng.integers(80, 400)) - 2) + 2
        pairs.append(((d1, e1), (d2, e2)))
    return introns, pairs


def simulate_spliced(np, rng, g, introns, pairs, B, L):
    """Phase 4's read mix (simulate), with a third of the reads across one
    phase-10 intron (split uniform in [8, 92], no other edit) and one in
    twelve across a pair (left exon 10-35 bp).  Returns simulate's arrays
    and per read: its junction class (-1 none, 0-2 one, 3 two), the
    intron length and the first exon's length."""
    codes, quals, lens, start, clean, rc = simulate(np, rng, g, B, L)
    jcls = np.full(B, -1, np.int8)
    jlen = np.zeros(B, np.int64)
    xsplit = np.zeros(B, np.int64)
    for i in range(B):
        if i % 3 and i % 12 != 1:
            continue
        if i % 3 == 0:
            d, e, c = introns[int(rng.integers(0, len(introns)))]
            x = int(rng.integers(8, 93))
            r = np.concatenate([g[d - x:d], g[e:e + L - x]])
            jcls[i], jlen[i] = c, e - d
        else:
            (d1, e1), (d2, e2) = pairs[int(rng.integers(0, len(pairs)))]
            x = int(rng.integers(10, 36))
            r = np.concatenate([g[d1 - x:d1], g[e1:d2], g[e2:e2 + L]])[:L]
            jcls[i], jlen[i] = 3, e1 - d1
            d = d1
        start[i] = d - x
        xsplit[i] = x
        clean[i] = False
        lens[i] = L
        if rc[i]:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        codes[i] = r
        quals[i] = rng.integers(20, 41, L)
    return codes, quals, lens, start, clean, rc, jcls, jlen, xsplit


def junction_snvs(np, rng, g, introns):
    """One catalog SNV within 10 bp of each canonical intron's junction,
    in its upstream exon: {donor d: (joined pos, alt)}."""
    out = {}
    for d, e, c in introns:
        if c == 0:
            p = d - int(rng.integers(1, 11))
            out[d] = (p, (int(g[p]) + int(rng.integers(1, 4))) % 4)
    return out


def simulate_config6(np, rng, g, introns, pairs, jsnv, B, L):
    """simulate_spliced's mix, with a fifth of the junction reads carrying
    their intron's junction SNV (jsnv); returns its arrays and which reads
    carry one."""
    b = simulate_spliced(np, rng, g, introns, pairs, B, L)
    codes, start, rc, jcls, xs = b[0], b[3], b[5], b[6], b[8]
    has = np.zeros(B, bool)
    for i in np.flatnonzero((jcls >= 0) & (jcls <= 2)):
        d = int(start[i] + xs[i])
        if d not in jsnv or rng.random() >= 0.25:
            continue
        p, alt = jsnv[d]
        off = p - int(start[i])
        if off < 0:
            continue
        if rc[i]:
            codes[i, L - 1 - off] = 3 - alt
        else:
            codes[i, off] = alt
        has[i] = True
    return b + (has,)


def spliced_phase(torch, np, g, index, kernels, twins, driver,
                  read_alignments, TorchAligner, rows, bounds, path_launches,
                  card, env):
    """Phase 10 (see the module docstring); returns its introns."""
    from hisat2_tpu_torch.ops import splice
    t0 = time.perf_counter()
    srng = np.random.default_rng(1010)
    introns, pairs = pick_introns(np, srng, g)
    sb = [simulate_spliced(np, srng, g, introns, pairs, B, L)
          for _ in range(S_BATCHES + 1)]
    sal = TorchAligner(index, device="cuda", spliced=True, lane_meta=True)
    print(f"[spliced] {len(introns)} introns ({N_CAN} GT-AG, {N_SEMI} "
          f"GC-AG / AT-AC, {N_NONCAN} non-canonical), {len(pairs)} pairs "
          f"around a 20-40 bp exon; set-up {time.perf_counter() - t0:.1f} s")

    # stage clocks on the instance (the aligner's own entry points run)
    st = {"lite": 0.0, "route": 0.0, "full": 0.0, "render": 0.0,
          "routed": 0, "subs": 0}

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def f(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                st[key] += time.perf_counter() - t
        setattr(obj, name, f)
        return fn

    o_lite = timed(sal._fast, "collect", "lite")
    o_route = timed(sal, "_route_two_pass", "route")
    o_sub = sal._dispatch_sub

    def sub_rec(codes_, quals_, lens_, rdids_, sub):
        st["routed"] += int(sub.size)
        st["subs"] += 1
        return o_sub(codes_, quals_, lens_, rdids_, sub)

    sal._dispatch_sub = sub_rec
    o_fin = sal._finish_two_pass

    def fin_rec(stage2, paired):
        t = time.perf_counter()
        try:
            return o_fin(stage2, paired)
        finally:
            st["full"] += time.perf_counter() - t

    sal._finish_two_pass = fin_rec
    names = [f"s{i}" for i in range(B)]
    acc = {"reads": 0, "can": 0, "can_true": 0, "clean": 0, "clean_true": 0,
           "two": 0, "two_true": 0}

    def emit(handle, batch):
        codes_, quals_, lens_, start_, clean_, rc_, jcls, jlen, xs = batch
        res = sal.collect(handle)
        t = time.perf_counter()
        sink = io.StringIO()
        w = driver.SamWriter(sink, index.meta.ref_names, index.meta.ref_lens,
                             no_head=True)
        w.write_batch_raw(names, codes_, quals_, lens_, res.raw,
                          sal.ref_codes,
                          finalize=lambda i: read_alignments(res.raw, i))
        st["render"] += time.perf_counter() - t
        cols = res.raw["cols"]
        rd = np.asarray(cols[0])
        first = np.unique(rd, return_index=True)[1]
        r0 = rd[first]
        ok = np.zeros(B, bool)
        jk = np.zeros(B, np.int64)
        jl = np.zeros(B, np.int64)
        ok[r0] = ((np.asarray(cols[3])[first] == start_[r0])
                  & (np.asarray(cols[1])[first] == rc_[r0]))
        jk[r0] = np.asarray(cols[16])[first]
        jl[r0] = np.asarray(cols[18])[first]
        can = (jcls == 0) & (xs >= 20) & (L - xs >= 20)
        acc["reads"] += B
        acc["can"] += int(can.sum())
        acc["can_true"] += int((can & ok & (jk == 1) & (jl == jlen)).sum())
        acc["clean"] += int(clean_.sum())
        acc["clean_true"] += int((clean_ & ok).sum())
        two = jcls == 3
        acc["two"] += int(two.sum())
        acc["two_true"] += int((two & ok & (jk == 1)).sum())

    kernels.reset_counts()
    n_merge0 = sal.splice_db.n_merges
    sal.splice_db.capture = {}
    t0 = time.perf_counter()
    pend = deque()
    for bi, b in enumerate(sb[1:]):
        rdids = bi * B + np.arange(B, dtype=np.int64)
        pend.append((sal.dispatch(*b[:3], rdids), b))
        if len(pend) >= 2:
            pend[-2] = (sal.advance(pend[-2][0]), pend[-2][1])
        if len(pend) >= DEPTH:
            emit(*pend.popleft())
    while pend:
        emit(*pend.popleft())
    t_slice = time.perf_counter() - t0
    launches = kernels.counts()
    sal._fast.collect, sal._route_two_pass = o_lite, o_route
    sal._dispatch_sub, sal._finish_two_pass = o_sub, o_fin
    nb = S_BATCHES
    merges = sal.splice_db.n_merges - n_merge0
    can_share = acc["can_true"] / acc["can"]
    clean_share = acc["clean_true"] / acc["clean"]
    lite_ms = 1e3 * st["lite"] / nb
    full_ms = 1e3 * (st["full"] - sal.fixed_point_s) / nb
    print(f"[spliced slice] {acc['reads']} reads in {t_slice:.2f} s: "
          f"{acc['reads'] / t_slice:.1f} reads/s on {card}; canonical "
          f"single-junction reads (anchors >= 20) at their true position "
          f"with the planted N {can_share:.4f} ({acc['can_true']}/"
          f"{acc['can']}); two-junction reads at their true start with a "
          f"junction {acc['two_true']}/{acc['two']}; unmodified reads at "
          f"their true position {clean_share:.4f} ({acc['clean_true']}/"
          f"{acc['clean']}); routed share {st['routed'] / acc['reads']:.4f}"
          f" in {st['subs']} pass-2 buckets; sites {sal.splice_db.n_sites};"
          f" K18 merges {merges} ({merges / nb:.2f} per batch); fixed-point "
          f"re-runs {sal.fixed_point_runs}; launches {launches}")
    print(f"[spliced slice] host ms per batch: lite collect {lite_ms:.1f}, "
          f"routing {1e3 * st['route'] / nb:.1f}, full collect (pass 2, "
          f"without re-runs) {full_ms:.1f}, fixed-point re-runs "
          f"{1e3 * sal.fixed_point_s / nb:.1f}, render "
          f"{1e3 * st['render'] / nb:.1f}")
    check(can_share >= 0.95, "canonical junction reads placed true < 95%")
    check(clean_share >= 0.99, "unmodified reads placed true < 99%")
    for name in SPLICED_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the spliced "
              f"path")
    check(launches["second_sweep"] == launches["pair_sweep"],
          f"K15 launched {launches['second_sweep']} times over "
          f"{launches['pair_sweep']} spliced full steps (one each)")
    path_launches["spliced"] = launches
    merge_kw = sal.splice_db.capture.get("merge_sites")
    check(merge_kw is not None, "no incremental site merge in the slice")

    # kernels vs plain on a whole 4096-read batch (8192 lanes), with the
    # slice's site tables (every site visible to these read ids)
    codes, quals, lens = sb[0][:3]
    minsc = sal._minsc(lens)
    uniform = bool(np.all(lens == L))
    rdids = 10 ** 7 + np.arange(B, dtype=np.int64)
    caps, k5s = {}, {}
    for tier, a in (("lite", sal._fast), ("full", sal)):
        rd_t, ss = a._step_site_args(rdids)
        cap = {}
        c0 = kernels.counts()
        a.step(*a.upload(codes, quals, lens, minsc), uniform, capture=cap,
               rdids=rd_t, ss=ss)
        caps[tier] = cap
        c1 = kernels.counts()
        k5s[tier] = c1["ref_window"] - c0["ref_window"]
        check(k5s[tier] == (1 if tier == "lite" else 2),
              f"the spliced {tier} step launched K5 {k5s[tier]} times "
              f"(its windows in one, the re-search's rc0 in another)")
        n13, n15 = (c1[k] - c0[k] for k in ("pair_sweep", "second_sweep"))
        check((n13, n15) == ((0, 0) if tier == "lite" else (1, 1)),
              f"the spliced {tier} step launched K13 {n13} and K15 {n15} "
              f"times")
    for tier in ("lite", "full"):
        step_shapes(splice, f"spliced {tier}", caps[tier], k5s[tier])
        print(f"[live] spliced {tier} "
              f"{live_text(torch, 'inject_known', caps[tier]['inject_known'])}")
    check("search_lanes_live" in caps["full"]
          and caps["full"]["search_lanes_live"]["reads"].shape[0] > 2048,
          "the full step's re-search is not in lane-list mode")
    todo = [("full", "search_lanes_live"), ("full", "pair_sweep"),
            ("full", "second_sweep"), ("full", "indel_sweep"),
            ("full", "extend_ungapped"),
            ("lite", "inject_known"),
            ("full", "inject_known"), ("full", "compact_cands"),
            ("full", "pack_slots"), ("lite", "pack_slots"),
            ("full", "ref_window"), ("full", "ref_window/rc0"),
            ("lite", "ref_window")]
    for tier, key in todo:
        name = key.split("/")[0]
        kw = caps[tier][key]
        err, ms, pms = compare(torch, key, *twins[name], kw)
        row = rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": kernels.KERNELS[name].source,
            "replaces": kernels.KERNELS[name].replaces, "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if name in SPLICED_KERNELS:
            row[f"{tier}_ms"], row[f"{tier}_plain_ms"] = ms, pms
            if tier == "full" or name not in bounds:
                bounds[name] = work(torch, name, kw, twins[name][0](**kw))
        else:
            f = f"spliced_{tier}" + key[len(name):].replace("/", "_")
            row[f + "_ms"], row[f + "_plain_ms"] = ms, pms
        print(f"[spliced kernels] {tier} {key}: equal to plain (tolerance: "
              f"exact); kernel {ms:.4f} ms, plain {pms:.4f} ms (median of "
              f"10)")
    # K14's yardstick: torch.topk over the [N, C^2] pair scores
    ps = caps["full"]["pair_sweep"]
    res, _, _ = splice.pair_sweep(**ps)
    flat = res["score"].reshape(res["score"].shape[0], -1).contiguous()
    rows["pair_sweep"]["select_topk_ms"] = median_ms(
        torch, lambda x: torch.topk(x, 4, dim=1), {"x": flat})
    # K18 on the slice's first merge, with its yardstick: the two stable
    # torch.sort passes per table set and the cumsum of the lob update
    err, ms, pms = compare(torch, "merge_sites", *twins["merge_sites"],
                           merge_kw)
    step_shapes(splice, "spliced merge", {"merge_sites": merge_kw})
    bounds["merge_sites"] = work(torch, "merge_sites", merge_kw,
                                 twins["merge_sites"][0](**merge_kw))
    from hisat2_tpu_torch.ops import sites as sites_ops
    rows["merge_sites"] = {
        "name": "merge_sites", "route": "cuda",
        "source": kernels.KERNELS["merge_sites"].source,
        "replaces": kernels.KERNELS["merge_sites"].replaces,
        "max_abs_err": err, "full_ms": ms, "full_plain_ms": pms,
        "library_ms": median_ms(torch, sites_ops.merge_sorted_tabs_plain,
                                merge_kw)}
    print(f"[spliced kernels] merge_sites on the slice's first merge "
          f"(capacity {merge_kw['kd'].shape[0]}): equal to plain; kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, library (two stable sorts + "
          f"cumsum) {rows['merge_sites']['library_ms']:.4f} ms")
    for name in SPLICED_KERNELS:
        rows[name].setdefault("library_ms", None)

    # the lite and full step on the card against the CPU step, on the
    # batch's first 1024 reads (phase 14 holds every kernel of a fused
    # 16,384-lane spliced step against its twin)
    cpu = TorchAligner(index, device="cpu", spliced=True, lane_meta=True)
    cdb = cpu.splice_db
    for k in ("sites", "_col_jl", "_col_jr", "_col_rdid"):
        setattr(cdb, k, getattr(sal.splice_db, k))
    nc = S_CMP_B
    codes, quals, lens, minsc, rdids = (codes[:nc], quals[:nc], lens[:nc],
                                        minsc[:nc], rdids[:nc])
    uniform = bool(np.all(lens == L))
    for tier in ("_fast", None):
        a = getattr(sal, tier) if tier else sal
        c = getattr(cpu, tier) if tier else cpu
        rd_a, ss_a = a._step_site_args(rdids)
        rd_c, ss_c = c._step_site_args(rdids)
        t0 = time.perf_counter()
        bk = a.step(*a.upload(codes, quals, lens, minsc), uniform,
                    rdids=rd_a, ss=ss_a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = c.step(*c.upload(codes, quals, lens, minsc), uniform,
                    rdids=rd_c, ss=ss_c)
        w = bk.shape[1]
        nm = "lite" if tier else "full"
        check(torch.equal(bk.cpu(), bp), f"spliced {nm} packed step")
        check(a._out_specs[w] == c._out_specs[w]
              and a._spill_meta[w] == c._spill_meta[w],
              f"spliced {nm} _out_specs")
        print(f"[spliced step] {nm} step, {2 * nc} lanes: packed "
              f"[{bk.shape[0]}, {w}] equal to the CPU plain step; card "
              f"{1e3 * (t1 - t0):.1f} ms (host clock), CPU "
              f"{time.perf_counter() - t1:.1f} s")
    del cpu, sal
    torch.cuda.empty_cache()

    # the CLI (spliced, the default) on the nss round trip and mj3x
    data = os.path.join(REPO, "tests/data")
    tmp = tempfile.mkdtemp(prefix="h2torch_scli_")
    try:
        for tag in ("nss", "mj3x"):
            with gzip.open(os.path.join(data, f"{tag}_genome.fa.gz"),
                           "rb") as f, \
                    open(os.path.join(tmp, f"{tag}.fa"), "wb") as o:
                o.write(f.read())
        run_clis([["build", f"{tag}.fa", tag] for tag in ("nss", "mj3x")],
                 tmp, env, 300)

        def body(path, opener=open):
            with opener(path, "rt") as f:
                return [x for x in f if not x.startswith("@")]

        # p2 reads the oracle's novel.ss, so the three runs are
        # independent: side by side
        t0 = time.perf_counter()
        run_clis([["align", "-f", "-x", "nss", "-U",
                   os.path.join(data, "nss_reads.fa"),
                   "--novel-splicesite-outfile", "novel.ss", "-S", "p1.sam",
                   "--device", "cuda"],
                  ["align", "-f", "-x", "nss", "-U",
                   os.path.join(data, "nss_reads.fa"),
                   "--novel-splicesite-infile",
                   os.path.join(data, "nss_ref_novel.ss"), "-S", "p2.sam",
                   "--device", "cuda"],
                  ["align", "-f", "-x", "mj3x", "-U",
                   os.path.join(data, "mj3x_reads.fa"), "-S", "mj3.sam",
                   "--device", "cuda"]], tmp, env, 600)
        with open(os.path.join(tmp, "novel.ss")) as f, \
                open(os.path.join(data, "nss_ref_novel.ss")) as f2:
            check(f.read() == f2.read(), "novel.ss differs from the oracle")
        check(body(os.path.join(tmp, "p1.sam")) == body(
            os.path.join(data, "nss_ref_p1.sam.gz"), gzip.open),
            "nss p1 SAM body differs from nss_ref_p1")
        check(body(os.path.join(tmp, "p2.sam")) == body(
            os.path.join(data, "nss_ref_p2.sam.gz"), gzip.open),
            "nss p2 SAM body differs from nss_ref_p2")
        got = {x.split("\t")[0]: x for x in body(os.path.join(tmp,
                                                              "mj3.sam"))}
        want = {x.split("\t")[0]: x for x in body(
            os.path.join(data, "mj3x_ref.sam.gz"), gzip.open)}
        check(all(got.get(k) == v for k, v in want.items()
                  if k != "mj3_a25"), "mj3x SAM differs from mj3x_ref")
        print(f"[spliced cli] align --device cuda (spliced): nss p1 + "
              f"novel.ss, nss p2 with --novel-splicesite-infile and mj3x "
              f"({len(want)} reads) equal to their oracles (the three "
              f"side by side {time.perf_counter() - t0:.1f} s incl. "
              f"start-up)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return introns


def true_place(np, res, start, rc, n_reads):
    """Per read: its first record's (ref_id, ref_pos) and strand equal the
    truth (start a joined position over the two GS_CHR chromosomes), its
    ref_id, and whether it aligned."""
    cols = res.raw["cols"]
    rd = np.asarray(cols[0])
    first = np.unique(rd, return_index=True)[1]
    r0 = rd[first]
    ok = np.zeros(n_reads, bool)
    ref = np.full(n_reads, -1, np.int64)
    ref[r0] = np.asarray(cols[2])[first]
    ok[r0] = ((ref[r0] == start[r0] // GS_CHR)
              & (np.asarray(cols[3])[first] == start[r0] % GS_CHR)
              & (np.asarray(cols[1])[first] == rc[r0]))
    return ok, ref, first, r0


def genome_phase(torch, np, kernels, twins, driver, read_alignments,
                 TorchAligner, rows, bounds, path_launches, card, env):
    """Phase 11 (see the module docstring): genome scale on the card."""
    from hisat2_tpu_torch.ops import splice
    from hisat2_tpu_torch.index import (FMIndex, ShardedFMIndex,
                                        attach_variants, build_fm_index)
    t_ph = time.perf_counter()
    C = GS_CHR
    t0 = time.perf_counter()
    g = np.random.default_rng(1111).integers(0, 4, 2 * C).astype(np.uint8)
    names = ("g1", "g2")
    cache = os.path.join(tempfile.gettempdir(),
                         f"hisat2_tpu_torch_genome_2x{C}_seed1111")
    if os.path.exists(cache + ".npz"):
        index = FMIndex.load(cache)
        how = "loaded from cache"
    else:
        index = build_fm_index([(names[0], g[:C]), (names[1], g[C:])],
                               shard_bp=GS_SHARD_BP)
        index.save(cache)
        how = "built"
    t_build = time.perf_counter() - t0
    check(isinstance(index, ShardedFMIndex) and len(index.shards) == 2,
          "the 280 Mbp genome is not a two-shard index")
    check(all(sh.meta.off_rate == 4 for sh in index.shards),
          "a shard is not sampled at off_rate 4")
    al = TorchAligner(index, device="cuda")
    torch.cuda.synchronize()
    nb_dev = [d.nbytes() for d in al.devs]
    print(f"[genome] 2 x {C} bp, shards at {al.shard_bases}, off_rate "
          f"{[sh.meta.off_rate for sh in index.shards]}: index {how} in "
          f"{t_build:.1f} s; device bytes per shard {nb_dev} (fused block "
          f"rows {[d.blocked.numel() * 4 for d in al.devs]})")

    def straddle(start, span=L + 8):
        return (start < C) & (start + span > C)

    srng = np.random.default_rng(1112)
    batches = [simulate(np, srng, g, B, L) for _ in range(GS_BATCHES + 1)]
    for b in batches:
        b[4][straddle(b[3])] = False           # clean: not across g1|g2

    # (a) every kernel of the path against its plain twin on the arguments
    # one step gives it: the linear step of shard 0 here, the graph steps
    # of shard 1 in (d) and the config-6 steps of shard 1 in (e).  The
    # 49-column block rows, the walk's offsets and the shard-local tables
    # are this path's own modes
    def replay(cap_, tag):
        for key, kw_ in cap_.items():
            name = key.split("/")[0]
            err, ms, pms = compare(torch, name, *twins[name], kw_)
            k = kernels.KERNELS[name]
            row = rows.setdefault(name, {
                "name": name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            f = tag + key[len(name):].replace("/", "_")
            row[f + "_ms"], row[f + "_plain_ms"] = ms, pms
            print(f"[genome kernels] {tag} {key}: equal to plain "
                  f"(tolerance: exact); kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms (median of 10)")

    codes, quals, lens, start, clean, rc = batches[0]
    minsc = al._minsc(lens)
    uniform = bool(np.all(lens == L))
    up = al.upload(codes, quals, lens, minsc)
    cap = {}
    k5 = kernels.KERNELS["ref_window"].launches
    al.step(*up, uniform, capture=cap)
    k5 = kernels.KERNELS["ref_window"].launches - k5
    want = ["fm_search2", "resolve_walk", "compact_cands", "ref_window",
            "extend_ungapped", "extend_ungapped/extra", "indel_sweep",
            "pack_slots"]
    check(sorted(cap) == sorted(want), f"genome step captured {sorted(cap)}")
    check(cap["compact_cands"]["offs"] is not None
          and cap["fm_search2"]["blocked"].shape[1] == 49,
          "the sampled step did not search the 49-column rows and resolve "
          "through the walk")
    replay(cap, "genome")
    kw = cap["resolve_walk"]
    out = twins["resolve_walk"][0](**kw)
    bounds["resolve_walk"] = work(torch, "resolve_walk", kw, out)
    nlive, M, ndist = walk_live(torch, kw)
    steps = (out[kw["live"]].long() & 15).double().mean().item()
    # the latency floor: the longest chain of dependent loads at the
    # dependent-load latency a pointer chase measures over a buffer the
    # size of the walk's table
    CHASE["ns"] = chase_ns(torch, CHASE["so"], kw["blocked"].numel() * 4)
    chain = walk_chain(torch, kw)
    r = rows["resolve_walk"]
    r["dependent_load_ns"] = CHASE["ns"]
    r["latency_floor_ms"] = chain * CHASE["ns"] * 1e-6
    print(f"[genome kernels] resolve_walk on {M} rows, {nlive} live "
          f"(share {nlive / M:.4f}, {ndist} distinct), {steps:.2f} steps per "
          f"live row; bound {bounds['resolve_walk'][0]:.4f} ms "
          f"({bounds['resolve_walk'][1]}); latency floor "
          f"{r['latency_floor_ms']:.4f} ms ({chain} dependent loads at "
          f"{CHASE['ns']:.1f} ns, a pointer chase over "
          f"{kw['blocked'].numel() * 4} bytes)")
    step_shapes(splice, "genome linear", cap, k5)
    # K19 alone: the same rows without the live mask (every row walks)
    kwd = dict(kw, live=None)
    err, ms, pms = compare(torch, "resolve_walk", *twins["resolve_walk"], kwd)
    r = rows["resolve_walk"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["dense_ms"], r["dense_plain_ms"] = ms, pms
    r["dense_bound_ms"] = work(torch, "resolve_walk", kwd,
                               twins["resolve_walk"][0](**kwd))[0]
    print(f"[genome kernels] resolve_walk without the live mask (K19 "
          f"alone, all {M} rows): equal to plain; kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms; bound "
          f"{r['dense_bound_ms']:.4f} ms")

    # (b) the linear step of both shards on the card against the CPU (a
    # 1024-read batch; the config-6 steps follow in (e))
    t0 = time.perf_counter()
    cpu = TorchAligner(index, device="cpu")
    cb = [a[:GS_CMP_B] for a in batches[0][:3]]
    cm = al._minsc(cb[2])
    cu_ = bool(np.all(cb[2] == L))
    for sh in (0, 1):
        bk = al.step(*al.upload(*cb, cm), cu_, shard=sh)
        bp = cpu.step(*cpu.upload(*cb, cm), cu_, shard=sh)
        check(torch.equal(bk.cpu(), bp), f"linear step of shard {sh}")
    del cpu
    print(f"[genome step] {GS_CMP_B}-read batches: the linear step of both "
          f"shards equal to the CPU plain steps "
          f"({time.perf_counter() - t0:.1f} s)")

    # (c) the linear slice
    rnames = [f"r{i}" for i in range(B)]
    st = {"reads": 0, "clean": 0, "true": 0, "second": 0, "aligned": 0,
          "collect": 0.0, "render": 0.0}

    def emit(aligner, handle, batch, annotate=None):
        codes_, quals_, lens_, start_, sel_, rc_ = batch[:6]
        t = time.perf_counter()
        res = aligner.collect(handle)
        t1 = time.perf_counter()
        sink = io.StringIO()
        w = driver.SamWriter(sink, index.meta.ref_names, index.meta.ref_lens,
                             no_head=True, annotator=annotate)
        w.write_batch_raw(rnames, codes_, quals_, lens_, res.raw,
                          aligner.ref_codes,
                          finalize=lambda i: read_alignments(res.raw, i))
        st["collect"] += t1 - t
        st["render"] += time.perf_counter() - t1
        ok, ref, _, r0 = true_place(np, res, start_, rc_, len(rnames))
        st["reads"] += len(rnames)
        st["aligned"] += len(r0)
        st["second"] += int((ref == 1).sum())
        st["clean"] += int(sel_.sum())
        st["true"] += int((ok & sel_).sum())
        return res

    al.align_batch(*batches[0][:3])            # warm-up
    kernels.reset_counts()
    t0 = time.perf_counter()
    pend = deque()
    for b in batches[1:]:
        pend.append((al.dispatch(*b[:3]), b))
        if len(pend) >= DEPTH:
            emit(al, *pend.popleft())
    while pend:
        emit(al, *pend.popleft())
    t_slice = time.perf_counter() - t0
    launches = kernels.counts()
    share_true = st["true"] / st["clean"]
    second = st["second"] / st["aligned"]
    nb = GS_BATCHES
    print(f"[genome slice] {st['reads']} reads in {t_slice:.2f} s: "
          f"{st['reads'] / t_slice:.1f} reads/s on {card}; aligned "
          f"{st['aligned'] / st['reads']:.4f}; on the second shard "
          f"{second:.4f}; unmodified reads at their true position "
          f"{share_true:.4f} ({st['true']}/{st['clean']}); host ms per "
          f"batch: collect (wait, merge, host phase) "
          f"{1e3 * st['collect'] / nb:.1f}, render "
          f"{1e3 * st['render'] / nb:.1f}; launches {launches}")
    check(share_true >= 0.99, "genome: unmodified reads placed true < 99%")
    check(second >= 0.30, "genome: reads placed on the second shard < 30%")
    for name in ("resolve_walk", "compact_cands"):
        check(launches[name] > 0, f"{name} never launched on the genome "
              f"path")
    path_launches["genome"] = launches
    del al
    torch.cuda.empty_cache()

    # (d) graph two-tier with a catalog at the phase-8 density; the index
    # also takes (e)'s config-6 additions: a junction SNV for each
    # canonical intron and half of those introns as baked --ss sites
    introns, pairs = [], []
    irng = np.random.default_rng(1113)
    for first in (C // 20, C + C // 20):
        i_, p_ = pick_introns(np, irng, g, first)
        introns += i_
        pairs += p_
    jsnv = junction_snvs(np, irng, g, introns)
    t0 = time.perf_counter()
    snp, ssf = cache + ".snp", cache + ".ss"
    cat = make_catalog(np, np.random.default_rng(1114), g, snp, GS_COUNTS,
                       [(names[0], 0), (names[1], C)])
    with open(snp, "a") as f:
        for k, (d, (p, alt)) in enumerate(sorted(jsnv.items())):
            f.write(f"j{k}\tsingle\t{names[p // C]}\t{p % C}\t"
                    f"{'ACGT'[alt]}\n")
    can = [(d, e) for d, e, c in introns if c == 0]
    known_ss = can[::2]
    with open(ssf, "w") as f:
        for d, e in known_ss:
            f.write(f"{names[d // C]}\t{d % C - 1}\t{e % C}\t+\n")
    attach_variants(index, snp_file=snp, ss_file=ssf)
    gal = TorchAligner(index, device="cuda", variants=index._variants)
    torch.cuda.synchronize()
    t_cat = time.perf_counter() - t0
    print(f"[genome graph] catalog {GS_COUNTS[0]} SNVs, {GS_COUNTS[1]} "
          f"deletions, {GS_COUNTS[2]} insertions over both chromosomes, "
          f"{len(jsnv)} junction SNVs and {len(known_ss)} --ss sites: "
          f"written, attached and uploaded shard by shard in {t_cat:.1f} s "
          f"(indel tables E = "
          f"{[d['ind_ip'].shape[0] for d in gal.shard_graph_dev]})")
    grng = np.random.default_rng(1115)
    gb = [simulate_graph(np, grng, g, cat, B, L)
          for _ in range(GS_G_BATCHES)]
    for b in gb:
        b[4][straddle(b[3])] = False
    # (a) continued: the graph lite and full steps of shard 1
    for tier in ("lite", "full"):
        a = gal._fast if tier == "lite" else gal
        gcap = {}
        a.step(*a.upload(*gb[0][:3], a._minsc(gb[0][2])), True,
               capture=gcap, shard=1)
        check(gcap["extend_ungapped"]["snv1_win"] is not None
              and (tier == "lite" or "inject_indels" in gcap),
              f"the genome graph {tier} step ran without its graph tables")
        replay(gcap, f"genome_graph_{tier}")
    st.update(reads=0, clean=0, true=0, second=0, aligned=0, collect=0.0,
              render=0.0)
    known = [0, 0]
    kernels.reset_counts()
    t0 = time.perf_counter()
    hs = [(gal.dispatch(*b[:3]), b) for b in gb]
    hs = [(gal.advance(h), b) for h, b in hs]
    for h, b in hs:
        res = emit(gal, h, b, gal.annotate_snps)
        cols = res.raw["cols"]
        ev = np.asarray(cols[22]) >= 0
        for sh in (0, 1):
            known[sh] += int((ev & (np.asarray(cols[2]) == sh)).sum())
    t_g = time.perf_counter() - t0
    glaunch = kernels.counts()
    snv_true = st["true"] / st["clean"]
    print(f"[genome graph] {st['reads']} reads in {t_g:.2f} s: "
          f"{st['reads'] / t_g:.1f} reads/s; SNV-only reads at their true "
          f"position {snv_true:.4f} ({st['true']}/{st['clean']}); "
          f"known-indel alignments per shard {known}; host ms per batch: "
          f"collect (pass 2 wait, merge, host phase; pass 1 ran in "
          f"advance) {1e3 * st['collect'] / GS_G_BATCHES:.1f}, render (Zs) "
          f"{1e3 * st['render'] / GS_G_BATCHES:.1f}; launches {glaunch}")
    check(snv_true >= 0.99, "genome graph: SNV-only reads placed true < 99%")
    check(min(known) > 0, "genome graph: no known-indel alignment on a "
          "shard")
    check(glaunch["resolve_walk"] > 0 and glaunch["inject_indels"] > 0,
          "genome graph: the walk or the indel injection never launched")
    path_launches["genome_graph"] = glaunch
    del gal
    torch.cuda.empty_cache()

    # (e) config 6's real mix: the graph (d)'s catalog with the junction
    # SNVs) + baked --ss sites + spliced at k = 10, in one aligner
    t0 = time.perf_counter()
    sal = TorchAligner(index, device="cuda", variants=index._variants,
                       spliced=True, k=10, lane_meta=True)
    sb = [simulate_config6(np, irng, g, introns, pairs, jsnv, B, L)
          for _ in range(GS_S_BATCHES + 1)]
    for b in sb:
        b[4][straddle(b[3])] = False
    print(f"[genome config6] spliced graph aligner (k = 10, "
          f"{sal.splice_db.n_sites} known sites from the index) set up in "
          f"{time.perf_counter() - t0:.1f} s")
    # (a) continued: the config-6 lite and full steps of shard 1
    sc = sb[0]
    for tier in ("lite", "full"):
        a = sal._fast if tier == "lite" else sal
        scap = {}
        rd_t, ss = a._step_site_args(np.arange(B), 1)
        k5 = kernels.KERNELS["ref_window"].launches
        a.step(*a.upload(sc[0], sc[1], sc[2], a._minsc(sc[2])),
               bool(np.all(sc[2] == L)), capture=scap, rdids=rd_t, ss=ss,
               shard=1)
        k5 = kernels.KERNELS["ref_window"].launches - k5
        check("resolve_walk" in scap
              and scap["inject_known"]["snv_delta1"] is not None
              and (tier == "lite" or (
                  "resolve_walk/research" in scap
                  and scap["pair_sweep"]["snv1_w"] is not None)),
              f"the config-6 {tier} step ran without the walk or its SNV "
              f"inputs")
        replay(scap, f"genome_c6_{tier}")
        step_shapes(splice, f"config6 {tier}", scap, k5)
        check(k5 == (1 if tier == "lite" else 2),
              f"the config-6 {tier} step launched K5 {k5} times")
        for key in ("inject_known", "resolve_walk", "resolve_walk/research"):
            if key in scap:
                print(f"[live] config6 {tier} "
                      f"{live_text(torch, key, scap[key])}")
        if tier == "full":
            for name in ("pair_sweep", "second_sweep", "indel_sweep",
                         "extend_ungapped", "inject_known", "inject_indels"):
                kw = scap[name]
                bounds[name + "_c6"] = work(torch, name, kw,
                                            twins[name][0](**kw))
                print(f"[genome config6] {name} at k = 10: kernel "
                      f"{rows[name]['genome_c6_full_ms']:.4f} ms on "
                      f"{kw['reads'].shape[0]} lanes, bound "
                      f"{bounds[name + '_c6'][0]:.4f} ms "
                      f"({bounds[name + '_c6'][1]})")
    # (b) continued: the config-6 lite and full step of shard 1 against
    # the CPU (a 1024-read batch)
    t0 = time.perf_counter()
    scpu = TorchAligner(index, device="cpu", variants=index._variants,
                        spliced=True, k=10, lane_meta=True)
    sc3 = [a[:GS_CMP_B] for a in sc[:3]]
    sm = sal._minsc(sc3[2])
    rdc = np.arange(GS_CMP_B)
    for tier in ("_fast", None):
        a = getattr(sal, tier) if tier else sal
        c = getattr(scpu, tier) if tier else scpu
        rd_a, ss_a = a._step_site_args(rdc, 1)
        rd_c, ss_c = c._step_site_args(rdc, 1)
        bk = a.step(*a.upload(*sc3, sm), False, rdids=rd_a, ss=ss_a, shard=1)
        bp = c.step(*c.upload(*sc3, sm), False, rdids=rd_c, ss=ss_c, shard=1)
        check(torch.equal(bk.cpu(), bp),
              f"config-6 {'lite' if tier else 'full'} step of shard 1")
    del scpu
    print(f"[genome config6] {GS_CMP_B}-read batch: the config-6 lite and "
          f"full step of shard 1 equal to the CPU plain steps "
          f"({time.perf_counter() - t0:.1f} s)")
    # the slice, with the temp-site fixed point (its K18 merges captured)
    acc = {"can": 0, "can_true": 0, "snv": 0, "snv_true": 0, "clean": 0,
           "clean_true": 0, "collect": 0.0}
    known_al = [0, 0]
    sal.splice_db.capture = {}
    kernels.reset_counts()
    t0 = time.perf_counter()
    pend = deque()
    for bi, b in enumerate(sb[1:]):
        rdids = bi * B + np.arange(B, dtype=np.int64)
        pend.append((sal.dispatch(*b[:3], rdids), b))
        if len(pend) >= 2:
            pend[-2] = (sal.advance(pend[-2][0]), pend[-2][1])
    while pend:
        h, b = pend.popleft()
        t = time.perf_counter()
        res = sal.collect(h)
        acc["collect"] += time.perf_counter() - t
        start_, clean_, rc_, jcls, jlen, xs, jsnv_ = b[3:10]
        ok, _, first, r0 = true_place(np, res, start_, rc_, B)
        cols = res.raw["cols"]
        jk = np.zeros(B, np.int64)
        jl = np.zeros(B, np.int64)
        jk[r0] = np.asarray(cols[16])[first]
        jl[r0] = np.asarray(cols[18])[first]
        can = (jcls == 0) & (xs >= 20) & (L - xs >= 20)
        good = can & ok & (jk == 1) & (jl == jlen)
        acc["can"] += int(can.sum())
        acc["can_true"] += int(good.sum())
        acc["snv"] += int((can & jsnv_).sum())
        acc["snv_true"] += int((good & jsnv_).sum())
        acc["clean"] += int(clean_.sum())
        acc["clean_true"] += int((clean_ & ok).sum())
        kn = (np.asarray(cols[16]) == 1) & (np.asarray(cols[21]) != 0)
        for sh in (0, 1):
            known_al[sh] += int((kn & (np.asarray(cols[2]) == sh)).sum())
    t_s = time.perf_counter() - t0
    slaunch = kernels.counts()
    can_share = acc["can_true"] / acc["can"]
    clean_share = acc["clean_true"] / acc["clean"]
    print(f"[genome config6] {GS_S_BATCHES * B} reads in {t_s:.2f} s: "
          f"{GS_S_BATCHES * B / t_s:.1f} reads/s (no render); {len(introns)}"
          f" introns ({len(known_ss)} baked as known sites) and {len(pairs)} "
          f"pairs on both chromosomes; canonical single-junction reads at "
          f"their true position with the planted N {can_share:.4f} "
          f"({acc['can_true']}/{acc['can']}), of them carrying a junction "
          f"SNV {acc['snv_true']}/{acc['snv']}; unmodified reads "
          f"{clean_share:.4f} ({acc['clean_true']}/{acc['clean']}); "
          f"alignments through known sites per shard {known_al}; sites "
          f"{sal.splice_db.n_sites}; fixed-point re-runs "
          f"{sal.fixed_point_runs}; host ms per batch: collect (pass 2, "
          f"merge, host phases, re-runs) "
          f"{1e3 * acc['collect'] / GS_S_BATCHES:.1f}; launches {slaunch}")
    check(can_share >= 0.95, "config 6: canonical junction reads placed "
          "true < 95%")
    check(clean_share >= 0.99, "config 6: unmodified reads placed true "
          "< 99%")
    check(acc["snv"] > 0, "config 6: no junction read carries an SNV")
    check(min(known_al) > 0, "config 6: no alignment through a known site "
          "on a shard")
    for name in ("resolve_walk", "pair_sweep", "inject_known",
                 "second_sweep", "inject_indels"):
        check(slaunch[name] > 0, f"config 6: {name} never launched")
    check(slaunch["second_sweep"] == slaunch["pair_sweep"],
          f"config 6: K15 launched {slaunch['second_sweep']} times over "
          f"{slaunch['pair_sweep']} spliced full steps (one each)")
    path_launches["genome_spliced"] = slaunch
    # K18 on each of the slice's incremental merges, against its twin
    merges = sal.splice_db.capture.get("merge_sites/all", [])
    sal.splice_db.capture = None
    for i, mkw in enumerate(merges):
        err, ms, pms = compare(torch, "merge_sites", *twins["merge_sites"],
                               mkw)
        rows["merge_sites"]["max_abs_err"] = max(
            rows["merge_sites"]["max_abs_err"], err)
        print(f"[genome config6] merge_sites on the slice's merge {i} "
              f"(capacity {mkw['kd'].shape[0]}): equal to plain (tolerance: "
              f"exact); kernel {ms:.4f} ms, plain {pms:.4f} ms (median of "
              f"10)")
        step_shapes(splice, f"config6 merge {i}", {"merge_sites": mkw})
    print(f"[genome config6] {len(merges)} incremental K18 merges in the "
          f"slice ({slaunch['merge_sites']} launches)")
    # the device's busy share of one more batch through the same entry
    # points, under torch.profiler (kernel time summed over the batch's
    # wall clock; the profiler's own overhead lengthens the wall)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    b = sb[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sal.collect(sal.advance(sal.dispatch(
            *b[:3], GS_S_BATCHES * B + np.arange(B, dtype=np.int64))))
        wall = time.perf_counter() - t
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    print(f"[genome config6] one batch under torch.profiler: wall "
          f"{1e3 * wall:.1f} ms, device kernel time {1e3 * busy:.1f} ms: "
          f"busy share {busy / wall:.4f}" if busy > 0 else
          "[genome config6] torch.profiler recorded no device time: the "
          "busy share is not measured")
    del sal
    index._variants = None
    torch.cuda.empty_cache()

    # (f) the CLI on the saved two-shard index
    tmp = tempfile.mkdtemp(prefix="h2torch_gcli_")
    try:
        codes, _, lens, start, _, rc = simulate(
            np, np.random.default_rng(1116), g, B, L)
        keep = ~straddle(start)
        with open(os.path.join(tmp, "r.fa"), "w") as f:
            for i in np.flatnonzero(keep):
                seq = g[start[i]:start[i] + L]
                f.write(f">t{i}\n{''.join('ACGT'[c] for c in seq)}\n")
        t0 = time.perf_counter()
        run_cli(["align", "--no-spliced-alignment", "-f", "-x", cache, "-U",
                 "r.fa", "-S", "out.sam", "--device", "cuda"], tmp, env, 600)
        t_cli = time.perf_counter() - t0
        with open(os.path.join(tmp, "out.sam")) as f:
            lines = f.readlines()
        sq = [x.split() for x in lines if x.startswith("@SQ")]
        check(sq == [["@SQ", f"SN:{n}", f"LN:{C}"] for n in names],
              f"genome CLI header {sq}")
        seen, good = set(), 0
        for x in lines:
            if x.startswith("@"):
                continue
            p = x.split("\t")
            i = int(p[0][1:])
            if i in seen:
                continue
            seen.add(i)
            good += (p[2] == names[start[i] // C]
                     and int(p[3]) - 1 == start[i] % C)
        n_reads = int(keep.sum())
        print(f"[genome cli] align --device cuda --no-spliced-alignment on "
              f"the saved two-shard index: header lists {sq}; {good}/"
              f"{n_reads} unmodified reads at their true position "
              f"({t_cli:.1f} s incl. start-up and index load)")
        check(good >= 0.99 * n_reads, "genome CLI: reads placed true < 99%")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[genome] phase 11 took {time.perf_counter() - t_ph:.1f} s")


def multi_phase(torch, np, index, batch, TorchAligner, build_fm_index,
                rows, path_launches, env):
    """Phase 12 (see the module docstring): several devices and hosts."""
    import socket

    import torch.distributed as dist

    from hisat2_tpu_torch.parallel import mesh
    t_ph = time.perf_counter()
    # (a) K21 at world 1 on NCCL
    al = TorchAligner(index, device="cuda")
    codes, quals, lens = batch[:3]
    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda().to(torch.int32)
         for a in (codes, quals, lens, al._minsc(lens),
                   np.arange(len(lens)))]
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        bundle = mesh.replicate(al, "cuda:0")
        step = mesh.sharded_align_step(al, None)
        step(bundle, *t)                       # warm-up
        torch.cuda.synchronize()
        mesh.launches = 0
        out, n_cand = step(bundle, *t)
        torch.cuda.synchronize()
        k21_launches = mesh.launches
        plain, _ = al._align_device(al.dev, al.shard_graph_dev[0], *t[:4],
                                    False, True, rdids=t[4])
        check(sorted(out) == sorted(plain), "K21: output keys")
        for k in plain:
            check(torch.equal(out[k], plain[k]), f"K21: {k} differs from "
                  f"the single-device step")
        want = int((plain["u_flags"] & 1).sum())
        check(int(n_cand) == want, "K21: n_cand != the valid-slot count")
        glob = mesh.gather_lanes(out, None)
        check(all(np.array_equal(glob[k], plain[k].cpu().numpy())
                  for k in plain), "K21: gather_lanes at world 1")
        flags = out["u_flags"]

        def collective(flags):
            n = (flags & 1).sum().to(torch.int64).reshape(1)
            dist.all_reduce(n)
            return n

        def local(flags):
            return (flags & 1).sum().to(torch.int64).reshape(1)

        one = torch.ones(1, dtype=torch.int64, device="cuda")
        ms = median_ms(torch, collective, {"flags": flags})
        plain_ms = median_ms(torch, local, {"flags": flags})
        ar_ms = median_ms(torch, lambda x: dist.all_reduce(x), {"x": one})
        step_ms = median_ms(torch, lambda: step(bundle, *t), {})
        single_ms = median_ms(torch, lambda: al._align_device(
            al.dev, al.shard_graph_dev[0], *t[:4], False, True,
            rdids=t[4]), {})
    finally:
        dist.destroy_process_group()
    by = flags.numel() * flags.element_size() + 8
    rows["sharded_align_step"] = {
        "name": "sharded_align_step", "route": "cuda",
        "source": "hisat2_tpu_torch/parallel/mesh.py",
        "replaces": "hisat2_tpu/parallel/mesh.py:53 sharded_align_step "
                    "(the psum of (u_flags & 1), :65-66)",
        "launches": k21_launches, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": by / HBM * 1e3,
        "bound_by": "bytes", "library_ms": ar_ms, "step_ms": step_ms,
        "single_step_ms": single_ms, "n_cand": want}
    path_launches["multi"] = {"sharded_align_step": k21_launches}
    print(f"[multi] K21 at world 1 (NCCL, cuda:0) on a {len(lens)}-read "
          f"batch: outputs equal to the single-device step's, n_cand "
          f"{want}; the sum + all-reduce {ms:.4f} ms (the sum alone "
          f"{plain_ms:.4f}, the all-reduce of one int64 {ar_ms:.4f}); the "
          f"sharded step {step_ms:.4f} ms, the single-device step "
          f"{single_ms:.4f} ms (CUDA events, median of 10)")
    del al
    torch.cuda.empty_cache()

    # (b) MPMD: shards on ["cuda:0", "cpu"] and on ["cuda:0", "cuda:0"]
    t0 = time.perf_counter()
    data = os.path.join(REPO, "tests", "data")
    chroms, name = [], None
    with gzip.open(os.path.join(data, "shard_genome.fa.gz"), "rt") as f:
        for line in f:
            if line.startswith(">"):
                chroms.append((line[1:].strip(), []))
            else:
                chroms[-1][1].append(line.strip())
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = i
    chroms = [(n, lut[np.frombuffer("".join(v).encode(), np.uint8)])
              for n, v in chroms]
    sidx = build_fm_index(chroms, shard_bp=150_000, off_rate=4)
    check(len(sidx.shards) == 2, "the shard corpus is not two shards")
    gj = np.concatenate([c for _, c in chroms])
    sr = simulate(np, np.random.default_rng(1201), gj, 256, L)
    res = []
    for place in (["cuda:0", "cpu"], ["cuda:0", "cuda:0"]):
        a = TorchAligner(sidx, device="cuda", shard_devices=place)
        check([str(d.device) for d in a.devs] == place,
              f"shards not placed on {place}")
        res.append(a.align_batch(*sr[:3]).raw["cols"])
    for x, y in zip(*res):
        check(np.array_equal(np.asarray(x), np.asarray(y)),
              "MPMD: the mixed placement differs from the all-card one")
    n_al = len(np.unique(np.asarray(res[0][0])))
    print(f"[multi] MPMD on the shard corpus's two-shard index (off_rate "
          f"4): shards on [cuda:0, cpu] and on [cuda:0, cuda:0] give equal "
          f"alignments ({n_al}/256 reads aligned; "
          f"{time.perf_counter() - t0:.1f} s)")

    # (c) two CLI hosts on the card, the single-host run and the dry-run
    # twin at world 1, all at once
    tmp = tempfile.mkdtemp(prefix="h2torch_multi_")
    try:
        with gzip.open(os.path.join(data, "mm3_genome.fa.gz"), "rb") as f, \
                open(os.path.join(tmp, "g.fa"), "wb") as o:
            o.write(f.read())
        run_cli(["build", "g.fa", "idx"], tmp, env, 300)
        base = [sys.executable, "-m", "hisat2_tpu_torch", "align",
                "--no-spliced-alignment", "-f", "-x", "idx", "-U",
                os.path.join(data, "mm3_reads.fa"), "-k", "10",
                "--batch-size", "8", "--device", "cuda"]
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        cmds = [base + ["-S", "single.sam"]] + [
            base + ["--n-hosts", "2", "--host-rank", str(r), "-S",
                    "multi.sam"] for r in (0, 1)] + [
            [sys.executable, "-m", "hisat2_tpu_torch.parallel.dryrun",
             "--world", "1", "--rank", "0", "--store",
             os.path.join(tmp, f"store{port}"), "--device", "cuda"]]
        procs = [subprocess.Popen(c, cwd=tmp, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE) for c in cmds]
        outs = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=300)
                check(p.returncode == 0, f"multi CLI {p.args[3:6]} failed: "
                      f"{e[-2000:]}")
                outs.append(o)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        t_cli = time.perf_counter() - t0

        def body(path, opener=open):
            with opener(path, "rt") as f:
                return [x for x in f if not x.startswith("@")]

        multi = body(os.path.join(tmp, "multi.sam"))
        check(multi == body(os.path.join(tmp, "single.sam")),
              "multi-host SAM body differs from the single-host run")
        check(multi == body(os.path.join(data, "mm3_ref_k10.sam.gz"),
                            gzip.open),
              "multi-host SAM body differs from mm3_ref_k10")
        check("8/8 aligned" in outs[3], "the dry-run twin at world 1")
        print(f"[multi] align --device cuda --n-hosts 2 as two processes on "
              f"the card: merged body of {len(multi)} records equal to the "
              f"single-host run and mm3_ref_k10; {outs[3].strip()} "
              f"({t_cli:.1f} s for the four processes)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[multi] phase 12 took {time.perf_counter() - t_ph:.1f} s")


def long_phase(torch, np, g, index, spots, kernels, driver, TorchAligner):
    """Phase 13: reads above the kernels' former caps, on the linear index:
    a 128-read batch whose longest read is LONG_L bp (the rest 100-300 bp)
    through the step on the card and on the CPU (both layouts), and 64
    pairs (one of LONG_L bp mates; a quarter with mate 1 at the end of a
    planted repeat copy and mate 2 past it, so that mate 1 needs the
    rescue) through align/driver.py's paired batch on both: packed
    buffers and SAM equal, rescue jobs at the batch's width, and K1,
    K6+K7, K8 and K12 launched at that width."""
    from hisat2_tpu_torch.align.paired import PairPolicy
    from hisat2_tpu_torch.io.fasta import ReadBatch
    rng = np.random.default_rng(LONG_L)
    n = len(g)
    cu = TorchAligner(index, device="cuda")
    cp = TorchAligner(index, device="cpu")

    def read(s, ln, rc):
        r = g[s:s + ln].copy()
        p = rng.integers(0, ln, 2)
        r[p] = (r[p] + 1) % 4
        return (3 - r)[::-1].copy() if rc else r

    B = 128
    lens = rng.integers(100, 301, B).astype(np.int32)
    lens[0] = LONG_L
    codes = np.full((B, LONG_L), 4, np.uint8)
    for i in range(B):
        codes[i, :lens[i]] = read(int(rng.integers(0, n - LONG_L)),
                                  int(lens[i]), i % 2)
    quals = rng.integers(20, 41, (B, LONG_L)).astype(np.uint8)
    minsc = cu._minsc(lens)
    kernels.reset_counts()
    for full in (False, True):
        t0 = time.perf_counter()
        lcap = {}
        bk = cu.step(*cu.upload(codes, quals, lens, minsc), False, full,
                     capture=lcap)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = cp.step(*cp.upload(codes, quals, lens, minsc), False, full)
        check(torch.equal(bk.cpu(), bp), f"long-read step full_out={full}")
        hold_slots(torch, f"long step full_out={full}", lcap)
        print(f"[long] step, {B} reads up to {LONG_L} bp, full_out={full}: "
              f"packed [{bk.shape[0]}, {bk.shape[1]}] equal to the CPU "
              f"plain step; card {1e3 * (t1 - t0):.1f} ms (host clock), "
              f"CPU {time.perf_counter() - t1:.1f} s")
    m1, m2, q1, q2 = [], [], [], []
    P = 64
    for i in range(P):
        ln = LONG_L if i == 0 else int(rng.integers(100, 301))
        if i % 4 == 3:
            at = spots[i % REP_UNITS][int(rng.integers(0, REP_COPIES))]
            a, b = read(at + 20, 100, False), read(at + 170, ln, True)
        else:
            s = int(rng.integers(0, n - 3 * LONG_L))
            e = s + ln + int(rng.integers(20, 200))
            a, b = read(s, ln, False), read(e - ln, ln, True)
        m1.append(a)
        m2.append(b)
        q1.append(rng.integers(20, 41, len(a)).astype(np.uint8))
        q2.append(rng.integers(20, 41, len(b)).astype(np.uint8))
    names = [f"l{i}" for i in range(P)]
    sam, jobs = [], []
    for al in (cu, cp):
        orig = al.rescue_mates
        al.rescue_mates = lambda c_, *a, **k: (jobs.append(c_.shape),
                                               orig(c_, *a, **k))[1]
        sink = io.StringIO()
        driver._align_pair_batch(
            al, driver.SamWriter(sink, list(index.meta.ref_names),
                                 index.meta.ref_lens, no_head=True),
            PairPolicy(), al.scoring, 5, ReadBatch(names, m1, q1),
            ReadBatch(list(names), m2, q2),
            lambda pos, span, al_=al: al_.ref_codes[pos:pos + span],
            np.arange(P, dtype=np.int64))
        del al.rescue_mates
        sam.append(sink.getvalue())
    launches = kernels.counts()
    check(sam[0] == sam[1], "long-read pairs: card SAM != CPU SAM")
    check(jobs and all(j[1] == LONG_L for j in jobs),
          f"long-read pairs: rescue jobs {jobs}")
    for name in ("fm_search2", "extend_ungapped", "indel_sweep",
                 "rescue_window"):
        check(launches[name] > 0, f"{name} never launched on long reads")
    print(f"[long] {P} pairs (mates up to {LONG_L} bp) through the paired "
          f"batch with mate rescue: {sam[0].count(chr(10))} SAM records "
          f"equal to the CPU's; rescue job shapes {jobs}; card launches "
          f"{launches}")
    spliced_long(torch, np, g, index, kernels, TorchAligner, rng, read)


def spliced_long(torch, np, g, index, kernels, TorchAligner, rng, read):
    """Phase 13's spliced batch: 64 reads, the longest SPLICED_LONG_L bp
    (the rest 100-300), half across phase 10's introns, through
    dispatch/advance/collect on the card; then the lite and full steps on
    the card against the CPU's with the card's site DB; K13 and K15 on
    the full step against their twins (planes in shared memory); the
    batch again with its longest read at SPLICED_GLOBAL_L bp, where both
    stage their planes in global memory (sweeps_global); their launches
    at 600 bp and at config 6's C = 19 with SNV windows at L = 500."""
    from hisat2_tpu_torch.ops import splice
    introns, _ = pick_introns(np, np.random.default_rng(1010), g)
    Ls, Bs = SPLICED_LONG_L, 64
    lens = rng.integers(100, 301, Bs).astype(np.int32)
    lens[0] = Ls
    codes = np.full((Bs, Ls), 4, np.uint8)
    for i in range(Bs):
        n_ = int(lens[i])
        if i % 2 == 0:
            d, e, _ = introns[int(rng.integers(0, len(introns)))]
            x = int(rng.integers(20, n_ - 20))
            r = np.concatenate([g[d - x:d], g[e:e + n_ - x]])
            codes[i, :n_] = np.where(r < 4, 3 - r, 4)[::-1] if i % 4 else r
        else:
            codes[i, :n_] = read(int(rng.integers(0, len(g) - Ls)), n_,
                                 i % 4 == 1)
    quals = rng.integers(20, 41, (Bs, Ls)).astype(np.uint8)
    rdids = np.arange(Bs, dtype=np.int64)
    scu = TorchAligner(index, device="cuda", spliced=True, lane_meta=True)
    scp = TorchAligner(index, device="cpu", spliced=True, lane_meta=True)
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = scu.collect(scu.advance(scu.dispatch(codes, quals, lens, rdids)))
    t1 = time.perf_counter()
    launches = kernels.counts()
    for name in ("pair_sweep", "second_sweep", "inject_known"):
        check(launches[name] > 0, f"{name} never launched on a spliced "
              f"batch of {Ls} bp")
    cols = res.raw["cols"]
    rd = np.asarray(cols[0])
    first = np.unique(rd, return_index=True)[1]
    spliced = int((np.asarray(cols[16])[first] == 1).sum())
    check(spliced > 0, "spliced long batch: no spliced alignment")
    print(f"[long] spliced batch, {Bs} reads up to {Ls} bp through "
          f"dispatch/advance/collect: {len(first)} reads aligned, {spliced} "
          f"spliced, {1e3 * (t1 - t0):.1f} ms (host clock); launches "
          f"{launches}")
    for k in ("sites", "_col_jl", "_col_jr", "_col_rdid"):
        setattr(scp.splice_db, k, getattr(scu.splice_db, k))
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    for a, c in ((scu._fast, scp._fast), (scu, scp)):
        rd_, ss = a._step_site_args(rdids)
        rdc, ssc = c._step_site_args(rdids)
        minsc = a._minsc(lens)
        cap = {}
        k5 = kernels.KERNELS["ref_window"].launches
        bk = a.step(*a.upload(codes, quals, lens, minsc), False, rdids=rd_,
                    ss=ss, capture=cap)
        k5 = kernels.KERNELS["ref_window"].launches - k5
        t2 = time.perf_counter()
        bp = c.step(*c.upload(codes, quals, lens, minsc), False, rdids=rdc,
                    ss=ssc)
        check(torch.equal(bk.cpu(), bp),
              f"spliced long step lite={a.lite} != CPU step")
        hold_slots(torch, f"long spliced {'lite' if a.lite else 'full'}",
                   cap)
        err, ms, pms = compare(torch, "inject_known", *twins["inject_known"],
                               cap["inject_known"])
        print(f"[long] inject_known on the spliced "
              f"{'lite' if a.lite else 'full'} step at {Ls} bp: equal to "
              f"plain (tolerance: exact); kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms; "
              f"{live_text(torch, 'inject_known', cap['inject_known'])}")
        print(f"[long] spliced {'lite' if a.lite else 'full'} step at {Ls} "
              f"bp: packed [{bk.shape[0]}, {bk.shape[1]}] equal to the CPU "
              f"plain step (CPU {time.perf_counter() - t2:.1f} s)")
        step_shapes(splice, f"spliced long {'lite' if a.lite else 'full'}",
                    cap, k5)
    # K13 and K15 on this full step, their planes in shared memory
    for name in ("pair_sweep", "second_sweep"):
        check(splice.sweep_launch_info(**sweep_shape(splice, name, cap[
            name]))["scratch_per_block"] == 0, f"{name} at {Ls} bp: "
            "planes not in shared memory")
        _, ms, pms = compare(torch, name, *twins[name], cap[name])
        print(f"[long] {name} on the spliced full step at {Ls} bp, planes "
              f"in shared memory: equal to plain (tolerance: exact); kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms (median of 10)")
    sweeps_global(torch, np, g, twins, splice, scu, introns, rng, codes,
                  quals, lens, rdids)
    LP = splice.lenpen_device(splice.SpliceParams(), "cpu")[1].shape[1]
    for name in ("pair_sweep", "second_sweep"):
        for Lx, snv in ((Ls, False), (500, True), (500, False)):
            info = splice.sweep_launch_info(name, 19, Lx, Lx + 32, LP,
                                            snv and name == "pair_sweep")
            check(info["blocks_per_sm"] >= 1, f"{name}: C = 19, L = {Lx} "
                  f"does not fit an SM")
            print(f"[long] {name} launch at C = 19, L = {Lx}"
                  f"{', SNV windows' if snv else ''} (margin 16): "
                  f"{shape_text(info)}")


def sweep_shape(splice, name, kw):
    """sweep_launch_info's arguments for K13's or K15's captured call."""
    N, C, W = kw["ch"].shape
    snv = name == "pair_sweep" and kw.get("snv1_w") is not None
    return dict(name=name, C=C, L=kw["reads"].shape[1], W=W,
                LP=kw["lenpen"][1].shape[1], snv=snv)


# K13's and K15's arguments with a row per lane, and K15's base pairs
# ([2, N]: a column per lane)
SWEEP_LANE_ARGS = ("ch", "reads", "quals", "lens", "starts", "valid",
                   "minsc", "snv1_w", "snv2_w", "rdids")
SWEEP_PAIR_ARGS = ("b_i", "b_j", "b_x", "b_score", "b_valid")


def tile_lanes(kw, idx):
    """A sweep's captured arguments over the lanes `idx` (a device index
    tensor, lanes repeated in any order)."""
    out = dict(kw)
    for k in SWEEP_LANE_ARGS:
        if out.get(k) is not None:
            out[k] = out[k][idx].contiguous()
    for k in SWEEP_PAIR_ARGS:
        if k in out:
            out[k] = out[k][:, idx].contiguous()
    return out


def sweeps_global(torch, np, g, twins, splice, scu, introns, rng, codes,
                  quals, lens, rdids):
    """The spliced full step of phase 13's batch with its first read
    lengthened to SPLICED_GLOBAL_L bp (across a junction, as before), on
    the card: K13's and K15's planes outgrow a block's shared memory
    there, so both take their global instantiation.  Each is held against
    its twin on the step's lanes (timed), then run on those lanes tiled,
    in a seeded order, to three times the grid the card holds and more, so
    that every block of the global grid walks 3-4 lanes through its one
    scratch slice: each tiled lane's outputs must equal its row of the
    first run (every output has a row per lane)."""
    Lg, Bs = SPLICED_GLOBAL_L, len(lens)
    c2 = np.full((Bs, Lg), 4, np.uint8)
    c2[:, :codes.shape[1]] = codes
    q2 = rng.integers(20, 41, (Bs, Lg)).astype(np.uint8)
    q2[:, :quals.shape[1]] = quals
    d, e, _ = introns[int(rng.integers(0, len(introns)))]
    x = int(rng.integers(20, Lg - 20))
    c2[0] = np.concatenate([g[d - x:d], g[e:e + Lg - x]])
    l2 = lens.copy()
    l2[0] = Lg
    rd_, ss = scu._step_site_args(rdids)
    cap = {}
    scu.step(*scu.upload(c2, q2, l2, scu._minsc(l2)), False, rdids=rd_,
             ss=ss, capture=cap)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("pair_sweep", "second_sweep"):
        kw = cap[name]
        info = splice.sweep_launch_info(**sweep_shape(splice, name, kw))
        check(info["scratch_per_block"] > 0, f"{name} at {Lg} bp: planes "
              "not in global memory")
        _, ms, pms = compare(torch, name, *twins[name], kw)
        N = kw["ch"].shape[0]
        grid = sms * info["blocks_per_sm"]
        nt = 3 * grid + 7
        idx = torch.from_numpy(np.random.default_rng(nt).integers(
            0, N, nt)).cuda()
        kern = twins[name][0]
        whole = flat_outputs(kern(**kw))
        tiled = flat_outputs(kern(**tile_lanes(kw, idx)))
        check(all(torch.equal(a[idx], b) for a, b in zip(whole, tiled)),
              f"{name}: lanes tiled over the global grid != their rows")
        print(f"[long] {name} on the spliced full step at {Lg} bp, planes "
              f"in global scratch ({info['scratch_per_block']} bytes a "
              f"block): equal to plain (tolerance: exact); kernel {ms:.4f} "
              f"ms, plain {pms:.4f} ms (median of 10); its {N} lanes tiled "
              f"to {nt} over a grid of {grid} blocks: equal rows")


def simulate_spliced_pairs(np, rng, g, introns, n_can, spots, B, L):
    """B read pairs, --fr, fragments of 200-500 bp on the transcript, as
    phase 9 on a linear index: 5% with the left mate in a planted repeat
    copy, 2% with a right mate of random sequence; of the pairs a third
    with one mate (left or right at random; it is mate 1) across one of
    the first n_can canonical phase-10 introns (first exon x in [8, 92]
    bp, no other edit), a tenth whose fragment spans such an intron (the
    mates wholly on its two exons), the others genomic, a fifth of all
    pairs (genomic ones) with 1-3 mismatches on each mate as phase 9's;
    the other pairs half from the reverse strand (mate 1 is then the right
    mate).  A run that widens n_can batch by batch finds new junctions in
    each, as a growing RNA-seq run does; with the junction mate as mate
    1, the first read to find a site has the lowest read id of its batch
    (the fused batch repeats the read ids for mate 2), so the site tables
    grow by K18's incremental merge, not by a rebuild.  Returns mate codes
    and quals (uint8 [B, L]), per mate its true leftmost position, the
    length of the intron it crosses (0: none) and the bases it has before
    the junction, and which pairs have no repeat or random mate."""
    n = len(g)
    can = [(d, e) for d, e, c in introns if c == 0][:n_can]
    left = np.zeros((B, L), np.uint8)
    right = np.zeros((B, L), np.uint8)
    lpos, rpos = np.zeros(B, np.int64), np.zeros(B, np.int64)
    ljl, rjl = np.zeros(B, np.int64), np.zeros(B, np.int64)
    lx, rx = np.zeros(B, np.int64), np.zeros(B, np.int64)
    r = rng.random(B)
    rep, rnd = r < 0.05, (r >= 0.05) & (r < 0.07)
    plain = ~rep & ~rnd
    u = rng.random(B)
    F = rng.integers(200, 501, B)
    fw = rng.random(B) < 0.5
    E = 600                      # transcript flank on each side
    for i in range(B):
        f = int(F[i])
        if plain[i] and u[i] < 0.1 + 1 / 3:
            d, e = can[int(rng.integers(0, len(can)))]
            t = np.concatenate([g[d - E:d], g[e:e + E]])
            if u[i] < 1 / 3:                        # one junction mate
                x = int(rng.integers(8, 93))
                fw[i] = rng.random() < 0.5
                if fw[i]:                           # the left mate
                    f0 = E - x
                    lpos[i], ljl[i], lx[i] = d - x, e - d, x
                    rpos[i] = e + f0 + f - L - E
                else:                               # the right mate
                    f0 = E - x - f + L
                    lpos[i] = d - E + f0
                    rpos[i], rjl[i], rx[i] = d - x, e - d, x
            else:                                   # spans the intron
                a = int(rng.integers(L, f - L + 1))
                f0 = E - a
                lpos[i], rpos[i] = d - a, e + f - L - a
            left[i] = t[f0:f0 + L]
            right[i] = t[f0 + f - L:f0 + f]
            continue
        if rep[i]:
            s = int(np.asarray(spots)[rng.integers(0, REP_UNITS),
                                      rng.integers(0, REP_COPIES)]) + 10
        else:
            s = int(rng.integers(0, n - 700))
        left[i] = g[s:s + L]
        right[i] = g[s + f - L:s + f]
        lpos[i], rpos[i] = s, s + f - L
    right = (3 - right)[:, ::-1]
    right[rnd] = rng.integers(0, 4, (int(rnd.sum()), L))
    errs = plain & (u > 0.8)
    for m in (left, right):
        for k in range(3):
            sel = errs & (rng.random(B) < 0.7 if k else True)
            rr = np.flatnonzero(sel)
            p = rng.integers(0, L, len(rr))
            m[rr, p] = (m[rr, p] + rng.integers(1, 4, len(rr))) % 4
    m1 = np.where(fw[:, None], left, right).astype(np.uint8)
    m2 = np.where(fw[:, None], right, left).astype(np.uint8)
    q1, q2 = (rng.integers(20, 41, (B, L)).astype(np.uint8) for _ in (0, 1))
    pick = lambda a, b: (np.where(fw, a, b), np.where(fw, b, a))  # noqa
    return (m1, m2, q1, q2) + pick(lpos, rpos) + pick(ljl, rjl) \
        + pick(lx, rx) + (plain,)


def simulate_genome_pairs(np, rng, g, B, L):
    """B read pairs, --fr, fragments of 200-500 bp over the two GS_CHR
    chromosomes (none across their border), half from the reverse strand,
    a fifth with 1-3 mismatches on the left mate and 2% with a right mate
    of random sequence.  Returns mate codes and quals, each mate's true
    leftmost joined position, and which pairs have no random mate."""
    F = rng.integers(200, 501, B)
    s = rng.integers(0, 2 * GS_CHR - 700, B)
    cross = (s < GS_CHR) & (s + 700 > GS_CHR)
    s[cross] -= 1000
    left = g[s[:, None] + np.arange(L)].astype(np.uint8)
    rs = s + F - L
    right = (3 - g[rs[:, None] + np.arange(L)])[:, ::-1].astype(np.uint8)
    err = rng.random(B) < 0.2
    for i in np.flatnonzero(err):
        q = rng.choice(L, int(rng.integers(1, 4)), replace=False)
        left[i, q] = (left[i, q] + rng.integers(1, 4, len(q))) % 4
    rnd = rng.random(B) < 0.02
    right[rnd] = rng.integers(0, 4, (int(rnd.sum()), L))
    fw = rng.random(B) < 0.5
    m1 = np.where(fw[:, None], left, right)
    m2 = np.where(fw[:, None], right, left)
    q1, q2 = (rng.integers(20, 41, (B, L)).astype(np.uint8) for _ in (0, 1))
    return (m1, m2, q1, q2, np.where(fw, s, rs), np.where(fw, rs, s), ~rnd)


def primaries(text):
    """{(pair index, mate 1/2): (flag, 0-based pos, CIGAR, RNAME)} of the
    primary records of a paired SAM body whose names end in _<index>."""
    prim = {}
    for line in text.splitlines():
        f = line.split("\t", 6)
        flag = int(f[1])
        if flag & 256:
            continue
        prim[(int(f[0].rsplit("_", 1)[1]), 1 if flag & 64 else 2)] = (
            flag, int(f[3]) - 1, f[5], f[2])
    return prim


class PairRun:
    """The paired main path on one aligner: run_align's loop of
    _dispatch_pair_batch / advance / _align_pair_batch, 3 deep, SAM to
    memory, with the host clock of each stage (collect, rescue, render)
    and the rescue jobs.  Read ids run on across runs, as run_align's do
    across batches (a temp splice site keeps the lowest read id that
    found it, and a lower one rebuilds the site tables)."""

    def __init__(self, np, driver, al, policy, k, ref_names, ref_lens,
                 annotate=None):
        self.np, self.driver, self.al = np, driver, al
        self.policy, self.k, self.annotate = policy, k, annotate
        self.names, self.lens = list(ref_names), ref_lens
        self.rdid0 = 0
        self.reset()

    def reset(self):
        self.st = {"collect": 0.0, "batch": 0.0, "render": 0.0,
                   "rescue": 0.0, "jobs": 0, "rescued": 0, "batches": 0}

    def _wrap(self):
        al, st = self.al, self.st
        o_collect, o_rescue = al.collect, al.rescue_mates
        depth = [0]

        def collect(h, paired=False):
            # the outermost call only: a two-pass collect calls collect
            # again for its pass 2
            depth[0] += 1
            t = time.perf_counter()
            try:
                return o_collect(h, paired=paired)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    st["collect"] += time.perf_counter() - t

        def rescue(*a):
            t = time.perf_counter()
            out = o_rescue(*a)
            st["rescue"] += time.perf_counter() - t
            st["jobs"] += len(a[0])
            st["rescued"] += sum(1 for x in out if x)
            return out

        al.collect, al.rescue_mates = collect, rescue
        return o_collect, o_rescue

    def run(self, batches, score):
        """batches: [(ReadBatch 1, ReadBatch 2, meta)]; score(text, meta)
        per batch.  Returns the slice's seconds."""
        np, al, st, drv = self.np, self.al, self.st, self.driver
        ref_fn = lambda pos, span: al.ref_codes[pos:pos + span]  # noqa
        saved = self._wrap()

        class Timed:
            def __init__(self, w):
                self.w, self.s = w, 0.0

            def write_pair(self, *a, **k):
                t = time.perf_counter()
                self.w.write_pair(*a, **k)
                self.s += time.perf_counter() - t

        def finish(item):
            b1, b2, rd, h, meta = item
            sink = io.StringIO()
            w = Timed(drv.SamWriter(sink, self.names, self.lens,
                                    no_head=True, annotator=self.annotate))
            t = time.perf_counter()
            drv._align_pair_batch(al, w, self.policy, al.scoring, self.k,
                                  b1, b2, ref_fn, rd, handle=h)
            st["batch"] += time.perf_counter() - t
            st["render"] += w.s
            st["batches"] += 1
            score(sink.getvalue(), meta)

        try:
            t0 = time.perf_counter()
            pend = deque()
            for b1, b2, meta in batches:
                rd = self.rdid0 + np.arange(len(b1.names), dtype=np.int64)
                self.rdid0 += len(b1.names)
                pend.append((b1, b2, rd,
                             drv._dispatch_pair_batch(al, b1, b2, rd), meta))
                if len(pend) >= 2:
                    p1, p2, pr, (ph, pl), pm = pend[-2]
                    pend[-2] = (p1, p2, pr, (al.advance(ph, paired=True),
                                             pl), pm)
                if len(pend) >= 3:
                    finish(pend.popleft())
            while pend:
                finish(pend.popleft())
            return time.perf_counter() - t0
        finally:
            al.collect, al.rescue_mates = saved

    def stages(self):
        st, nb = self.st, max(self.st["batches"], 1)
        pairing = st["batch"] - st["collect"] - st["rescue"] - st["render"]
        return (f"host ms per batch: collect (device wait + host phases + "
                f"the temp-site fixed point) {1e3 * st['collect'] / nb:.1f},"
                f" pairing (give-up replay, best_pairs, finalize, MAPQ) "
                f"{1e3 * pairing / nb:.1f}, rescue "
                f"{1e3 * st['rescue'] / nb:.1f}, render "
                f"{1e3 * st['render'] / nb:.1f}; whole _align_pair_batch "
                f"{1e3 * st['batch'] / nb:.1f}")


def capture_rescue(rescue):
    """Record every rescue_candidates call's keyword arguments (the chunks
    of rescue_mates) in the returned list, until `restore()`."""
    calls = []
    orig = rescue.rescue_candidates

    def rec(**kw):
        calls.append(kw)
        return orig(**kw)

    rescue.rescue_candidates = rec

    def restore():
        rescue.rescue_candidates = orig
    return calls, restore


def kernel_row(kernels, rows, name):
    """The kernels line's row of kernel `name`, made on first use."""
    k = kernels.KERNELS[name]
    return rows.setdefault(name, {
        "name": name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "max_abs_err": 0.0})


def pairs_phase(torch, np, g, index, spots, introns, kernels, twins, driver,
                TorchAligner, rows, path_launches, card, env):
    """Phase 14 (see the module docstring): paired reads on every index
    the unpaired path takes."""
    from hisat2_tpu_torch.align.paired import PairPolicy
    from hisat2_tpu_torch.index import FMIndex
    from hisat2_tpu_torch.io.fasta import ReadBatch
    from hisat2_tpu_torch.ops import rank, rescue, splice
    t_ph = time.perf_counter()

    # (a) spliced paired reads (the CLI's default for -1/-2) on phase 3's
    # index with phase 10's introns, driver defaults (k = 5, a spliced
    # PairPolicy, intron lengths from the site table, the fixed point)
    sal = TorchAligner(index, device="cuda", spliced=True, lane_meta=True)
    prng = np.random.default_rng(1414)
    pb = []
    for bi in range(PS_BATCHES + 1):
        sim = simulate_spliced_pairs(np, prng, g, introns,
                                     PS_INTRONS + PS_NEW * bi, spots, B, L)
        nm = [f"e{bi}_{i}" for i in range(B)]
        pb.append((ReadBatch(nm, list(sim[0]), list(sim[2])),
                   ReadBatch(list(nm), list(sim[1]), list(sim[3])),
                   sim[4:]))
    acc = {"pairs": 0, "normal": 0, "conc": 0, "can": 0, "can_true": 0}

    def score_spliced(text, meta):
        pos1, pos2, jl1, jl2, x1, x2, plain = meta
        prim = primaries(text)
        conc = np.array([bool(prim[(i, 1)][0] & 2) for i in range(B)])
        acc["pairs"] += B
        acc["normal"] += int(plain.sum())
        acc["conc"] += int((conc & plain).sum())
        for m, (pos, jl, x) in ((1, (pos1, jl1, x1)), (2, (pos2, jl2, x2))):
            for i in np.flatnonzero((jl > 0) & (x >= 20) & (L - x >= 20)):
                flag, p, cig, _ = prim[(int(i), m)]
                acc["can"] += 1
                acc["can_true"] += int(not flag & 4 and p == pos[i]
                                       and cig.count("N") == 1
                                       and f"{jl[i]}N" in cig)

    run = PairRun(np, driver, sal, PairPolicy(spliced=True), 5,
                  index.meta.ref_names, index.meta.ref_lens)
    run.run(pb[:1], lambda text, meta: None)       # warm-up
    run.reset()
    fp0 = sal.fixed_point_runs
    m0 = sal.splice_db.n_merges
    kernels.reset_counts()
    t_slice = run.run(pb[1:], score_spliced)
    launches = kernels.counts()
    conc_share = acc["conc"] / acc["normal"]
    can_share = acc["can_true"] / acc["can"]
    print(f"[pairs spliced] {acc['pairs']} pairs ({2 * acc['pairs']} "
          f"mates) in {t_slice:.2f} s: {acc['pairs'] / t_slice:.1f} pairs/s"
          f" on {card}; concordant share {conc_share:.4f} of "
          f"{acc['normal']} pairs without a repeat or random mate; "
          f"canonical junction mates (anchors >= 20) at their true "
          f"position with the planted N {can_share:.4f} ({acc['can_true']}"
          f"/{acc['can']}); rescue jobs {run.st['jobs']}, rescued mates "
          f"{run.st['rescued']}; sites {sal.splice_db.n_sites}, K18 merges "
          f"{sal.splice_db.n_merges - m0}, fixed-point re-runs "
          f"{sal.fixed_point_runs - fp0}; launches {launches}")
    print(f"[pairs spliced] {run.stages()}")
    check(conc_share >= 0.95, "spliced pairs: concordant share < 0.95")
    check(can_share >= 0.95, "spliced pairs: canonical junction mates "
          "placed true < 95%")
    check(run.st["rescued"] > 0, "spliced pairs: no rescued mate")
    for name in ("rescue_window",) + SPLICED_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the spliced "
              f"paired path")
    path_launches["pairs_spliced"] = launches

    # the fused lite and full step of the first batch's first P_CMP_B
    # pairs against the CPU step (the whole batch's full step took ~100 s
    # on the CPU), and every kernel of the whole fused batch's steps on
    # their arguments against its twin
    b1, b2 = pb[0][:2]
    codes = np.concatenate([b1.codes, b2.codes])
    quals = np.concatenate([b1.quals, b2.quals])
    lens = np.concatenate([b1.lens, b2.lens])
    minsc = sal._minsc(lens)
    rdids = np.tile(10 ** 8 + np.arange(B, dtype=np.int64), 2)
    sub = np.r_[0:P_CMP_B, B:B + P_CMP_B]
    cpu = TorchAligner(index, device="cpu", spliced=True, lane_meta=True)
    for k in ("sites", "_col_jl", "_col_jr", "_col_rdid"):
        setattr(cpu.splice_db, k, getattr(sal.splice_db, k))
    for tier in ("_fast", None):
        a = getattr(sal, tier) if tier else sal
        c = getattr(cpu, tier) if tier else cpu
        nm = "lite" if tier else "full"
        rd_a, ss_a = a._step_site_args(rdids)
        cap = {}
        a.step(*a.upload(codes, quals, lens, minsc), True, rdids=rd_a,
               ss=ss_a, capture=cap)
        rd_a, ss_a = a._step_site_args(rdids[sub])
        rd_c, ss_c = c._step_site_args(rdids[sub])
        t0 = time.perf_counter()
        bk = a.step(*a.upload(codes[sub], quals[sub], lens[sub],
                              minsc[sub]), True, rdids=rd_a, ss=ss_a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = c.step(*c.upload(codes[sub], quals[sub], lens[sub],
                              minsc[sub]), True, rdids=rd_c, ss=ss_c)
        w = bk.shape[1]
        check(torch.equal(bk.cpu(), bp), f"spliced paired {nm} step")
        check(a._out_specs[w] == c._out_specs[w],
              f"spliced paired {nm} _out_specs")
        print(f"[pairs spliced step] fused {nm} step of the first "
              f"{P_CMP_B} pairs, {2 * len(sub)} lanes: packed "
              f"[{bk.shape[0]}, {w}] equal to the CPU plain step; card "
              f"{1e3 * (t1 - t0):.1f} ms (host clock), CPU "
              f"{time.perf_counter() - t1:.1f} s")
        for key in sorted(cap):
            name = key.split("/")[0]
            err, ms, _ = compare(torch, key, *twins[name], cap[key],
                                 time_plain=False)
            row = kernel_row(kernels, rows, name)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if key == name:
                row[f"pairs_{nm}_ms"] = ms
            print(f"[pairs spliced kernels] {nm} {key} on the whole fused "
                  f"batch ({len(lens)} mates): equal to plain (tolerance: "
                  f"exact); kernel {ms:.4f} ms (median of 10)")
        del cap
    del cpu, sal
    torch.cuda.empty_cache()
    phase_s_a = time.perf_counter() - t_ph

    # (b) phase 11's two-shard 280 Mbp index and the linear aligner, DNA
    # mode (a spliced paired run on several shards is refused, as the JAX
    # package fails there: align/pipeline.py:SHARDED_SPLICED_PAIRS)
    t0 = time.perf_counter()
    C = GS_CHR
    gg = np.random.default_rng(1111).integers(0, 4, 2 * C).astype(np.uint8)
    gi = FMIndex.load(os.path.join(tempfile.gettempdir(),
                                   f"hisat2_tpu_torch_genome_2x{C}_seed1111"))
    gal = TorchAligner(gi, device="cuda", lane_meta=True)
    nw0 = gal.dev.ref_words.shape[0]
    print(f"[pairs genome] two-shard index loaded and uploaded in "
          f"{time.perf_counter() - t0:.1f} s; shard 0's words {nw0} "
          f"(16 x {nw0} = {16 * nw0} chars of a global n of "
          f"{gal.meta.n}); a rescue window past them reads the last row of "
          f"{rank.clamp_row(nw0)} words (K5) and the last word (K12)")
    grng = np.random.default_rng(1415)
    gpb = []
    for bi in range(PG_BATCHES + 1):
        m1, m2, q1, q2, p1, p2, plain = simulate_genome_pairs(
            np, grng, gg, B, L)
        nm = [f"h{bi}_{i}" for i in range(B)]
        gpb.append((ReadBatch(nm, list(m1), list(q1)),
                    ReadBatch(list(nm), list(m2), list(q2)),
                    (p1, p2, plain)))
    gacc = {"pairs": 0, "normal": 0, "conc": 0, "mates": 0, "second": 0}

    def score_genome(text, meta):
        p1, p2, plain = meta
        prim = primaries(text)
        conc = np.array([bool(prim[(i, 1)][0] & 2) for i in range(B)])
        gacc["pairs"] += B
        gacc["normal"] += int(plain.sum())
        gacc["conc"] += int((conc & plain).sum())
        for v in prim.values():
            if not v[0] & 4:
                gacc["mates"] += 1
                gacc["second"] += int(v[3] == gi.meta.ref_names[1])

    grun = PairRun(np, driver, gal, PairPolicy(), 5, gi.meta.ref_names,
                   gi.meta.ref_lens)
    chunks, restore = capture_rescue(rescue)
    try:
        grun.run(gpb[:1], lambda text, meta: None)  # warm-up
    finally:
        restore()
    grun.reset()
    kernels.reset_counts()
    t_slice = grun.run(gpb[1:], score_genome)
    launches = kernels.counts()
    conc_share = gacc["conc"] / gacc["normal"]
    second = gacc["second"] / gacc["mates"]
    print(f"[pairs genome] {gacc['pairs']} pairs in {t_slice:.2f} s: "
          f"{gacc['pairs'] / t_slice:.1f} pairs/s on {card}; concordant "
          f"share {conc_share:.4f} of {gacc['normal']} pairs without a "
          f"random mate; aligned mates on the second shard {second:.4f}; "
          f"rescue jobs {grun.st['jobs']}, rescued mates "
          f"{grun.st['rescued']}; launches {launches}")
    print(f"[pairs genome] {grun.stages()}")
    check(conc_share >= 0.95, "genome pairs: concordant share < 0.95")
    check(second >= 0.30, "genome pairs: mates on the second shard < 30%")
    for name in ("fm_search2", "resolve_walk", "compact_cands",
                 "ref_window", "extend_ungapped", "pack_slots",
                 "rescue_window"):
        check(launches[name] > 0, f"{name} never launched on the sharded "
              f"paired path")
    path_launches["pairs_shards"] = launches

    # one rescue chunk of the warm-up batch's jobs anchored on shard 1
    # (their windows read past shard 0's words) through K12 and K5
    # against their twins
    end = 16 * nw0
    check(chunks, "no rescue job in the sharded warm-up batch")
    kw0 = chunks[0]
    reads = torch.cat([c["reads"] for c in chunks])
    ws = torch.cat([c["win_start"] for c in chunks])
    sel = (ws >= end).nonzero().flatten()[:128]
    check(sel.numel() > 0, "no rescue job anchored past shard 0's words")
    kw = dict(ref_words=kw0["ref_words"], n_text=kw0["n_text"],
              reads=reads[sel].contiguous(), win_start=ws[sel].contiguous(),
              W=kw0["W"])
    err, ms, pms = compare(torch, "rescue_window", *twins["rescue_window"],
                           kw)
    starts = rescue.rescue_window(**kw)
    rkw = dict(planes=[kw0["ref_words"]], n_text=kw0["n_text"],
               starts=[starts], margins=[0], L=reads.shape[1])
    err_w, ms_w, pms_w = compare(torch, "ref_window", *twins["ref_window"],
                                 rkw)
    past = int((starts >= end).sum())
    for name, e_, m_, p_, clamp in (
            ("rescue_window", err, ms, pms, "the last word"),
            ("ref_window", err_w, ms_w, pms_w,
             f"the last row of {rank.clamp_row(nw0)} words")):
        row = kernel_row(kernels, rows, name)
        row["max_abs_err"] = max(row["max_abs_err"], e_)
        row["pairs_shard1_ms"], row["pairs_shard1_plain_ms"] = m_, p_
        row["past_words_clamp"] = clamp
        print(f"[pairs genome kernels] {name} on {sel.numel()} rescue jobs "
              f"anchored on shard 1 (W {kw['W']}; {past} of their "
              f"{starts.numel()} diagonals start past shard 0's {end} "
              f"chars, read through {clamp}): equal to plain (tolerance: "
              f"exact); kernel {m_:.4f} ms, plain {p_:.4f} ms (median of "
              f"10)")
    del gal, gi, gg
    torch.cuda.empty_cache()
    phase_s_b = time.perf_counter() - t_ph - phase_s_a

    # (c) the CLI on the card: the pes oracles, the nss and shard corpora
    # paired, and the runs the JAX package fails on, refused
    data = os.path.join(REPO, "tests/data")
    tmp = tempfile.mkdtemp(prefix="h2torch_pes_")
    try:
        for tag in ("pes", "nss", "shard"):
            with gzip.open(os.path.join(data, f"{tag}_genome.fa.gz"),
                           "rb") as f, \
                    open(os.path.join(tmp, f"{tag}.fa"), "wb") as o:
                o.write(f.read())
        sh = ["--shard-bp", "150000", "--offrate", "4"]
        gr = ["--snp", os.path.join(data, "pes.snp"), "--ss",
              os.path.join(data, "pes.ss")]
        builds = [("pes_lin", "pes", []), ("pes_gra", "pes", gr),
                  ("pes_sh", "pes", sh), ("pes_shg", "pes", gr + sh),
                  ("nss", "nss", []), ("shard_sh", "shard", sh)]
        t0 = time.perf_counter()
        run_clis([["build"] + a + [f"{c}.fa", i] for i, c, a in builds],
                 tmp, env, 600)
        pes = ["-1", os.path.join(data, "pes_reads_1.fa"), "-2",
               os.path.join(data, "pes_reads_2.fa")]
        runs = {"pes_ref_rna": ("pes_lin", [], pes),
                "pes_ref_snpss": ("pes_gra", [], pes),
                "pes_ref_shard_dna": ("pes_sh", ["--no-spliced-alignment"],
                                      pes),
                "pes_ref_nss": ("nss", [], ["-1", os.path.join(
                    data, "nss_reads.fa"), "-2", os.path.join(
                    data, "nss_reads.fa")]),
                "shard_ref_pe": ("shard_sh", ["--no-spliced-alignment"],
                                 ["-1", os.path.join(data, "shard_reads.fa"),
                                  "-2", os.path.join(data,
                                                     "shard_reads.fa")]),
                "refused_graph_shards": ("pes_shg",
                                         ["--no-spliced-alignment"], pes),
                "refused_spliced_shards": ("pes_sh", [], pes)}
        t1 = time.perf_counter()
        done = run_clis([["align"] + a + ["-f", "-x", i] + r
                         + ["-S", f"{k}.sam", "--device", "cuda"]
                         for k, (i, a, r) in runs.items()], tmp, env, 600,
                        ok=False)
        for k, (rc, e_) in zip(runs, done):
            if k.startswith("refused"):
                fault = ("KeyError: 'snv1'" if "graph" in k
                         else "KeyError: 'h_rounds'")
                check(rc == 1 and fault in e_,
                      f"{k}: not refused with {fault}: {e_[-2000:]}")
                continue
            check(rc == 0, f"CLI {k} failed: {e_[-2000:]}")
            with open(os.path.join(tmp, f"{k}.sam")) as f:
                got = [x for x in f if not x.startswith("@")]
            with gzip.open(os.path.join(data, f"{k}.sam.gz"), "rt") as f:
                want = f.readlines()
            check(got == want, f"CLI SAM body differs from {k}")
            print(f"[pairs cli] align -1 -2 --device cuda "
                  f"{' '.join(runs[k][1])} on {runs[k][0]}: {len(got)} SAM "
                  f"records equal to {k}")
        print(f"[pairs cli] builds {t1 - t0:.1f} s, the seven runs side by "
              f"side {time.perf_counter() - t1:.1f} s incl. start-up; the "
              f"sharded graph and sharded spliced runs refused, naming the "
              f"JAX fault")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[pairs] (a) {phase_s_a:.1f} s, (b) {phase_s_b:.1f} s, (c) "
          f"{time.perf_counter() - t_ph - phase_s_a - phase_s_b:.1f} s")


def ranked(text):
    """The allele names of a report's `N ranked <allele>` lines, per
    section (a section starts at each `Gene` line)."""
    out = []
    for line in text.splitlines():
        if line.strip().startswith("Gene "):
            out.append([])
        elif " ranked " in line:
            out[-1].append(line.split(" ranked ")[1].split(" ")[0])
    return out


def geno_alleles(np, rng, n=GA_ALLELES, Lk=GA_BP, B=B, RL=GA_RL,
                 picks=GA_PICKS):
    """`genotype --alleles` at HLA-A scale: n alleles of an Lk bp locus,
    2-12 private or shared SNVs each, and B reads of RL bp, 2:1 from the
    two picked alleles, every other one reverse-complemented."""
    bb = rng.integers(0, 4, Lk).astype(np.uint8)
    alleles = []
    for a in range(n):
        s = bb.copy()
        for p in rng.choice(Lk, int(rng.integers(2, 13)), replace=False):
            s[p] = (s[p] + 1 + rng.integers(0, 3)) % 4
        alleles.append((f"A*{a // 20 + 1:02d}:{a % 20 + 1:02d}", s))
    reads = []
    for i in range(B):
        src = alleles[picks[0] if i % 3 else picks[1]][1]
        st = int(rng.integers(0, Lk - RL + 1))
        r = src[st:st + RL]
        reads.append((f"r{i}", (3 - r)[::-1] if i % 2 else r))
    return alleles, reads


def geno_str(np, rng, n=GB_ALLELES, flank=GB_FLANK, B=B, RL=GA_RL,
             picks=GB_PICKS):
    """`genotype --msa` on an STR locus (tests/test_genotype_strcyp.py's
    shape at scale): n alleles of a [TCTA]6-14 [TCTG]3-8 repeat between
    two flank bp flanks (the MSA's gaps at the right end of each block,
    so repeat lengths are indels against the backbone), 2-12 flank SNVs
    each; B reads of RL bp, 2:1 from the picks (the second moved to the
    next allele with another repeat structure than the first's)."""
    acgt = np.array(list("ACGT"))
    fl = rng.integers(0, 4, flank)
    fr = rng.integers(0, 4, flank)
    rows, seqs, nm = [], [], []
    for a in range(n):
        k1, k2 = int(rng.integers(6, 15)), int(rng.integers(3, 9))
        left, right = fl.copy(), fr.copy()
        for p in rng.choice(2 * flank, int(rng.integers(2, 13)),
                            replace=False):
            side, q = (left, p) if p < flank else (right, p - flank)
            side[q] = (side[q] + 1 + rng.integers(0, 3)) % 4
        lt, rt = "".join(acgt[left]), "".join(acgt[right])
        rows.append((f"STR*{a + 1:04d}", lt + "TCTA" * k1 + "----" * (14 - k1)
                     + "TCTG" * k2 + "----" * (8 - k2) + rt))
        seqs.append(lt + "TCTA" * k1 + "TCTG" * k2 + rt)
        nm.append((k1, k2))
    p1, p2 = picks
    while nm[p2] == nm[p1]:
        p2 += 1
    reads = []
    rcm = str.maketrans("ACGT", "TGCA")
    for i in range(B):
        src = seqs[p1 if i % 3 else p2]
        st = int(rng.integers(0, len(src) - RL + 1))
        r = src[st:st + RL]
        reads.append((f"s{i}", r.translate(rcm)[::-1] if i % 2 else r))
    return rows, reads, (p1, p2)


def geno_loci(np, rng, g, cat, B=B, RL=GA_RL):
    """`genotype --run` on the config-2 graph index: GC_LOCI windows of g
    of GC_BP bp, each with an MSA of GC_ALLELES alleles mutated from it
    (2-12 SNVs each); GC_BATCHES batches of B reads, GC_SHARE of them
    from the loci (2:1 from two alleles of each, RL bp, every other one
    reverse-complemented) and the rest phase 8's mix (simulate_graph).
    Returns the loci [(gene, lo, hi, msa rows, picked names)] and the
    reads."""
    loci = []
    n_all = B * GC_BATCHES
    n_loc = round(GC_SHARE * n_all)
    acgt = np.array(list("ACGT"))
    reads = []
    for k, lo in enumerate(GC_LOCI):
        hi = lo + GC_BP
        rows = []
        for a in range(GC_ALLELES):
            s = g[lo:hi].copy()
            for p in rng.choice(GC_BP, int(rng.integers(2, 13)),
                                replace=False):
                s[p] = (s[p] + 1 + rng.integers(0, 3)) % 4
            rows.append((f"G{k}*{a + 1:02d}", "".join(acgt[s])))
        picks = (int(rng.integers(0, GC_ALLELES // 2)),
                 int(rng.integers(GC_ALLELES // 2, GC_ALLELES)))
        loci.append((f"G{k}", lo, hi, rows,
                     {rows[picks[0]][0], rows[picks[1]][0]}))
        rcm = str.maketrans("ACGT", "TGCA")
        for i in range(n_loc // len(GC_LOCI)):
            src = rows[picks[0] if i % 3 else picks[1]][1]
            st = int(rng.integers(0, GC_BP - RL + 1))
            r = src[st:st + RL]
            reads.append((f"G{k}_{i}", r.translate(rcm)[::-1] if i % 2
                          else r))
    codes, _, lens, _, _, _ = simulate_graph(np, rng, g, cat,
                                             n_all - len(reads), L)
    reads += [(f"bg{i}", codes[i, :lens[i]]) for i in range(len(codes))]
    order = rng.permutation(len(reads))
    return loci, [reads[i] for i in order]


def hold_tiers(torch, np, kernels, twins, rows, al, b, tag, col,
               timed=()):
    """A genotype run's own aligner `al` (recorded as the driver built
    it): a step of its lite tier, where it has one, and of its full tier
    on batch b, and every kernel each step launches against its plain
    twin on the step's arguments (tolerance: exact).  Each error is
    folded into the kernel's row, and its median put there as
    `{col}_ms` (the full tier) or `{col}_lite_ms`; the kernels of `timed`
    also time their plain twins (`{col}_plain_ms`).  Returns each tier's
    captured arguments."""
    minsc = al._minsc(b.lens)
    uniform = bool(np.all(b.lens == b.lens[0]))
    caps = {}
    for tier, nm in ((al._fast, "lite"), (al, "full")):
        if tier is None:
            continue
        cap = {}
        tier.step(*tier.upload(b.codes, b.quals, b.lens, minsc), uniform,
                  capture=cap)
        ms_of = {}
        for key in sorted(cap):
            name = key.split("/")[0]
            err, ms, pms = compare(torch, key, *twins[name], cap[key],
                                   time_plain=key in timed)
            row = kernel_row(kernels, rows, name)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if key == name:
                row[col + ("_ms" if tier is al else "_lite_ms")] = ms
            if pms is not None:
                row[f"{col}_plain_ms"] = pms
            ms_of[key] = f"{ms:.4f}" + (f" (plain {pms:.4f})" if pms
                                        is not None else "")
        caps[nm] = cap
        print(f"[genotype] ({tag}) the {nm} step on {len(b.lens)} reads: "
              f"every kernel equal to plain (tolerance: exact); kernel ms "
              f"(median of 10): {ms_of}")
    return caps


def genotype_phase(torch, np, kernels, twins, g, cat, cache, rows,
                   path_launches, card, env):
    """Phase 15 (see the module docstring): the genotype callers, typing
    through TorchAligner on the card."""
    import importlib.util
    from hisat2_tpu_torch.genotype import driver as gdriver
    from hisat2_tpu_torch.genotype.msa import parse_msa
    from hisat2_tpu_torch.io.fasta import read_batches
    from hisat2_tpu_torch.ops import splice
    t_ph = time.perf_counter()
    data = os.path.join(REPO, "tests", "data")
    spec = importlib.util.spec_from_file_location(
        "make_geno", os.path.join(data, "make_geno.py"))
    mg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mg)
    tmp = tempfile.mkdtemp(prefix="h2torch_geno_")
    launches = dict.fromkeys(kernels.KERNELS, 0)
    part_s = {}

    def run(argv, tag):
        """The driver's genotype run on the card: its report, host
        seconds and kernel launches (counts set to 0 just before)."""
        args = gdriver.build_parser().parse_args(argv + ["--device", "cuda"])
        kernels.reset_counts()
        t0 = time.perf_counter()
        with mg.recorded_aligners() as made:
            rc = {"alleles": gdriver.run_genotype,
                  "msa": gdriver.run_genotype_msa,
                  "run": gdriver.run_genotype_full}[tag](args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = kernels.counts()
        check(rc == 0, f"genotype {tag} returned {rc}")
        for k, v in got.items():
            launches[k] += v
        with open(args.out) as f:
            return f.read(), dt, got, made

    def cpu_equal(tag, argv, outs):
        """The driver's run of argv on --device cuda, then on cpu, to the
        same paths (a report names its assembly's): each file of `outs`
        written alike."""
        t0 = time.perf_counter()
        texts = []
        for dev in ("cuda", "cpu"):
            check(gdriver.main(argv + ["--device", dev]) == 0,
                  f"({tag}) --device {dev}")
            texts.append([open(o, "rb").read() for o in outs])
        check(texts[0] == texts[1], f"({tag}): the card's {outs} on the "
              f"first {GA_CMP_B} reads differ from the CPU's")
        print(f"[genotype] ({tag}) "
              f"{', '.join(os.path.basename(o) for o in outs)} on the "
              f"first {GA_CMP_B} reads equal on cuda and cpu "
              f"({time.perf_counter() - t0:.1f} s)")

    try:
        # (a) --alleles at HLA-A scale
        rng = np.random.default_rng(1515)
        alleles, reads = geno_alleles(np, rng)
        af, rf = os.path.join(tmp, "alleles.fa"), os.path.join(tmp, "r.fa")
        mg.write_fa(af, alleles)
        mg.write_fa(rf, reads)
        rep, dt, got, made = run(["--alleles", af, "-U", rf, "--out",
                                  os.path.join(tmp, "a.txt")], "alleles")
        want = {alleles[p][0] for p in GA_PICKS}
        top = ranked(rep)
        check(len(top) == 1 and set(top[0][:2]) == want and "call:" in rep,
              f"--alleles: the planted pair {sorted(want)} is not on top:"
              f"\n{rep}")
        for name in ("fm_search2", "compact_cands", "pack_slots"):
            check(got[name] > 0, f"--alleles: {name} never launched")
        part_s["a"] = dt
        print(f"[genotype] (a) --alleles, {GA_ALLELES} alleles x {GA_BP} bp "
              f"(k = 16, max_seeds = 10**6), {B} reads of {GA_RL} bp in "
              f"{dt:.2f} s (host clock; index build, upload, step and the "
              f"host's class resolution): {B / dt:.1f} reads/s on {card}; "
              f"top {top[0][:2]} = the planted pair; launches {got}")
        al = made[-1]
        check(len(made) == 1 and (al.msize, al.max_cands) == (64, 65),
              f"--alleles aligner: msize {al.msize}, {al.max_cands} cands")
        caps = hold_tiers(torch, np, kernels, twins, rows, al,
                          next(read_batches(rf, B)), "a", "allele",
                          timed=("compact_cands", "pack_slots"))
        cc = caps["full"]["compact_cands"]
        width = int((cc["bot"] - cc["top"]).max())
        check(width > 64, f"--alleles: widest hit {width} rows")
        print(f"[genotype] (a) the step's widest hit {width} rows "
              f"(msize {al.msize}, {al.max_cands} candidates a lane)")
        del made, al, caps, cc
        rf5 = os.path.join(tmp, "r512.fa")
        mg.write_fa(rf5, reads[:GA_CMP_B])
        out = os.path.join(tmp, "a512.txt")
        cpu_equal("a", ["--alleles", af, "-U", rf5, "--out", out], [out])

        # (b) --msa --assembly on an STR locus
        rng = np.random.default_rng(1516)
        msa, reads, picks = geno_str(np, rng)
        mf = os.path.join(tmp, "str.msa.fa")
        rf = os.path.join(tmp, "s.fa")
        mg.write_fa(mf, msa)
        mg.write_fa(rf, reads)
        base = os.path.join(tmp, "asm")
        rep, dt, got, made = run(["--msa", mf, "-U", rf, "--out",
                                  os.path.join(tmp, "b.txt"), "--assembly",
                                  "--out-base", base], "msa")
        want = {msa[p][0] for p in picks}
        top = ranked(rep)
        check(len(top) == 1 and set(top[0][:2]) == want and "call:" in rep,
              f"--msa: the planted pair {sorted(want)} is not on top:\n{rep}")
        check(got["inject_indels"] > 0, "--msa: K10+K11 never launched")
        bb, avars, _, _ = parse_msa(mf)
        # away from the read-length edges: of the locus, and of the repeat
        # block, where the JAX assembly phases the mismatches of reads
        # placed across a repeat-length indel as SNVs (ROADMAP Queue 3)
        keep = np.ones(len(bb), bool)
        keep[:GA_RL] = keep[len(bb) - GA_RL:] = False
        keep[GB_FLANK - GA_RL:len(bb) - GB_FLANK + GA_RL] = False

        def on_backbone(p):
            s = bb.copy()
            for v in avars[msa[p][0]]:
                if v[0] == "S":
                    s[v[1]] = "ACGT".index(v[2])
            return "".join("ACGT"[c] for c in s[keep])

        with open(base + ".assembly.fa") as f:
            fa = f.read().splitlines()
        haps = {"".join(np.array(list(h))[keep]) for h in (fa[1], fa[3])}
        check(haps == {on_backbone(p) for p in picks},
              "--msa --assembly: the haplotypes differ from the planted "
              "alleles' SNVs on the backbone")
        part_s["b"] = dt
        print(f"[genotype] (b) --msa --assembly, {GB_ALLELES} alleles on a "
              f"{len(bb)} bp backbone ({sum(len(v) for v in avars.values())}"
              f" allele variants, STR repeat lengths as catalog indels), "
              f"{B} reads in {dt:.2f} s (host clock): {B / dt:.1f} reads/s "
              f"on {card}; top {top[0][:2]} = the planted pair; both "
              f"assembled haplotypes equal the planted alleles on "
              f"{int(keep.sum())} of {len(bb)} backbone positions (a read "
              f"length from the locus ends and the repeat block); "
              f"launches {got}")
        al = made[-1]
        check(al.has_indels and al._fast is not None,
              "--msa aligner: no indel catalog or no lite tier")
        caps = hold_tiers(torch, np, kernels, twins, rows, al,
                          next(read_batches(rf, B)), "b", "msa")
        check("inject_indels" in caps["full"], "--msa: the full step "
              "launched no K10+K11")
        inj = splice.inject_indels_plain(**caps["full"]["inject_indels"])
        live = int((inj["event"] >= 0).sum())
        check(live > 0, "--msa: K10+K11 injected no event on the batch")
        print(f"[genotype] (b) K10+K11 on the full step: {live} injected "
              f"repeat-length events")
        del made, al, caps, inj
        rf5 = os.path.join(tmp, "s512.fa")
        mg.write_fa(rf5, reads[:GA_CMP_B])
        out, asm = os.path.join(tmp, "b512.txt"), os.path.join(tmp, "b512")
        cpu_equal("b", ["--msa", mf, "-U", rf5, "--out", out, "--assembly",
                        "--out-base", asm], [out, asm + ".assembly.fa"])

        # (c) --run on phase 8's saved 40 Mbp graph index
        rng = np.random.default_rng(1517)
        loci, reads = geno_loci(np, rng, g, cat)
        msa_dir = os.path.join(tmp, "msa")
        os.makedirs(msa_dir)
        gbase = os.path.join(tmp, "gg")
        with open(gbase + ".locus", "w") as f:
            for gene, lo, hi, rws, _ in loci:
                mg.write_fa(os.path.join(msa_dir, f"{gene}.msa.fa"), rws)
                f.write(f"HLA\t{gene}*01\tc2\t{lo}\t{hi - 1}\t{lo}-{hi - 1}"
                        "\t+\n")
        rf = os.path.join(tmp, "g.fa")
        mg.write_fa(rf, reads)
        rep, dt, got, made = run(["--run", gbase, "--index", cache,
                                  "--msa-dir", msa_dir, "-U", rf, "--out",
                                  os.path.join(tmp, "c.txt")], "run")
        top = ranked(rep)
        check(len(top) == len(loci), f"--run: {len(top)} gene sections:\n"
              f"{rep}")
        for (gene, _, _, _, want), t in zip(loci, top):
            check(set(t[:2]) == want, f"--run: {gene} ranks {t[:2]}, not "
                  f"the planted {sorted(want)}:\n{rep}")
        for name in ("fm_search2", "compact_cands", "pack_slots",
                     "inject_indels"):
            check(got[name] > 0, f"--run: {name} never launched")
        part_s["c"] = dt
        n_r = len(reads)
        print(f"[genotype] (c) --run on the 40 Mbp graph index (loaded from "
              f"{os.path.basename(cache)}), {len(loci)} loci of {GC_BP} bp "
              f"with {GC_ALLELES} alleles each, {n_r} reads ({GC_SHARE:.0%} "
              f"from the loci) in {dt:.2f} s (host clock; index load, graph "
              f"set-up, the genome pass and each locus's typing): "
              f"{n_r / dt:.1f} reads/s on {card}; every locus ranks its "
              f"planted pair on top; launches {got}")
        print("[genotype] (c) report:\n" + rep.rstrip())
        gp = next(x for x in made if x._fast is not None)
        check(int(gp.meta.ref_lens[0]) == len(g) and gp.has_indels,
              "--run: the genome pass's aligner is not on the graph index")
        caps = hold_tiers(torch, np, kernels, twins, rows, gp,
                          next(read_batches(rf, B)), "c genome pass", "run")
        check("inject_indels" in caps["full"], "--run: the genome pass's "
              "full step launched no K10+K11")
        k = len(loci) - 1
        lf = os.path.join(tmp, "locus.fa")
        mg.write_fa(lf, [r for r in reads if r[0].startswith(f"G{k}_")])
        hold_tiers(torch, np, kernels, twins, rows, made[-1],
                   next(read_batches(lf, B)), f"c locus G{k}", "run_locus")
        del made, gp, caps
        torch.cuda.empty_cache()
        path_launches["genotype"] = dict(launches)

        # (d) the CLI on the card: the committed geno oracles, align -A
        cdir = os.path.join(tmp, "cli")
        mg.stage(cdir)
        with gzip.open(os.path.join(data, "mm3_genome.fa.gz"), "rb") as f, \
                open(os.path.join(cdir, "mm3.fa"), "wb") as o:
            o.write(f.read())
        lines = {nm: ["--no-spliced-alignment", "-f", "-x", "mm3", "-U",
                      os.path.join(data, "mm3_reads.fa"), "-S",
                      f"A_{nm}.sam", "--device", "cuda", "--quiet"] + extra
                 for nm, extra in (("k10", ["-k", "10"]),
                                   ("sec", ["-k", "3", "--secondary"]))}
        with open(os.path.join(cdir, "args.txt"), "w") as f:
            f.write("".join(" ".join(v) + "\n" for v in lines.values()))
        t0 = time.perf_counter()
        geno = [["genotype"] + mg.RUNS[k][0] + ["--device", "cuda"]
                for k in ("alleles", "msa")]
        run_clis([["build", "--snp", "geno_gg.snp", "geno_gg.fa", mg.IDX],
                  ["build", "mm3.fa", "mm3"]] + geno, cdir, env, 600)
        t1 = time.perf_counter()
        run_clis([["genotype"] + mg.RUNS[k][0] + ["--device", "cuda"]
                  for k in ("run", "extract")] + [["align", "-A",
                                                   "args.txt"]],
                 cdir, env, 600)
        for k, (_, outs) in mg.RUNS.items():
            for got_f, oracle in outs:
                with open(os.path.join(cdir, got_f), "rb") as f, gzip.open(
                        os.path.join(data, oracle + ".gz"), "rb") as o:
                    check(f.read() == o.read(),
                          f"genotype {k} --device cuda: {got_f} differs "
                          f"from {oracle}")
        for nm in lines:
            with open(os.path.join(cdir, f"A_{nm}.sam")) as f:
                body = [x for x in f if not x.startswith("@")]
            with gzip.open(os.path.join(data, f"mm3_ref_{nm}.sam.gz"),
                           "rt") as f:
                check(body == [x for x in f if not x.startswith("@")],
                      f"align -A: the {nm} line's SAM differs from "
                      f"mm3_ref_{nm}")
        print(f"[genotype cli] genotype --device cuda --alleles, --msa "
              f"--assembly, --run and --extract-reads on the geno corpus: "
              f"every report and file equal to its JAX oracle; align -A "
              f"(two lines, --device cuda) on mm3: both SAM bodies equal "
              f"to mm3_ref_k10 and mm3_ref_sec; builds and the first two "
              f"runs side by side {t1 - t0:.1f} s, the other three "
              f"{time.perf_counter() - t1:.1f} s incl. start-up")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[genotype] parts (host clock): " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in part_s.items())
        + f"; phase {time.perf_counter() - t_ph:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.align import driver
    from hisat2_tpu_torch.align.host import read_alignments
    from hisat2_tpu_torch.align.pipeline import TorchAligner
    from hisat2_tpu_torch.index import (FMIndex, VariantDB, attach_variants,
                                        build_fm_index)
    from hisat2_tpu_torch.ops import kernel_twins, splice

    twins = kernel_twins()
    bounds = {}
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        print(f"[{name}] phase seconds {phase_s[name]:.1f}")
        t_phase = now

    # 1 card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}, {torch.cuda.device_count()} visible")

    # 2 build
    chase_p, chase_so = chase_build(kernels)
    t_build = kernels.build(force=True)
    kernels.load()
    _, err = chase_p.communicate()
    check(chase_p.returncode == 0, f"nvcc pointer chase: {err[-2000:]}")
    CHASE["so"] = chase_so
    print(f"[build] nvcc sm_90a, {len(kernels.KERNELS)} kernels "
          f"({', '.join(kernels.KERNELS)}): {t_build:.2f} s")
    phase_done("build")

    # 3 index (config 2: bench.py:211,216-222)
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, GENOME).astype(np.uint8)
    spots = plant_repeats(np, g)
    cache = os.path.join(tempfile.gettempdir(),
                         f"hisat2_tpu_torch_config2_{GENOME}_seed7_rep"
                         f"{REP_UNITS}x{REP_COPIES}")
    if os.path.exists(cache + ".npz"):
        index = FMIndex.load(cache)
        how = "loaded from cache"
    else:
        index = build_fm_index([("c2", g)])
        index.save(cache)
        how = "built"
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    al = TorchAligner(index, device="cuda")
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    print(f"[index] 40 Mbp config-2 index {how} in {t_index:.1f} s; upload "
          f"{t_up:.2f} s; {al.dev.nbytes()} bytes resident on the device")
    phase_done("index")

    # 4 kernels vs plain, on the real intermediates of one batch
    srng = np.random.default_rng(2024)
    batches = [simulate(np, srng, g, B, L) for _ in range(N_BATCHES + 1)]
    codes, quals, lens, start, clean, rc = batches[0]
    minsc = al._minsc(lens)
    uniform = bool(np.all(lens == L))
    up = al.upload(codes, quals, lens, minsc)
    cap = {}
    k5 = kernels.KERNELS["ref_window"].launches
    al.step(*up, uniform, capture=cap)
    k5 = kernels.KERNELS["ref_window"].launches - k5
    linear = ["fm_search2", "compact_cands", "ref_window", "extend_ungapped",
              "indel_sweep", "pack_slots"]
    check(sorted(cap) == sorted(linear + ["extend_ungapped/extra"]),
          f"captured {sorted(cap)}")
    rows = {}
    for key in linear + ["extend_ungapped/extra"]:
        name = key.split("/")[0]
        err, ms, pms = compare(torch, key, *twins[name], cap[key])
        k = kernels.KERNELS[name]
        row = rows.setdefault(name, {
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        f = "linear" + key[len(name):].replace("/", "_")
        row[f + "_ms"], row[f + "_plain_ms"] = ms, pms
        shp = [tuple(v.shape) for v in cap[key].values()
               if torch.is_tensor(v)]
        print(f"[kernels] {key}: equal to plain (tolerance: exact), "
              f"max_abs_err {err}; kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(median of 10; inputs {shp[:4]})")
    step_shapes(splice, "linear", cap, k5)
    check(k5 == 1, f"the linear step launched K5 {k5} times")
    # K1: its launch, and the share of its lanes' steps whose top and bot
    # lie in one 128-row block (one fused row fetched), from the twin
    from hisat2_tpu_torch.ops import search
    for cols in (44, 49):
        info = kernels.launch_info("h2_fm_search2_info", cols, n=6)
        print(f"[kernels] fm_search2 launch on the {cols}-column table: "
              f"{shape_text(info)}, "
              f"{-(-cap['fm_search2']['reads'].shape[0] * 8 // info['threads'])}"
              f" blocks for this step's lanes")
    fm_st = {}
    search.partial_search2_plain(**cap["fm_search2"], stats=fm_st)
    print(f"[kernels] fm_search2 steps: {fm_st['steps']} lane steps, "
          f"{fm_st['one_row']} ({fm_st['one_row'] / fm_st['steps']:.4f}) "
          f"with top and bot in one 128-row block")
    # K6+K7 at the read lengths of its other column runs (K = 8, 16, and
    # 16 in several tiles)
    from hisat2_tpu_torch.ops import extend
    for Lx in (151, 250, 512, 2000):
        for snv in (False, True):
            info = extend.launch_info(Lx, snv)
            check(info["blocks_per_sm"] >= 1, f"extend_ungapped: L = {Lx} "
                  f"does not fit an SM")
            print(f"[kernels] extend_ungapped launch at L = {Lx}"
                  f"{', SNV windows' if snv else ''}: {shape_text(info)}")
    # K8 at long-read shapes the gap budget can give (the window margin is
    # max(16, G), align/pipeline.py), as the runtime reports them
    for Lx, Gx, snv in ((151, 8, False), (151, 8, True), (512, 19, False),
                        (512, 27, True), (512, 32, True)):
        info = splice.sweep_launch_info("indel_sweep", 1, Lx,
                                        Lx + 2 * max(16, Gx), 0, snv, Gx)
        check(info["blocks_per_sm"] >= 1, f"indel_sweep: L = {Lx}, G = "
              f"{Gx} does not fit an SM")
        print(f"[kernels] indel_sweep launch at L = {Lx}, G = {Gx}"
              f"{', SNV windows' if snv else ''}: {info['regs']} registers,"
              f" {info['smem']} bytes of shared memory per block, "
              f"{info['threads']} threads, {info['blocks_per_sm']} blocks "
              f"per SM")
    phase_done("kernels")

    # 5 whole step: kernels on the card vs plain versions on the CPU
    cpu = TorchAligner(index, device="cpu")
    for full in (False, True):
        t0 = time.perf_counter()
        bk = al.step(*up, uniform, full)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = cpu.step(*cpu.upload(codes, quals, lens, minsc), uniform, full)
        t2 = time.perf_counter()
        w = bk.shape[1]
        check(torch.equal(bk.cpu(), bp), f"packed step full_out={full}")
        check(al._out_specs[w] == cpu._out_specs[w]
              and al._spill_meta[w] == cpu._spill_meta[w],
              f"_out_specs full_out={full}")
        print(f"[step] full_out={full}: packed [{bk.shape[0]}, {w}] equal "
              f"to the CPU plain step; card {1e3 * (t1 - t0):.1f} ms "
              f"(host clock), CPU {t2 - t1:.1f} s")
    del cpu
    phase_done("step")

    # 6 slice: the main path, pipelined like bench.py:137-168
    names = [f"r{i}" for i in range(B)]
    stats = {"reads": 0, "aligned": 0, "clean": 0, "true": 0}

    def emit(aligner, handle, batch, ref_names, annotate=None):
        codes_, quals_, lens_, start_, clean_, rc_ = batch
        res = aligner.collect(handle)
        sink = io.StringIO()
        w = driver.SamWriter(sink, ref_names, index.meta.ref_lens,
                             no_head=True, annotator=annotate)
        w.write_batch_raw(names, codes_, quals_, lens_, res.raw,
                          aligner.ref_codes,
                          finalize=lambda i: read_alignments(res.raw, i))
        cols = res.raw["cols"]
        rd = np.asarray(cols[0])
        first = np.unique(rd, return_index=True)[1]
        ok = np.zeros(len(names), bool)
        r0 = rd[first]
        ok[r0] = ((np.asarray(cols[3])[first] == start_[r0])
                  & (np.asarray(cols[1])[first] == rc_[r0]))
        stats["reads"] += len(names)
        stats["aligned"] += len(r0)
        stats["clean"] += int(clean_.sum())
        stats["true"] += int((ok & clean_).sum())
        return res, sink.getvalue()

    al.align_batch(*batches[0][:3])            # warm-up
    run = batches[1:]
    kernels.reset_counts()
    t0 = time.perf_counter()
    pend = deque()
    for b in run:
        pend.append((al.dispatch(*b[:3]), b))
        if len(pend) >= DEPTH:
            emit(al, *pend.popleft(), index.meta.ref_names)
    while pend:
        emit(al, *pend.popleft(), index.meta.ref_names)
    t_slice = time.perf_counter() - t0
    launches = kernels.counts()
    rate = stats["reads"] / t_slice
    share_al = stats["aligned"] / stats["reads"]
    share_true = stats["true"] / stats["clean"]
    print(f"[slice] {stats['reads']} reads in {t_slice:.2f} s: "
          f"{rate:.1f} reads/s on {card}; aligned {share_al:.4f}; "
          f"unmodified reads at their true position {share_true:.4f} "
          f"({stats['true']}/{stats['clean']}); launches {launches}")
    check(share_true >= 0.99, "unmodified reads placed true < 99%")
    for name in linear:
        check(launches[name] > 0, f"{name} never launched on the main path")
    path_launches = {"linear": launches}
    phase_done("slice")

    # 7 CLI on the mm3 corpus
    env = dict(os.environ, PYTHONPATH=REPO)
    tmp = tempfile.mkdtemp(prefix="h2torch_cli_")
    try:
        with gzip.open(os.path.join(REPO, "tests/data/mm3_genome.fa.gz"),
                       "rb") as f, open(os.path.join(tmp, "g.fa"), "wb") as o:
            o.write(f.read())
        run_cli(["build", "g.fa", "idx"], tmp, env, 300)
        t0 = time.perf_counter()
        run_cli(["align", "--no-spliced-alignment", "-f", "-x", "idx",
                 "-U", os.path.join(REPO, "tests/data/mm3_reads.fa"),
                 "-k", "10", "-S", "out.sam", "--device", "cuda"], tmp, env,
                600)
        with open(os.path.join(tmp, "out.sam")) as f:
            got = [x for x in f if not x.startswith("@")]
        with gzip.open(os.path.join(REPO, "tests/data/mm3_ref_k10.sam.gz"),
                       "rt") as f:
            want = [x for x in f if not x.startswith("@")]
        check(got == want, "CLI SAM body differs from mm3_ref_k10")
        print(f"[cli] align --device cuda -k 10 on mm3: {len(got)} SAM "
              f"records equal to the oracle ({time.perf_counter() - t0:.1f} "
              f"s incl. start-up)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("cli")

    # 8 graph DNA: catalog, two tiers, kernels, steps, slice, CLI
    del al
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    crng = np.random.default_rng(11)
    snp = cache + ".snp"
    cat = make_catalog(np, crng, g, snp)
    if os.path.exists(cache + ".var.npz"):
        db = VariantDB.load(cache)
        how = "loaded from cache"
    else:
        attach_variants(index, snp_file=snp)
        db = index._variants
        db.save(cache)
        how = "attached"
    gal = TorchAligner(index, device="cuda", variants=db)
    torch.cuda.synchronize()
    gd = gal.graph_dev
    print(f"[graph] catalog {N_SNV} SNVs, {N_DEL} deletions, {N_INS} "
          f"insertions ({how}); indel table E = {gd['ind_ip'].shape[0]}; "
          f"graph set-up {time.perf_counter() - t0:.1f} s")
    grng = np.random.default_rng(99)
    gb = [simulate_graph(np, grng, g, cat, B, L)
          for _ in range(G_BATCHES + 1)]
    codes, quals, lens, start, snv_only, rc = gb[0]
    minsc = gal._minsc(lens)
    for tier, a in (("lite", gal._fast), ("full", gal)):
        gup = a.upload(codes, quals, lens, minsc)
        cap = {}
        k5 = kernels.KERNELS["ref_window"].launches
        a.step(*gup, True, capture=cap)
        k5 = kernels.KERNELS["ref_window"].launches - k5
        want = linear[:4] + ["pack_slots"] + (
            ["inject_indels", "indel_sweep", "extend_ungapped/extra"]
            if tier == "full" else [])
        check(sorted(cap) == sorted(want), f"{tier} captured {sorted(cap)}")
        check(cap["extend_ungapped"]["snv1_win"] is not None,
              "graph extension without SNV windows")
        for key in want:
            name = key.split("/")[0]
            err, ms, pms = compare(torch, key, *twins[name], cap[key])
            if key == name and (tier == "full" or name not in bounds):
                # the bound at the shapes `ms` is taken at (the full pass)
                bounds[name] = work(torch, name, cap[name],
                                    twins[name][0](**cap[name]))
            row = rows.setdefault(name, {
                "name": name, "route": "cuda",
                "source": kernels.KERNELS[name].source,
                "replaces": kernels.KERNELS[name].replaces,
                "max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            f = tier + key[len(name):].replace("/", "_")
            row[f + "_ms"], row[f + "_plain_ms"] = ms, pms
            print(f"[graph kernels] {tier} {key}: equal to plain "
                  f"(tolerance: exact); kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms (median of 10)")
        step_shapes(splice, f"graph {tier}", cap, k5)
        # K5 held above on every plane (the reference and the two SNV
        # planes) of every start set, in the step's one launch
        rw = cap["ref_window"]
        check(len(rw["planes"]) == 3 and k5 == 1
              and len(rw["starts"]) == (2 if tier == "full" else 1),
              f"the graph {tier} step's windows: {len(rw['planes'])} "
              f"planes, {len(rw['starts'])} start sets, {k5} launches")
        if tier == "full":
            inj = splice.inject_indels(**cap["inject_indels"])
            live = int((inj["event"] >= 0).sum())
            check(live > 0, "no injected known-indel slot in the batch")
            print(f"[graph kernels] injected known-indel slots in the "
                  f"batch: {live}")
    phase_done("graph kernels")

    gcpu = TorchAligner(index, device="cpu", variants=db)
    for tier in ("_fast", None):
        a = getattr(gal, tier) if tier else gal
        c = getattr(gcpu, tier) if tier else gcpu
        for full in (False, True):
            t0 = time.perf_counter()
            bk = a.step(*a.upload(codes, quals, lens, minsc), True, full)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bp = c.step(*c.upload(codes, quals, lens, minsc), True, full)
            t2 = time.perf_counter()
            w = bk.shape[1]
            nm = "lite" if tier else "full"
            check(torch.equal(bk.cpu(), bp),
                  f"graph {nm} packed step full_out={full}")
            check(a._out_specs[w] == c._out_specs[w]
                  and a._spill_meta[w] == c._spill_meta[w],
                  f"graph {nm} _out_specs full_out={full}")
            print(f"[graph step] {nm} full_out={full}: packed "
                  f"[{bk.shape[0]}, {w}] equal to the CPU plain step; card "
                  f"{1e3 * (t1 - t0):.1f} ms (host clock), CPU "
                  f"{t2 - t1:.1f} s")
    del gcpu
    phase_done("graph step")

    stats.update(reads=0, aligned=0, clean=0, true=0)
    gal.align_batch(*gb[0][:3])                # warm-up
    routed = n_known = 0
    kernels.reset_counts()
    t0 = time.perf_counter()
    pend = deque()

    def gemit(h, b):
        nonlocal n_known
        res, _ = emit(gal, h, b, index.meta.ref_names, gal.annotate_snps)
        n_known += int((np.asarray(res.raw["cols"][22]) >= 0).sum())

    for b in gb[1:]:
        pend.append((gal.dispatch(*b[:3]), b))
        if len(pend) >= 2:
            h = gal.advance(pend[-2][0])
            if h[0] == "2pass2":
                routed += int(h[3].size)
            pend[-2] = (h, pend[-2][1])
        if len(pend) >= DEPTH:
            gemit(*pend.popleft())
    while pend:
        gemit(*pend.popleft())
    t_slice = time.perf_counter() - t0
    launches = kernels.counts()
    rate = stats["reads"] / t_slice
    share_al = stats["aligned"] / stats["reads"]
    share_true = stats["true"] / stats["clean"]
    print(f"[graph slice] {stats['reads']} reads in {t_slice:.2f} s: "
          f"{rate:.1f} reads/s on {card}; aligned {share_al:.4f}; "
          f"SNV-only reads at their true position {share_true:.4f} "
          f"({stats['true']}/{stats['clean']}); known-indel alignments "
          f"{n_known}; routed share {routed / stats['reads']:.4f}; "
          f"launches {launches}")
    check(share_true >= 0.99, "SNV-only reads placed true < 99%")
    check(n_known > 0, "no alignment with a known-indel event")
    for name in DNA_KERNELS:
        if name != "rescue_window":     # paired batches only (phase 9)
            check(launches[name] > 0,
                  f"{name} never launched on the graph path")
    path_launches["graph"] = launches
    phase_done("graph slice")

    tmp = tempfile.mkdtemp(prefix="h2torch_gcli_")
    try:
        with gzip.open(os.path.join(REPO, "tests/data/gdna_genome.fa.gz"),
                       "rb") as f, open(os.path.join(tmp, "g.fa"), "wb") as o:
            o.write(f.read())
        run_cli(["build", "--snp", os.path.join(REPO, "tests/data/gdna.snp"),
                 "g.fa", "idx"], tmp, env, 300)
        t0 = time.perf_counter()
        run_cli(["align", "--no-spliced-alignment", "-f", "-x", "idx", "-U",
                 os.path.join(REPO, "tests/data/gdna_reads.fa"), "-S",
                 "out.sam", "--device", "cuda"], tmp, env, 600)
        with open(os.path.join(tmp, "out.sam")) as f:
            got = [x for x in f if not x.startswith("@")]
        with gzip.open(os.path.join(REPO, "tests/data/gdna_ref.sam.gz"),
                       "rt") as f:
            want = f.readlines()
        check(got == want, "graph CLI SAM body differs from gdna_ref")
        nzs = sum("Zs:Z:" in x for x in got)
        print(f"[graph cli] align --device cuda on gdna: {len(got)} SAM "
              f"records ({nzs} with Zs:Z) equal to the oracle "
              f"({time.perf_counter() - t0:.1f} s incl. start-up)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("graph cli")

    # 9 paired DNA at config-3 shape: the graph index with k = 10, as
    # run_align sets it (bench.py:223-233, 318-330)
    del gal
    torch.cuda.empty_cache()
    from hisat2_tpu_torch.align.paired import PairPolicy
    from hisat2_tpu_torch.io.fasta import ReadBatch
    from hisat2_tpu_torch.ops import extend, rescue
    pal = TorchAligner(index, device="cuda", variants=db, k=10,
                       lane_meta=True)
    prng = np.random.default_rng(77)
    pb = []
    for bi in range(P_BATCHES + 1):
        m1, m2, q1, q2, pos1, pos2, snv1, snv2, plain = simulate_pairs(
            np, prng, g, cat, spots, B, L)
        nm = [f"q{bi}_{i}" for i in range(B)]
        pb.append((ReadBatch(nm, list(m1), list(q1)),
                   ReadBatch(list(nm), list(m2), list(q2)),
                   (pos1, pos2, snv1, snv2, plain)))
    run = PairRun(np, driver, pal, PairPolicy(), 10, index.meta.ref_names,
                  index.meta.ref_lens, annotate=pal.annotate_snps)
    # one batch through the paired loop: warm-up, and the real rescue
    # jobs, the keyword arguments of each rescue_candidates call
    b1, b2 = pb[0][:2]
    calls, restore = capture_rescue(rescue)
    try:
        run.run(pb[:1], lambda text, meta: None)
    finally:
        restore()
    check(calls, "no rescue job in the warm-up batch")
    cap = calls[0]
    chunks = [{k: c[k] for k in ("ref_words", "n_text", "reads",
                                 "win_start", "W")} for c in calls]
    kw = chunks[0]
    err, ms, pms = compare(torch, "rescue_window", *twins["rescue_window"],
                           kw)
    ks, ke = rescue.rescue_candidates(**cap)
    ps = rescue.rescue_window_plain(**kw)
    L9 = cap["reads"].shape[1]
    wins = [splice.diag_chars_plain(w_, cap["n_text"], ps, L9, 0)
            if w_ is not None else None
            for w_ in (cap["ref_words"], cap["snv_delta1"],
                       cap["snv_delta2"])]
    pe = extend.extend_grouped_plain(
        cap["n_text"], cap["reads"], cap["quals"], cap["lens"], ps,
        cap["mm_pen"], cap["clip_pen"], cap["n_pen"], wins[0], 0,
        allow_softclip=cap["allow_softclip"], snv1_win=wins[1],
        snv2_win=wins[2])
    torch.cuda.synchronize()
    check(torch.equal(ks, ps), "rescue_candidates starts")
    for f in ke._fields:
        check(torch.equal(getattr(ke, f), getattr(pe, f)),
              f"rescue_candidates {f}")
    # K6+K7 on the chunk's rescoring: 8 diagonals per job, no margin, no
    # minsc (ops/rescue.py)
    # K5 on the chunk's windows: the reference and SNV planes of its 8
    # diagonals per job in one launch, as rescue_candidates asks for them
    rkw = dict(planes=[w_ for w_ in (cap["ref_words"], cap["snv_delta1"],
                                     cap["snv_delta2"]) if w_ is not None],
               n_text=cap["n_text"], starts=[ks], margins=[0], L=L9)
    err_w, ms_w, pms_w = compare(torch, "ref_window", *twins["ref_window"],
                                 rkw)
    row = rows["ref_window"]
    row["max_abs_err"] = max(row["max_abs_err"], err_w)
    row["rescue_ms"], row["rescue_plain_ms"] = ms_w, pms_w
    print(f"[paired kernels] ref_window on the rescue chunk's "
          f"{len(rkw['planes'])} planes: equal to plain (tolerance: exact); "
          f"kernel {ms_w:.4f} ms, plain {pms_w:.4f} ms (median of 10)")
    wins_k = (splice.diag_chars_multi(**rkw)[0] + [None, None])[:3]
    ekw = dict(n_text=cap["n_text"], reads=cap["reads"], quals=cap["quals"],
               lens=cap["lens"], cand_start=ks, mm_pen=cap["mm_pen"],
               clip_pen=cap["clip_pen"], n_pen=cap["n_pen"],
               win_chars=wins_k[0],
               win_margin=0, allow_softclip=cap["allow_softclip"],
               uniform_len=False, minsc=None, snv1_win=wins_k[1],
               snv2_win=wins_k[2])
    err_e, ms_e, pms_e = compare(torch, "extend_ungapped",
                                 *twins["extend_ungapped"], ekw)
    row = rows["extend_ungapped"]
    row["max_abs_err"] = max(row["max_abs_err"], err_e)
    row["rescue_ms"], row["rescue_plain_ms"] = ms_e, pms_e
    print(f"[paired kernels] extend_ungapped on the rescue chunk "
          f"{tuple(ks.shape)}: equal to plain (tolerance: exact); kernel "
          f"{ms_e:.4f} ms, plain {pms_e:.4f} ms (median of 10)")
    step_shapes(splice, "rescue", {"extend_ungapped": ekw,
                                   "rescue_window": kw, "ref_window": rkw})
    # the batch's other rescue chunks (the last one padded with all-N jobs)
    for i, ckw in enumerate(chunks[1:], 1):
        e_i, ms_i, pms_i = compare(torch, "rescue_window",
                                   *twins["rescue_window"], ckw)
        err = max(err, e_i)
        npad = int((ckw["reads"] >= 4).all(1).sum())
        print(f"[paired kernels] rescue_window on rescue chunk {i} "
              f"{tuple(ckw['reads'].shape)} ({npad} padding jobs): equal to "
              f"plain (tolerance: exact); kernel {ms_i:.4f} ms, plain "
              f"{pms_i:.4f} ms (median of 10)")
        step_shapes(splice, f"rescue {i}", {"rescue_window": ckw})
    lib = rescue_library_ms(torch, kw)
    bounds["rescue_window"] = work(torch, "rescue_window", kw,
                                   twins["rescue_window"][0](**kw))
    k12 = kernels.KERNELS["rescue_window"]
    rows["rescue_window"] = {
        "name": "rescue_window", "route": "cuda", "source": k12.source,
        "replaces": k12.replaces, "max_abs_err": err, "paired_ms": ms,
        "paired_plain_ms": pms, "library_ms": lib,
        "bound_bf16_ms": rescue_bf16_bound(kw)}
    print(f"[paired kernels] rescue_window on {tuple(kw['reads'].shape)} "
          f"real rescue jobs (W {kw['W']}): equal to plain (tolerance: "
          f"exact), and the whole rescue_candidates call with SNV planes; "
          f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library (bf16 conv1d "
          f"+ topk) {lib:.4f} ms; bound {bounds['rescue_window'][0]:.4f} "
          f"ms by {bounds['rescue_window'][1]} at the int8 rate "
          f"({rows['rescue_window']['bound_bf16_ms']:.4f} at bf16's; median "
          f"of 10); {len(chunks)} rescue chunks in the batch")

    # the fused lite and full step: K4 and K9 on the whole batch's
    # arguments, and the step of its first P_CMP_B pairs against the CPU
    # step (phase 14 holds a fused spliced step's kernels against their
    # twins)
    pcpu = TorchAligner(index, device="cpu", variants=db, k=10,
                        lane_meta=True)
    nc = P_CMP_B
    fused = [np.concatenate([getattr(b1, f), getattr(b2, f)])
             for f in ("codes", "quals", "lens")]
    codes, quals, lens = (np.concatenate([getattr(b1, f)[:nc],
                                          getattr(b2, f)[:nc]])
                          for f in ("codes", "quals", "lens"))
    minsc = pal._minsc(lens)
    for tier in ("_fast", None):
        a = getattr(pal, tier) if tier else pal
        c = getattr(pcpu, tier) if tier else pcpu
        nm = "lite" if tier else "full"
        pcap = {}
        a.step(*a.upload(*fused, pal._minsc(fused[2])), True, capture=pcap)
        hold_slots(torch, f"paired step {nm}", pcap)
        del pcap
        t0 = time.perf_counter()
        bk = a.step(*a.upload(codes, quals, lens, minsc), True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = c.step(*c.upload(codes, quals, lens, minsc), True)
        w = bk.shape[1]
        check(torch.equal(bk.cpu(), bp), f"paired {nm} packed step")
        check(a._out_specs[w] == c._out_specs[w], f"paired {nm} _out_specs")
        print(f"[paired step] fused {nm} step, {2 * len(codes)} lanes: "
              f"packed [{bk.shape[0]}, {w}] equal to the CPU plain step; "
              f"card {1e3 * (t1 - t0):.1f} ms (host clock), CPU "
              f"{time.perf_counter() - t1:.1f} s")
    del pcpu

    # the main path: run_align's paired loop (align/driver.py), 3 deep
    pst = {"pairs": 0, "normal": 0, "conc": 0, "snv": 0, "snv_true": 0}

    def score(text, meta):
        pos1, pos2, snv1, snv2, plain = meta
        prim = primaries(text)
        conc = np.array([bool(prim[(i, 1)][0] & 2) for i in range(B)])
        pst["pairs"] += B
        pst["normal"] += int(plain.sum())
        pst["conc"] += int((conc & plain).sum())
        for m, (pos, sv) in ((1, (pos1, snv1)), (2, (pos2, snv2))):
            for i in np.flatnonzero(sv):
                fl, p = prim[(int(i), m)][:2]
                pst["snv"] += 1
                pst["snv_true"] += int(not fl & 4 and p == pos[i])

    run.reset()
    kernels.reset_counts()
    t_slice = run.run(pb[1:], score)
    launches = kernels.counts()
    conc_share = pst["conc"] / pst["normal"]
    snv_true = pst["snv_true"] / pst["snv"]
    print(f"[paired slice] {pst['pairs']} pairs ({2 * pst['pairs']} mates) "
          f"in {t_slice:.2f} s: {pst['pairs'] / t_slice:.1f} pairs/s on "
          f"{card}; concordant share {conc_share:.4f} of "
          f"{pst['normal']} pairs without a repeat or random mate; SNV-only "
          f"mates at their true position {snv_true:.4f} "
          f"({pst['snv_true']}/{pst['snv']}); rescue jobs "
          f"{run.st['jobs']}, rescued mates {run.st['rescued']}; launches "
          f"{launches}")
    print(f"[paired slice] {run.stages()}")
    check(conc_share >= 0.95, "concordant share < 0.95")
    check(snv_true >= 0.99, "SNV-only mates placed true < 99%")
    check(run.st["jobs"] > 0 and run.st["rescued"] > 0, "no rescue job or "
          "no rescued mate on the paired path")
    for name in DNA_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the paired "
              f"path")
    path_launches["paired"] = launches
    del pal
    torch.cuda.empty_cache()

    # the paired CLI on the committed corpus, linear and graph index
    tmp = tempfile.mkdtemp(prefix="h2torch_pcli_")
    data = os.path.join(REPO, "tests/data")
    try:
        with gzip.open(os.path.join(data, "pe_genome.fa.gz"), "rb") as f, \
                open(os.path.join(tmp, "g.fa"), "wb") as o:
            o.write(f.read())
        run_cli(["build", "g.fa", "idx"], tmp, env, 300)
        run_cli(["build", "--snp", os.path.join(data, "pe.snp"), "g.fa",
                 "idxs"], tmp, env, 300)
        t0 = time.perf_counter()
        runs = (("idx", "pe_ref"), ("idxs", "pe_ref_snp"))
        run_clis([["align", "--no-spliced-alignment", "-f", "-x", idx_name,
                   "-1", os.path.join(data, "pe_reads_1.fa"), "-2",
                   os.path.join(data, "pe_reads_2.fa"), "-S",
                   f"{oracle}.sam", "--device", "cuda"]
                  for idx_name, oracle in runs], tmp, env, 600)
        for idx_name, oracle in runs:
            with open(os.path.join(tmp, f"{oracle}.sam")) as f:
                got = [x for x in f if not x.startswith("@")]
            with gzip.open(os.path.join(data, oracle + ".sam.gz"),
                           "rt") as f:
                want = f.readlines()
            check(got == want, f"paired CLI SAM body differs from {oracle}")
            print(f"[paired cli] align -1 -2 --device cuda on {idx_name}: "
                  f"{len(got)} SAM records equal to {oracle}")
        print(f"[paired cli] both runs side by side "
              f"{time.perf_counter() - t0:.1f} s incl. start-up")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("paired")

    introns = spliced_phase(torch, np, g, index, kernels, twins, driver,
                            read_alignments, TorchAligner, rows, bounds,
                            path_launches, card, env)
    phase_done("spliced")

    genome_phase(torch, np, kernels, twins, driver, read_alignments,
                 TorchAligner, rows, bounds, path_launches, card, env)
    phase_done("genome")

    multi_phase(torch, np, index, batches[0], TorchAligner, build_fm_index,
                rows, path_launches, env)
    phase_done("multi")

    long_phase(torch, np, g, index, spots, kernels, driver, TorchAligner)
    phase_done("long")

    pairs_phase(torch, np, g, index, spots, introns, kernels, twins, driver,
                TorchAligner, rows, path_launches, card, env)
    phase_done("pairs")

    genotype_phase(torch, np, kernels, twins, g, cat, cache, rows,
                   path_launches, card, env)
    phase_done("genotype")

    for name, r in rows.items():
        if name == "sharded_align_step":
            continue                    # K21: complete from phase 12
        path = ("genome" if name in GENOME_KERNELS else "spliced"
                if name in SPLICED_KERNELS else "paired")
        r["launches"] = path_launches[path][name]
        for p2 in ("linear", "graph", "paired", "spliced", "genome",
                   "genome_graph", "genome_spliced", "pairs_spliced",
                   "pairs_shards", "genotype"):
            r[f"launches_{p2}"] = path_launches[p2][name]
        r["ms"] = r.get("full_ms", r.get("paired_ms", r.get("genome_ms")))
        r["plain_ms"] = r.get("full_plain_ms", r.get(
            "paired_plain_ms", r.get("genome_plain_ms")))
        r["bound_ms"], r["bound_by"] = bounds[name]
        r.setdefault("library_ms", None)
    print(f"[done] phase seconds {json.dumps(phase_s)}")
    print(json.dumps({"kernels": [rows[n] for n in kernels.KERNELS]
                      + [rows["sharded_align_step"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
