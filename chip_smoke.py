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
            4096-read batch, against its plain torch twin on the card:
            exact equality, median times of both
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
            intermediates (K5 on the SNV planes, K6+K7 and K8 with SNVs,
            K10+K11) against its plain twin; the whole lite and full step
            against the CPU step; 4 batches of reads carrying catalog
            alleles through dispatch/advance/collect, SAM with Zs
            tags: reads/s, aligned share, SNV-only reads at their true
            position (>= 99%), known-indel alignments (> 0), routed share,
            launch counts (all seven > 0); and the CLI on the committed
            graph corpus (tests/data/gdna_*) against its oracle
  9 paired  paired-end DNA at the shape of bench.py config 3 (paired
            100 bp mates, --fr, against the graph index, k = 10), 4096
            pairs per batch, one fused batch of 8192 mates: K12
            (rescue_window) on the phase's real rescue jobs against its
            plain twin, with the whole rescue_candidates call, and timed
            beside the library yardstick (a grouped bf16 conv1d plus
            topk); the fused lite and full step against the CPU step;
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
            counts (K13-K18 > 0); then K13+K14, K15, K16 (lite and full),
            K17 on a whole 4096-read full step (8192 lanes) and K18 on the
            slice's first merge against their plain twins, the lite and
            full step against the CPU step, and the CLI on the nss round
            trip and mj3x against their oracles
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
            through known sites on each shard (> 0); (f)
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

Each kernel's bound (the kernels line's bound_ms) is the larger of the
bytes it must move over 3.35 TB/s and its operations over the peak rate
of their type (`work` below states the count for each kernel).

Any failed check raises and exits non-zero.  Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.  The line
before the last is a JSON object with per-kernel numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import gzip
import io
import json
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
# the graph slice's SAM render (the carried quadratic read_alignments behind
# the Zs annotator) takes about 3 s per batch: 4 batches still route reads
# and launch every kernel
G_BATCHES = 4
GENOME = 40_000_000
# phase 9: 16 distinct 120 bp units, each 24 times at 18 kbp spacing
REP_UNITS, REP_COPIES, REP_SPACING, REP_BASE = 16, 24, 18_000, 2_000_000
P_BATCHES = 4
# the card's peaks (H100 SXM data sheet): HBM bytes/s, bf16 tensor-core
# flop/s, and the CUDA-core rate (its fp32 figure) used for the integer
# work of the kernels
HBM, BF16, CUDA_CORE = 3.35e12, 989e12, 67e12
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
N_CAN, N_SEMI, N_NONCAN, N_PAIRS = 400, 40, 40, 40
# phase 11: the shape of config 6 (BENCH_EXTRA.md:84-112) at chromosome
# scale: two 140 Mbp chromosomes, one shard each (150 Mbp shard limit), each
# sampled at the builder's off_rate 4; the graph catalog at the phase-8
# density over 280 Mbp
GS_CHR, GS_SHARD_BP = 140_000_000, 150_000_000
GS_BATCHES, GS_G_BATCHES, GS_S_BATCHES, GS_CMP_B = 8, 2, 4, 1024
GS_COUNTS = tuple(round(x * 2 * GS_CHR / 3.1e9)
                  for x in (11_000_000, 728_000, 555_000))


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
    flops per job) at the bf16 tensor-core rate."""
    ob = nbytes(torch, *flat_outputs(out))
    dense = nbytes(torch, *(v for k, v in kw.items() if k not in (
        "blocked", "sa", "sa_marked", "ref_words", "snv_delta1",
        "snv_delta2", "ip",
        "ilen", "ins_chars", "rkey", "r_ilen", "r_row")))
    rate = CUDA_CORE
    if name == "fm_search2":
        chars = int(kw["lens"].sum())
        extra, ops = chars * 176, chars * 40     # a 44-word row per char
    elif name == "compact_cands":
        rows = (kw["bot"] - kw["top"]).clamp(0, kw["P"])
        N, H = kw["top"].shape
        extra, ops = int(rows.sum()) * 4, N * (H * kw["P"]) ** 2
    elif name == "ref_window":
        extra, ops = ob // 16, ob                # a packed word per 16 chars
    elif name == "extend_ungapped":
        B, C = kw["cand_start"].shape
        extra, ops = 0, B * C * kw["reads"].shape[1] * 30
    elif name == "indel_sweep":
        N, C, _ = kw["ch"].shape
        extra = 0
        ops = N * C * kw["reads"].shape[1] * kw["max_gap"] * 4 * 8
    elif name == "pack_slots":
        _, N, K = kw["uni"].shape
        extra, ops = 0, N * K * K * 2
    elif name == "inject_indels":
        N, C = kw["starts"].shape
        extra = 0
        ops = N * C * 2 * kw["slots"] * kw["reads"].shape[1] * 10
    elif name == "rescue_window":
        R, L = kw["reads"].shape
        extra = R * ((kw["W"] + L - 1 + 15) // 16) * 4   # 2-bit windows
        ops, rate = 2 * 4 * kw["W"] * L * R, BF16
    elif name == "search_lanes_live":
        live = kw["cut"] >= kw["min_hit_len"]
        chars = int(kw["cut"][live].sum())
        extra, ops = chars * 176, chars * 40
    elif name == "pair_sweep":
        # planes (48 PWM factors + prefixes per column), then ~25 integer
        # ops per (pair, x)
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        extra = 0
        ops = N * C * (Lr + 1) * 60 + N * C * C * (Lr + 2) * 25
    elif name == "second_sweep":
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        extra = 0
        ops = N * C * (Lr + 1) * (60 + 2 * 30)
    elif name == "inject_known":
        N, C, W = kw["ch"].shape
        Lr = kw["reads"].shape[1]
        J = out["score"].shape[1]
        live = int(((out["x"] != 1) | (out["kind"] != 0)).sum())
        extra = N * J * 2 * 12 * 4               # the site-table probes
        ops = N * J * 40 + live * 2 * Lr * 12
    elif name == "merge_sites":
        extra, ops = 0, kw["kd"].shape[0] * 6 * 10
    elif name == "resolve_walk":
        # Each distinct live row (rows that repeat walk the same path) is
        # walked to its mark, and each fetch counted by the 32 B sectors
        # it needs (walk_sectors); then one sa_marked entry per marked
        # row; ~60 integer ops a fetch.  Dense: the mask of every row and
        # the row index of live rows
        live = kw["live"] if kw["live"] is not None else torch.ones_like(
            kw["row"], dtype=torch.bool)
        dense = kw["row"].numel() * (kw["live"] is not None) \
            + int(live.sum()) * 4
        sectors, fetches, marked = walk_sectors(
            torch, kw, torch.unique(kw["row"][live]))
        extra = sectors * 32 + marked * 4
        ops = fetches * 60
    else:
        raise KeyError(name)
    by = dense + extra + ob
    t_b, t_o = by / HBM * 1e3, ops / rate * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


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


def compare(torch, name, kern, plain, kw):
    """Kernel vs plain twin on the same inputs: exact equality.  Returns
    the max abs error (0) and both median times."""
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
    return err, median_ms(torch, kern, kw), median_ms(torch, plain, kw)


def run_cli(args, cwd, env, timeout):
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    check(r.returncode == 0, f"CLI {args[0]} failed: {r.stderr[-2000:]}")


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
    """Phase 10 (see the module docstring)."""
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
    path_launches["spliced"] = launches
    merge_kw = sal.splice_db.capture.get("merge_sites")
    check(merge_kw is not None, "no incremental site merge in the slice")

    # kernels vs plain on a whole 4096-read batch (8192 lanes), with the
    # slice's site tables (every site visible to these read ids)
    codes, quals, lens = sb[0][:3]
    minsc = sal._minsc(lens)
    uniform = bool(np.all(lens == L))
    rdids = 10 ** 7 + np.arange(B, dtype=np.int64)
    caps = {}
    for tier, a in (("lite", sal._fast), ("full", sal)):
        rd_t, ss = a._step_site_args(rdids)
        cap = {}
        a.step(*a.upload(codes, quals, lens, minsc), uniform, capture=cap,
               rdids=rd_t, ss=ss)
        caps[tier] = cap
    check("search_lanes_live" in caps["full"]
          and caps["full"]["search_lanes_live"]["reads"].shape[0] > 2048,
          "the full step's re-search is not in lane-list mode")
    todo = [("full", "search_lanes_live"), ("full", "pair_sweep"),
            ("full", "second_sweep"), ("lite", "inject_known"),
            ("full", "inject_known"), ("full", "compact_cands"),
            ("full", "pack_slots"), ("lite", "pack_slots")]
    for tier, name in todo:
        kw = caps[tier][name]
        err, ms, pms = compare(torch, name, *twins[name], kw)
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
            row[f"spliced_{tier}_ms"] = ms
            row[f"spliced_{tier}_plain_ms"] = pms
        print(f"[spliced kernels] {tier} {name}: equal to plain (tolerance: "
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

    # the lite and full step on the card against the CPU step
    cpu = TorchAligner(index, device="cpu", spliced=True, lane_meta=True)
    cdb = cpu.splice_db
    for k in ("sites", "_col_jl", "_col_jr", "_col_rdid"):
        setattr(cdb, k, getattr(sal.splice_db, k))
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
        print(f"[spliced step] {nm} step, {2 * B} lanes: packed "
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
            run_cli(["build", f"{tag}.fa", tag], tmp, env, 300)

        def body(path, opener=open):
            with opener(path, "rt") as f:
                return [x for x in f if not x.startswith("@")]

        t0 = time.perf_counter()
        run_cli(["align", "-f", "-x", "nss", "-U",
                 os.path.join(data, "nss_reads.fa"),
                 "--novel-splicesite-outfile", "novel.ss", "-S", "p1.sam",
                 "--device", "cuda"], tmp, env, 600)
        with open(os.path.join(tmp, "novel.ss")) as f, \
                open(os.path.join(data, "nss_ref_novel.ss")) as f2:
            check(f.read() == f2.read(), "novel.ss differs from the oracle")
        check(body(os.path.join(tmp, "p1.sam")) == body(
            os.path.join(data, "nss_ref_p1.sam.gz"), gzip.open),
            "nss p1 SAM body differs from nss_ref_p1")
        run_cli(["align", "-f", "-x", "nss", "-U",
                 os.path.join(data, "nss_reads.fa"),
                 "--novel-splicesite-infile",
                 os.path.join(data, "nss_ref_novel.ss"), "-S", "p2.sam",
                 "--device", "cuda"], tmp, env, 600)
        check(body(os.path.join(tmp, "p2.sam")) == body(
            os.path.join(data, "nss_ref_p2.sam.gz"), gzip.open),
            "nss p2 SAM body differs from nss_ref_p2")
        run_cli(["align", "-f", "-x", "mj3x", "-U",
                 os.path.join(data, "mj3x_reads.fa"), "-S", "mj3.sam",
                 "--device", "cuda"], tmp, env, 600)
        got = {x.split("\t")[0]: x for x in body(os.path.join(tmp,
                                                              "mj3.sam"))}
        want = {x.split("\t")[0]: x for x in body(
            os.path.join(data, "mj3x_ref.sam.gz"), gzip.open)}
        check(all(got.get(k) == v for k, v in want.items()
                  if k != "mj3_a25"), "mj3x SAM differs from mj3x_ref")
        print(f"[spliced cli] align --device cuda (spliced): nss p1 + "
              f"novel.ss, nss p2 with --novel-splicesite-infile and mj3x "
              f"({len(want)} reads) equal to their oracles "
              f"({time.perf_counter() - t0:.1f} s incl. start-up)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    al.step(*up, uniform, capture=cap)
    want = ["fm_search2", "resolve_walk", "compact_cands", "ref_window",
            "extend_ungapped", "indel_sweep", "pack_slots"]
    check(sorted(cap) == sorted(want), f"genome step captured {sorted(cap)}")
    check(cap["compact_cands"]["offs"] is not None
          and cap["fm_search2"]["blocked"].shape[1] == 49,
          "the sampled step did not search the 49-column rows and resolve "
          "through the walk")
    replay(cap, "genome")
    kw = cap["resolve_walk"]
    out = twins["resolve_walk"][0](**kw)
    bounds["resolve_walk"] = work(torch, "resolve_walk", kw, out)
    nlive = int(kw["live"].sum())
    steps = (out[kw["live"]].long() & 15).double().mean().item()
    print(f"[genome kernels] resolve_walk on {kw['row'].shape[0]} rows, "
          f"{nlive} live, {steps:.2f} steps per live row; bound "
          f"{bounds['resolve_walk'][0]:.4f} ms ({bounds['resolve_walk'][1]})")
    # K19 alone: the same rows without the live mask (every row walks)
    kwd = dict(kw, live=None)
    err, ms, pms = compare(torch, "resolve_walk", *twins["resolve_walk"], kwd)
    r = rows["resolve_walk"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["dense_ms"], r["dense_plain_ms"] = ms, pms
    r["dense_bound_ms"] = work(torch, "resolve_walk", kwd,
                               twins["resolve_walk"][0](**kwd))[0]
    print(f"[genome kernels] resolve_walk without the live mask (K19 "
          f"alone, all {kw['row'].shape[0]} rows): equal to plain; kernel "
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
        a.step(*a.upload(sc[0], sc[1], sc[2], a._minsc(sc[2])),
               bool(np.all(sc[2] == L)), capture=scap, rdids=rd_t, ss=ss,
               shard=1)
        check("resolve_walk" in scap
              and scap["inject_known"]["snv_delta1"] is not None
              and (tier == "lite" or (
                  "resolve_walk/research" in scap
                  and scap["pair_sweep"]["snv1_w"] is not None)),
              f"the config-6 {tier} step ran without the walk or its SNV "
              f"inputs")
        replay(scap, f"genome_c6_{tier}")
        if tier == "full":
            kw = scap["pair_sweep"]
            Cc = kw["starts"].shape[1]
            smem = (Cc * (L + 1) * 42 + 96 * 4 + 16
                    + (6 * Cc * Cc + Cc) * 4 + 64)
            bounds["pair_sweep_c6"] = work(torch, "pair_sweep", kw,
                                           twins["pair_sweep"][0](**kw))
            print(f"[genome config6] K13 at k = 10: C = {Cc} core "
                  f"diagonals, {smem} bytes of shared memory per block "
                  f"(SNV-forgiving prefix included); kernel "
                  f"{rows['pair_sweep']['genome_c6_full_ms']:.4f} ms on "
                  f"{kw['starts'].shape[0]} lanes, bound "
                  f"{bounds['pair_sweep_c6'][0]:.4f} ms "
                  f"({bounds['pair_sweep_c6'][1]})")
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
    # the slice, with the temp-site fixed point
    acc = {"can": 0, "can_true": 0, "snv": 0, "snv_true": 0, "clean": 0,
           "clean_true": 0, "collect": 0.0}
    known_al = [0, 0]
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
    path_launches["genome_spliced"] = slaunch
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
    t_build = kernels.build(force=True)
    kernels.load()
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
    al.step(*up, uniform, capture=cap)
    linear = ["fm_search2", "compact_cands", "ref_window", "extend_ungapped",
              "indel_sweep", "pack_slots"]
    check(sorted(cap) == sorted(linear), f"captured {sorted(cap)}")
    rows = {}
    for name in linear:
        err, ms, pms = compare(torch, name, *twins[name], cap[name])
        k = kernels.KERNELS[name]
        rows[name] = {"name": name, "route": "cuda", "source": k.source,
                      "replaces": k.replaces, "max_abs_err": err,
                      "linear_ms": ms, "linear_plain_ms": pms}
        shp = [tuple(v.shape) for v in cap[name].values()
               if torch.is_tensor(v)]
        print(f"[kernels] {name}: equal to plain (tolerance: exact), "
              f"max_abs_err {err}; kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(median of 10; inputs {shp[:4]})")
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
        a.step(*gup, True, capture=cap)
        want = linear[:4] + ["pack_slots"] + (
            ["inject_indels", "indel_sweep"] if tier == "full" else [])
        check(sorted(cap) == sorted(want), f"{tier} captured {sorted(cap)}")
        check(cap["extend_ungapped"]["snv1_win"] is not None,
              "graph extension without SNV windows")
        for name in want:
            err, ms, pms = compare(torch, name, *twins[name], cap[name])
            if tier == "full" or name not in bounds:
                # the bound at the shapes `ms` is taken at (the full pass)
                bounds[name] = work(torch, name, cap[name],
                                    twins[name][0](**cap[name]))
            row = rows.setdefault(name, {
                "name": name, "route": "cuda",
                "source": kernels.KERNELS[name].source,
                "replaces": kernels.KERNELS[name].replaces,
                "max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row[f"{tier}_ms"], row[f"{tier}_plain_ms"] = ms, pms
            print(f"[graph kernels] {tier} {name}: equal to plain "
                  f"(tolerance: exact); kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms (median of 10)")
        if tier == "full":
            inj = splice.inject_indels(**cap["inject_indels"])
            live = int((inj["event"] >= 0).sum())
            check(live > 0, "no injected known-indel slot in the batch")
            rw = cap["ref_window"]
            for pl in ("snv1", "snv2"):
                kw = dict(rw, ref_words=gd[pl])
                err, ms, pms = compare(torch, f"ref_window[{pl}]",
                                       *twins["ref_window"], kw)
                rows["ref_window"][f"{pl}_ms"] = ms
                rows["ref_window"][f"{pl}_plain_ms"] = pms
                print(f"[graph kernels] ref_window on the {pl} plane: equal "
                      f"to plain; kernel {ms:.4f} ms, plain {pms:.4f} ms")
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
                   pos1, pos2, snv1, snv2, plain))
    policy = PairPolicy()
    jobs = {"n": 0, "rescued": 0, "ms": 0.0}
    orig_rescue = pal.rescue_mates

    def rescue_rec(*a):
        t = time.perf_counter()
        out = orig_rescue(*a)
        jobs["ms"] += 1e3 * (time.perf_counter() - t)
        jobs["n"] += len(a[0])
        jobs["rescued"] += sum(1 for x in out if x)
        return out

    pal.rescue_mates = rescue_rec

    class TimedWriter:
        """The SAM writer, with the time spent in write_pair (render)."""

        def __init__(self, w):
            self.w, self.ms = w, 0.0

        def write_pair(self, *a, **k):
            t = time.perf_counter()
            self.w.write_pair(*a, **k)
            self.ms += 1e3 * (time.perf_counter() - t)

    def pair_writer(sink):
        return TimedWriter(driver.SamWriter(
            sink, list(index.meta.ref_names), index.meta.ref_lens,
            no_head=True, annotator=pal.annotate_snps))

    ref_fn = lambda pos, span: pal.ref_codes[pos:pos + span]  # noqa: E731
    # one batch through _align_pair_batch: warm-up, and the real rescue
    # jobs, the keyword arguments of its first rescue_candidates call
    b1, b2 = pb[0][:2]
    rd0 = np.arange(B, dtype=np.int64)
    cap = {}
    orig_cands = rescue.rescue_candidates

    def cands_rec(**kw):
        if not cap:
            cap.update(kw)
        return orig_cands(**kw)

    rescue.rescue_candidates = cands_rec
    try:
        driver._align_pair_batch(pal, pair_writer(io.StringIO()), policy,
                                 pal.scoring, 10, b1, b2, ref_fn, rd0)
    finally:
        rescue.rescue_candidates = orig_cands
    check(cap, "no rescue job in the warm-up batch")
    kw = {k: cap[k] for k in ("ref_words", "n_text", "reads", "win_start",
                              "W")}
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
    lib = rescue_library_ms(torch, kw)
    bounds["rescue_window"] = work(torch, "rescue_window", kw,
                                   twins["rescue_window"][0](**kw))
    k12 = kernels.KERNELS["rescue_window"]
    rows["rescue_window"] = {
        "name": "rescue_window", "route": "cuda", "source": k12.source,
        "replaces": k12.replaces, "max_abs_err": err, "paired_ms": ms,
        "paired_plain_ms": pms, "library_ms": lib}
    print(f"[paired kernels] rescue_window on {tuple(kw['reads'].shape)} "
          f"real rescue jobs (W {kw['W']}): equal to plain (tolerance: "
          f"exact), and the whole rescue_candidates call with SNV planes; "
          f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library (bf16 conv1d "
          f"+ topk) {lib:.4f} ms; bound {bounds['rescue_window'][0]:.4f} "
          f"ms by {bounds['rescue_window'][1]} (median of 10)")

    # the fused lite and full step against the CPU step, on one batch
    pcpu = TorchAligner(index, device="cpu", variants=db, k=10,
                        lane_meta=True)
    codes = np.concatenate([b1.codes, b2.codes])
    quals = np.concatenate([b1.quals, b2.quals])
    lens = np.concatenate([b1.lens, b2.lens])
    minsc = pal._minsc(lens)
    for tier in ("_fast", None):
        a = getattr(pal, tier) if tier else pal
        c = getattr(pcpu, tier) if tier else pcpu
        t0 = time.perf_counter()
        bk = a.step(*a.upload(codes, quals, lens, minsc), True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = c.step(*c.upload(codes, quals, lens, minsc), True)
        w = bk.shape[1]
        nm = "lite" if tier else "full"
        check(torch.equal(bk.cpu(), bp), f"paired {nm} packed step")
        check(a._out_specs[w] == c._out_specs[w], f"paired {nm} _out_specs")
        print(f"[paired step] fused {nm} step, {2 * len(codes)} lanes: "
              f"packed [{bk.shape[0]}, {w}] equal to the CPU plain step; "
              f"card {1e3 * (t1 - t0):.1f} ms (host clock), CPU "
              f"{time.perf_counter() - t1:.1f} s")
    del pcpu

    # the main path: run_align's paired loop (align/driver.py), 3 deep
    pst = {"pairs": 0, "normal": 0, "conc": 0, "snv": 0, "snv_true": 0,
           "collect_ms": 0.0, "batch_ms": 0.0, "render_ms": 0.0}
    orig_collect = pal.collect

    def collect_timed(h, paired=False):
        t = time.perf_counter()
        out = orig_collect(h, paired=paired)
        pst["collect_ms"] += 1e3 * (time.perf_counter() - t)
        return out

    pal.collect = collect_timed
    jobs.update(n=0, rescued=0, ms=0.0)

    def finish(item):
        b1_, b2_, rd_, h_, meta = item
        pos1, pos2, snv1, snv2, plain = meta
        sink = io.StringIO()
        wr = pair_writer(sink)
        t = time.perf_counter()
        driver._align_pair_batch(pal, wr, policy, pal.scoring, 10, b1_, b2_,
                                 ref_fn, rd_, handle=h_)
        pst["batch_ms"] += 1e3 * (time.perf_counter() - t)
        pst["render_ms"] += wr.ms
        prim = {}
        for line in sink.getvalue().splitlines():
            f = line.split("\t", 4)
            flag = int(f[1])
            if flag & 256:
                continue
            prim[(int(f[0].rsplit("_", 1)[1]), 1 if flag & 64 else 2)] = (
                flag, int(f[3]) - 1)
        conc = np.array([bool(prim[(i, 1)][0] & 2) for i in range(B)])
        pst["pairs"] += B
        pst["normal"] += int(plain.sum())
        pst["conc"] += int((conc & plain).sum())
        for m, (pos, sv) in ((1, (pos1, snv1)), (2, (pos2, snv2))):
            for i in np.flatnonzero(sv):
                fl, p = prim[(int(i), m)]
                pst["snv"] += 1
                pst["snv_true"] += int(not fl & 4 and p == pos[i])

    kernels.reset_counts()
    t0 = time.perf_counter()
    pend = deque()
    for bi, (b1_, b2_, *meta) in enumerate(pb[1:]):
        rd_ = bi * B + np.arange(B, dtype=np.int64)
        pend.append((b1_, b2_, rd_,
                     driver._dispatch_pair_batch(pal, b1_, b2_, rd_), meta))
        if len(pend) >= 2:
            p1, p2, pr, (ph, plens), pm = pend[-2]
            pend[-2] = (p1, p2, pr, (pal.advance(ph, paired=True), plens),
                        pm)
        if len(pend) >= 3:
            finish(pend.popleft())
    while pend:
        finish(pend.popleft())
    t_slice = time.perf_counter() - t0
    launches = kernels.counts()
    pal.collect, pal.rescue_mates = orig_collect, orig_rescue
    nb = len(pb) - 1
    conc_share = pst["conc"] / pst["normal"]
    snv_true = pst["snv_true"] / pst["snv"]
    pairing = (pst["batch_ms"] - pst["collect_ms"] - jobs["ms"]
               - pst["render_ms"]) / nb
    print(f"[paired slice] {pst['pairs']} pairs ({2 * pst['pairs']} mates) "
          f"in {t_slice:.2f} s: {pst['pairs'] / t_slice:.1f} pairs/s on "
          f"{card}; concordant share {conc_share:.4f} of "
          f"{pst['normal']} pairs without a repeat or random mate; SNV-only "
          f"mates at their true position {snv_true:.4f} "
          f"({pst['snv_true']}/{pst['snv']}); rescue jobs {jobs['n']}, "
          f"rescued mates {jobs['rescued']}; launches {launches}")
    print(f"[paired slice] host ms per batch: collect (device wait + host "
          f"phases) {pst['collect_ms'] / nb:.1f}, pairing (give-up replay, "
          f"best_pairs, finalize, MAPQ) {pairing:.1f}, rescue "
          f"{jobs['ms'] / nb:.1f}, render {pst['render_ms'] / nb:.1f}; "
          f"whole _align_pair_batch {pst['batch_ms'] / nb:.1f}")
    check(conc_share >= 0.95, "concordant share < 0.95")
    check(snv_true >= 0.99, "SNV-only mates placed true < 99%")
    check(jobs["n"] > 0 and jobs["rescued"] > 0, "no rescue job or no "
          "rescued mate on the paired path")
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
        for idx_name, oracle in (("idx", "pe_ref"), ("idxs", "pe_ref_snp")):
            t0 = time.perf_counter()
            run_cli(["align", "--no-spliced-alignment", "-f", "-x",
                     idx_name, "-1", os.path.join(data, "pe_reads_1.fa"),
                     "-2", os.path.join(data, "pe_reads_2.fa"), "-S",
                     "out.sam", "--device", "cuda"], tmp, env, 600)
            with open(os.path.join(tmp, "out.sam")) as f:
                got = [x for x in f if not x.startswith("@")]
            with gzip.open(os.path.join(data, oracle + ".sam.gz"),
                           "rt") as f:
                want = f.readlines()
            check(got == want, f"paired CLI SAM body differs from {oracle}")
            print(f"[paired cli] align -1 -2 --device cuda on {idx_name}: "
                  f"{len(got)} SAM records equal to {oracle} "
                  f"({time.perf_counter() - t0:.1f} s incl. start-up)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("paired")

    spliced_phase(torch, np, g, index, kernels, twins, driver,
                  read_alignments, TorchAligner, rows, bounds, path_launches,
                  card, env)
    phase_done("spliced")

    genome_phase(torch, np, kernels, twins, driver, read_alignments,
                 TorchAligner, rows, bounds, path_launches, card, env)
    phase_done("genome")

    multi_phase(torch, np, index, batches[0], TorchAligner, build_fm_index,
                rows, path_launches, env)
    phase_done("multi")

    for name, r in rows.items():
        if name == "sharded_align_step":
            continue                    # K21: complete from phase 12
        path = ("genome" if name in GENOME_KERNELS else "spliced"
                if name in SPLICED_KERNELS else "paired")
        r["launches"] = path_launches[path][name]
        for p2 in ("linear", "graph", "paired", "spliced", "genome",
                   "genome_graph", "genome_spliced"):
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
