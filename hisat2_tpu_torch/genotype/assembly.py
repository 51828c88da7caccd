"""Two-haplotype assembly from typed reads.

Behavioral equivalent of the reference's guided De Bruijn assembly
(hisat2's hisatgenotype_modules/hisatgenotype_assembly_graph.py
Graph.guided_DeBruijn + Node.combine_with, used by
hisatgenotype_locus.py --assembly): reconstruct the TWO haplotype
sequences of a diploid sample from reads aligned to the locus backbone,
using the known variant catalog as the guide.

The reference walks read-node dictionaries and merges compatible nodes
pairwise; here the same phasing problem is one dense matrix: a
[reads x variants] observation matrix in {-1 ref, +1 alt, 0 uncovered},
partitioned into two groups by iterative consensus refinement (the
vectorized form of node merging — each iteration is two matmuls), then
each group's consensus variant set is applied to the backbone.

Copied verbatim from hisat2_tpu/genotype/assembly.py; only the imports,
and the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np


def observe_variants(snv_pos, snv_alt_code, aligned):
    """Per-read variant observations.

    snv_pos:      [V] int backbone positions of catalog SNVs
    snv_alt_code: [V] int 0..3 alt base codes
    aligned:      [(name, backbone_pos, codes)] clipped read placements
    -> obs [R, V] int8 (+1 alt, -1 other base, 0 uncovered), names list
    """
    V = len(snv_pos)
    obs = np.zeros((len(aligned), V), np.int8)
    names = []
    snv_pos = np.asarray(snv_pos)
    snv_alt_code = np.asarray(snv_alt_code)
    for r, (name, pos, codes) in enumerate(aligned):
        names.append(name)
        inside = (snv_pos >= pos) & (snv_pos < pos + len(codes))
        idx = np.flatnonzero(inside)
        got = codes[snv_pos[idx] - pos]
        obs[r, idx] = np.where(got == snv_alt_code[idx], 1, -1)
    return obs, names


def classify_zygosity(obs, het_band=(0.15, 0.85), min_cov: int = 2):
    """Per-variant call from pooled coverage: 2 hom-alt, 1 het, 0
    hom-ref/uncalled.  -> zyg [V] int8."""
    alt = (obs > 0).sum(axis=0)
    cov = (obs != 0).sum(axis=0)
    frac = alt / np.maximum(cov, 1)
    zyg = np.zeros(obs.shape[1], np.int8)
    ok = cov >= min_cov
    zyg[ok & (frac >= het_band[1])] = 2
    zyg[ok & (frac > het_band[0]) & (frac < het_band[1])] = 1
    return zyg


def phase_het_vars(obs, het_idx):
    """Phase heterozygous variants into two complementary alt sets.

    Link matrix Lm[i, j] = sum_r obs[r, i] * obs[r, j] over reads — the
    co-occurrence evidence (positive: the same haplotype carries both
    alts).  Signs propagate over a maximum-evidence spanning forest (the
    vectorized analog of the reference's left-to-right node merging in
    guided_DeBruijn).  -> s [H] in {+1, -1} (+1: haplotype 1 has alt)."""
    o = obs[:, het_idx].astype(np.int32)
    H = o.shape[1]
    Lm = o.T @ o
    np.fill_diagonal(Lm, 0)
    s = np.zeros(H, np.int8)
    block = np.full(H, -1, np.int32)
    order = np.argsort(-np.abs(Lm).sum(axis=1))
    nblk = 0
    for root in order:
        if s[root]:
            continue
        s[root] = 1
        block[root] = nblk
        frontier = [root]
        while frontier:
            nxt = []
            for i in frontier:
                link = Lm[i]
                for j in np.flatnonzero((link != 0) & (s == 0)):
                    s[j] = s[i] * (1 if link[j] > 0 else -1)
                    block[j] = nblk
                    nxt.append(j)
            frontier = nxt
        nblk += 1
    # orient each block so +1 is the MAJORITY haplotype: per-block read
    # agreement with s decides (the abundance-guided orientation the
    # reference gets from its EM ranking); 50:50 samples keep per-block
    # naming ambiguity, which is inherent to phasing
    for b in range(nblk):
        in_b = block == b
        a = o[:, in_b] @ s[in_b].astype(np.int32)
        if (a < 0).sum() > (a > 0).sum():
            s[in_b] = -s[in_b]
    return s, block


def assign_reads(obs, het_idx, s):
    """Group reads by agreement with the phased haplotypes; het-blind
    reads (no informative site, score 0) -> -1 (both haplotypes)."""
    score = obs[:, het_idx].astype(np.int32) @ s.astype(np.int32)
    out = np.where(score < 0, 1, 0).astype(np.int32)
    out[score == 0] = -1
    return out


def assemble(backbone_codes, snv_pos, snv_alt_code, aligned,
             min_cov: int = 2):
    """-> (two assembled haplotype code arrays, assign, coverage [2, L]).

    Assembly = backbone + hom-alt calls on both haplotypes + phased het
    alts split between them; coverage counts reads per position per
    group."""
    obs, _names = observe_variants(snv_pos, snv_alt_code, aligned)
    zyg = classify_zygosity(obs, min_cov=min_cov)
    het_idx = np.flatnonzero(zyg == 1)
    s = (phase_het_vars(obs, het_idx)[0] if het_idx.size
         else np.zeros(0, np.int8))
    assign = (assign_reads(obs, het_idx, s) if het_idx.size
              else np.full(len(aligned), -1, np.int32))
    L = len(backbone_codes)
    snv_pos = np.asarray(snv_pos)
    snv_alt_code = np.asarray(snv_alt_code)
    haps, cov = [], np.zeros((2, L), np.int32)
    for g, sign in ((0, 1), (1, -1)):
        take = (zyg == 2).copy()
        take[het_idx[s == sign]] = True
        h = np.asarray(backbone_codes).copy()
        h[snv_pos[take]] = snv_alt_code[take]
        haps.append(h)
    for r, (_n, pos, codes) in enumerate(aligned):
        for g in ((0, 1) if assign[r] < 0 else (assign[r],)):
            cov[g, pos:pos + len(codes)] += 1
    return haps, assign, cov
