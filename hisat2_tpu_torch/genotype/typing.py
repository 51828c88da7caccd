"""Allele abundance EM + allele calling (reference:
hisatgenotype_modules/hisatgenotype_typing_common.py:908-1013
single_abundance; hisatgenotype_locus.py:1319-1380 typing flow).

Reads collapse into COMPATIBILITY CLASSES: each class is the set of
alleles a read aligns to equally best, with a count of member reads.
The EM distributes class counts across alleles proportional to the
current allele probabilities, normalized by allele length, with the
SQUAREM acceleration step (Varadhan & Roland 2008, as in Sailfish) the
reference uses.  Alleles below a tenth of the max drop after 10
iterations (select_alleles) — the reference's convergence accelerator.

The vectorized formulation: classes form a sparse membership matrix
M [n_classes, n_alleles]; one EM step is two matrix products — MXU
work at scale, numpy here (class counts are tiny after collapsing).

Copied verbatim from hisat2_tpu/genotype/typing.py; only the imports,
and the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import math

import numpy as np


def em_abundance(cmpt: dict, lengths: dict, exonic: bool = False):
    """cmpt: {"alleleA-alleleB-...": read_count}; lengths: {allele: bp}.
    Returns [(allele, prob)] sorted by prob desc, then name (the
    reference sorts with Gene_prob_cmp: prob desc, fewer '*'-fields
    first, name asc)."""
    alleles = sorted({a for k in cmpt for a in k.split("-")})
    ai = {a: i for i, a in enumerate(alleles)}
    n = len(alleles)
    if n == 0:
        return []
    classes = list(cmpt.items())
    counts = np.array([c for _, c in classes], np.float64)
    memb = np.zeros((len(classes), n), bool)
    for r, (k, _) in enumerate(classes):
        for a in k.split("-"):
            memb[r, ai[a]] = True
    ln = np.array([lengths.get(a, 1) for a in alleles], np.float64)

    def normalize(p):
        if exonic:
            return p / p.sum()
        q = p / ln
        return q / q.sum()

    def next_prob(p):
        # distribute each class's count across member alleles by p
        denom = memb @ p                                  # [n_classes]
        w = np.where(denom > 0, counts / np.maximum(denom, 1e-300), 0.0)
        return normalize((memb * p[None, :]).T @ w)

    # initial: split each class count evenly across member alleles
    p = normalize(memb.T @ (counts / memb.sum(axis=1)))
    live = np.ones(n, bool)
    diff, it = 1.0, 0
    while diff > 1e-4 and it < 1000:
        p1 = next_prob(p)
        # SQUAREM acceleration (typing_common.py:972-988)
        p2 = next_prob(p1)
        r = p1 - p
        v = p2 - p1 - r
        ssv = float(v @ v)
        if ssv > 0.0:
            gamma = -math.sqrt(float(r @ r) / ssv)
            p2 = np.maximum(0.0, p - 2 * gamma * r + gamma * gamma * v)
            p1 = next_prob(p2)
        diff = float(np.abs(p - p1)[live].sum())
        p = p1
        if it >= 10:
            # select_alleles: drop below max/10
            live &= p >= p[live].max() / 10.0
            p = np.where(live, p, 0.0)
            s = p.sum()
            if s > 0:
                p = p / s
        it += 1
    live &= p >= (p[live].max() / 10.0 if live.any() else 0)
    p = np.where(live, p, 0.0)
    if p.sum() > 0:
        p = p / p.sum()
    out = [(alleles[i], float(p[i])) for i in range(n) if live[i]]
    out.sort(key=lambda t: (-t[1], t[0].count("*"), t[0]))
    return out


def compatibility_classes(read_alleles: dict) -> dict:
    """{read_name: set(alleles)} -> {'a-b-c': count} with alleles sorted
    (the reference joins allele names with '-', locus typing flow)."""
    cmpt = {}
    for _, alset in read_alleles.items():
        if not alset:
            continue
        key = "-".join(sorted(alset))
        cmpt[key] = cmpt.get(key, 0) + 1
    return cmpt


def call_diploid(ranked, min_abundance: float = 0.1):
    """Diploid allele call: the top allele, plus the runner-up when its
    abundance clears 10% (hisatgenotype_locus.py:1372: pairs below 10%
    collapse to a homozygous call)."""
    if not ranked:
        return []
    calls = [ranked[0][0]]
    if len(ranked) > 1 and ranked[1][1] >= min_abundance:
        calls.append(ranked[1][0])
    else:
        calls.append(ranked[0][0])
    return calls


def pair_loglikelihood(cmpt: dict, top: int = 5):
    """Diploid pair log-likelihoods, li_hla style (the standalone HLA
    checker, hisat2's li_hla/main.cpp: for each allele pair (a,b)
    the likelihood of a read is the mean of its per-haplotype
    compatibilities, L(a,b) = sum_r w_r * log((P(r|a) + P(r|b)) / 2)
    with P(r|x) = 1 if the read's compatibility class contains x else a
    small error floor).  cmpt: {'a-b-...': count} compatibility classes.
    Returns [(allele_a, allele_b, loglik)] sorted desc, top pairs."""
    import itertools
    import math

    alleles = sorted({a for k in cmpt for a in k.split("-")})
    if not alleles:
        return []
    ERR = 1e-4                     # mismatch/error floor per read
    classes = [(set(k.split("-")), n) for k, n in cmpt.items()]
    out = []
    for a, b in itertools.combinations_with_replacement(alleles, 2):
        ll = 0.0
        for alset, n in classes:
            pa = 1.0 if a in alset else ERR
            pb = 1.0 if b in alset else ERR
            ll += n * math.log((pa + pb) / 2.0)
        out.append((a, b, ll))
    out.sort(key=lambda t: -t[2])
    return out[:top]


def variant_compatibility(backbone, allele_vars, var_ids, allele_spans,
                          aligned_reads, editdist: int = 2):
    """Variant-set compatibility (hisatgenotype_locus.py typing: a read
    is compatible with the alleles whose variant set it matches over the
    covered span; distance = symmetric difference of the read's observed
    variant set vs each allele's, bounded by --num-editdist).

    aligned_reads entries are either the legacy (name, start,
    codes_on_bb) — one gapless segment — or (name, segments, indels)
    with segments = [(start, codes_on_bb)] and indels = observed
    catalog-indel keys [('D', pos, len) | ('I', pos, seq)] from the
    alignment's junction structure (STR/CODIS alleles differ only by
    such indels).  Returns {read_name: set(allele)}.
    """
    alleles = sorted(allele_vars)
    ai = {a: i for i, a in enumerate(alleles)}
    A = len(alleles)
    snv = [(v, i) for v, i in var_ids.items() if v[0] == "S"]
    snv.sort(key=lambda t: t[0][1])
    vpos = np.array([v[1] for v, _ in snv], np.int64)
    vbase = np.array(["ACGT".index(v[2]) for v, _ in snv], np.int8)
    memb = np.zeros((len(snv), A), bool)
    key_to_row = {}
    for r, (v, _) in enumerate(snv):
        key_to_row[(v[1], int(vbase[r]))] = r
    for a, vs in allele_vars.items():
        for v in vs:
            if v[0] == "S":
                memb[key_to_row[(v[1], "ACGT".index(v[2]))], ai[a]] = True
    # indel variants: membership + position index for span counting
    ind = sorted({v for v in var_ids if v[0] != "S"},
                 key=lambda v: (v[1], v[0], str(v[2])))
    ind_row = {v: r for r, v in enumerate(ind)}
    ipos = np.array([v[1] for v in ind], np.int64)
    imemb = np.zeros((len(ind), A), bool)
    for a, vs in allele_vars.items():
        for v in vs:
            if v[0] != "S":
                imemb[ind_row[v], ai[a]] = True
    span_lo = np.array([allele_spans[a][0] for a in alleles], np.int64)
    span_hi = np.array([allele_spans[a][1] for a in alleles], np.int64)

    dists = {}
    bb = np.asarray(backbone)
    for rec in aligned_reads:
        if len(rec) == 3 and isinstance(rec[1], (int, np.integer)):
            name, start, codes = rec
            segs, indels = [(start, codes)], []
        else:
            name, segs, indels = rec
        known_rows, unknown = [], 0
        in_span = np.zeros(A, np.int64)
        lo_all, hi_all = None, None
        bad = False
        for start, codes in segs:
            e = start + len(codes)
            if e > len(bb) or start < 0:
                bad = True
                break
            ref = bb[start:e]
            for p in np.flatnonzero(codes != ref):
                r = key_to_row.get((start + int(p), int(codes[p])))
                if r is None:
                    unknown += 1
                else:
                    known_rows.append(r)
            lo = np.searchsorted(vpos, start)
            hi = np.searchsorted(vpos, e)
            in_span += memb[lo:hi].sum(axis=0).astype(np.int64)
            lo_all = start if lo_all is None else min(lo_all, start)
            hi_all = e if hi_all is None else max(hi_all, e)
        if bad or lo_all is None:
            continue
        match = (memb[known_rows].sum(axis=0).astype(np.int64)
                 if known_rows else np.zeros(A, np.int64))
        dist = len(known_rows) + unknown + in_span - 2 * match
        # indel symmetric difference over the read's span
        if len(ind):
            ilo = np.searchsorted(ipos, lo_all)
            ihi = np.searchsorted(ipos, hi_all)
            ind_in_span = imemb[ilo:ihi].sum(axis=0).astype(np.int64)
            obs_rows, obs_unknown = [], 0
            for k in indels:
                r = ind_row.get(k)
                if r is None:
                    obs_unknown += 1
                else:
                    obs_rows.append(r)
            imatch = (imemb[obs_rows].sum(axis=0).astype(np.int64)
                      if obs_rows else np.zeros(A, np.int64))
            dist += len(obs_rows) + obs_unknown + ind_in_span - 2 * imatch
        elif indels:
            dist += len(indels)
        covered = (span_lo <= lo_all) & (span_hi >= hi_all)
        dist = np.where(covered, dist, np.int64(10 ** 6))
        # multiple records per read = alternative placements of the
        # same read (e.g. a free catalog indel inside a repeat vs the
        # clean shifted diagonal): keep the elementwise-min distance
        if name in dists:
            dists[name] = np.minimum(dists[name], dist)
        else:
            dists[name] = dist
    out = {}
    for name, dist in dists.items():
        dmin = dist.min()
        if dmin > editdist:
            continue
        out[name] = {alleles[i] for i in np.flatnonzero(dist == dmin)}
    return out
