"""What decides `correct`: every read fed has exactly one primary record,
every record of a sample of reads drawn from the seed is exact under the
plain reference (check.py), and the share of sampled reads whose primary
alignment scores below the alignment they were made from stays under the
cell's limit.  Imports nothing of the program."""

from __future__ import annotations

import numpy as np

from .check import Checker, Record, check_pair, check_read

_ASC = np.frombuffer(b"ACGTN", np.uint8)
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def checker(dep, cfg):
    return Checker(dep.genome, dep.chrom_names, dep.chrom_starts,
                   dep.chrom_lens, dep.catalog,
                   dep.known_ss if cfg.get("ss_index") else (),
                   graph=bool(cfg.get("snp_index")))


def fed_read(m, i):
    """(SEQ, QUAL) bytes of read i as fed."""
    L = int(m.lens[i])
    return (_ASC[np.minimum(m.codes[i, :L], 4)].tobytes(),
            (m.quals[i, :L] + 33).astype(np.uint8).tobytes())


def origin_score(ck, m, i, cigar_of):
    """The score of the alignment read i was made from (None where it has
    none: a random mate)."""
    if m.start[i] < 0:
        return None
    seq, qual = fed_read(m, i)
    if m.rc[i]:
        seq, qual = seq.translate(_COMP)[::-1], qual[::-1]
    return ck.score_origin(int(m.start[i]), cigar_of(m, i), seq,
                           list(qual))


def below(origin, got, minsc):
    """1 where the origin passes --score-min and the primary alignment
    (None: unaligned) scores below it, 0 where it does not, None where
    the read is not counted."""
    if origin is None or origin < minsc:
        return None
    return int(got is None or got < origin)


def sample(traffic, fed, k, seed):
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x51])
    k = min(int(k), fed)
    return np.sort(rng.choice(fed, k, replace=False)) if k else \
        np.zeros(0, np.int64)


def judge(dep, traffic, wl, cfg, lines, fed, seed, log, cigar_of=None):
    """(checks, attempted, failed) of one run's SAM lines."""
    if cigar_of is None:
        from h100_bench.traffic.reads import origin_cigar as cigar_of
    nm = len(traffic.mates)
    prim = np.zeros((nm, max(fed, 1)), np.int32)
    stray = 0
    picks = sample(traffic, fed, wl["sample"], seed)
    want = {traffic.name(int(i)).encode() for i in picks}
    recs = {}
    for ln, _ in lines:
        f = ln.split(b"\t", 2)
        name, flag = f[0], int(f[1])
        i = int(name[1:]) if name[:1] == b"r" and name[1:].isdigit() else -1
        if not 0 <= i < fed:
            stray += 1
            continue
        if not flag & 0x900:
            prim[1 if (nm == 2 and flag & 0x80) else 0, i] += 1
        if name in want:
            recs.setdefault(name.decode(), []).append(Record(ln))
    prim = prim[:, :fed]
    failed = int((prim == 0).sum())
    dup = int((prim > 1).sum())
    ck = checker(dep, cfg)
    bad, shown = 0, 0
    nb, nbase = 0, 0
    for i in picks:
        i = int(i)
        name = traffic.name(i)
        rs = recs.get(name, [])
        q = i % traffic.n                  # the stream repeats the pool
        fed_rs = [fed_read(m, q) for m in traffic.mates]
        if nm == 1:
            errs, p = check_read(ck, rs, *fed_rs[0], int(len(fed_rs[0][0])))
            prims = [p] if p is not None else None
        else:
            errs, p = check_pair(ck, rs, fed_rs)
            prims = [p[1], p[2]] if p is not None else None
        if errs:
            bad += 1
            if shown < 8:
                shown += 1
                log(f"[check] {name}: " + "; ".join(errs[:4]))
        if prims is None:
            continue
        for k, m in enumerate(traffic.mates):
            o = origin_score(ck, m, q, cigar_of)
            pr = prims[k]
            got = None if pr.flag & 0x4 else pr.tags.get("AS")
            b = below(o, got, ck.sc.min_score(int(m.lens[q])))
            if b is not None:
                nbase += 1
                nb += b
    lim = wl["limits"]
    checks = {
        "missing_reads": {"value": failed + dup + stray,
                          "limit": lim["missing_reads"]},
        "bad_records": {"value": bad, "limit": lim["bad_records"]},
        "below_origin_pct": {"value": 100.0 * nb / nbase if nbase else 0.0,
                             "limit": lim["below_origin_pct"]},
    }
    log(f"[check] {fed} {'pairs' if nm == 2 else 'reads'} fed; "
        f"{len(picks)} sampled, {bad} with a bad record; {nb} of {nbase} "
        f"sampled reads below their origin; {failed} fed reads without a "
        f"primary record, {dup} with two or more, {stray} records of "
        f"reads not fed")
    return checks, fed * nm, failed
