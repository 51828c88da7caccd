"""DNA reads as HISAT2's read simulator makes them
(hisat2_simulate_reads.py --dna; the repo carries its model in
hisat2_tpu_torch/tools/simulate.py, which this file does not import).

Its model, drawn in bulk from the seed:
- a fragment of `fragment` bp at a uniform place on a chromosome picked
  by length; an unpaired read is the fragment's first `read_len` bases,
  a pair its two ends, the second mate reverse-complemented (--fr);
- every catalog variant the read walks over is in the read with
  probability `het` (the simulator's heterozygous 1/2): an SNV's allele,
  a deletion (not at the read's first base), an insertion (not at the
  first base, and only where the read still has room after it);
- sequencing errors at `error_rate` percent a base on the bases copied
  from the genome, at most `max_mismatch` of them a read (the simulator's
  defaults: 0 and 3);
- an unpaired read is reverse-complemented, and a pair swapped (mate 1
  then the reverse mate), each with probability 1/2;
- qualities are the simulator's FASTA reads' (Q40, 'I'), unless `quals`
  says otherwise.

Two points differ from the script, both rare: a read takes at most one
indel (a second in the same read, about 1 read in 5,000 at a GRCh38
graph density, is left out, as the origin names one edit), and an
insertion goes in once (the script's walk can repeat it at the same
place).  Fragments start 32 bp short of a chromosome's end more than the
script's, room for a deletion.  Chromosomes are drawn per read, by
length, where the script writes them in turn: the same shares, in
another order.
"""

from __future__ import annotations

import numpy as np

from .reads import DEL, INS, Traffic, _blank, _mate, fastq

ROOM = 32            # genome bases past the read a deletion may take


def _places(dep, rng, n, F):
    """n joined fragment starts, a chromosome picked by length and a
    uniform place on it with F + ROOM bases after it."""
    lens = dep.chrom_lens.astype(np.float64)
    c = rng.choice(len(lens), n, p=lens / lens.sum())
    off = (rng.random(n) * (dep.chrom_lens[c] - F - ROOM + 1)).astype(
        np.int64)
    return dep.chrom_starts[c] + off


def _variants(dep, rng, s, L, het):
    """The catalog variants each read at joined start s walks over, each
    kept with probability het: (read, variant) index pairs in order of
    read, then position."""
    cat = dep.catalog
    if cat is None or cat.pos.size == 0:
        z = np.zeros(0, np.int64)
        return z, z
    order = np.argsort(cat.pos, kind="stable")
    pos = cat.pos[order]
    lo = np.searchsorted(pos, s, "left")
    hi = np.searchsorted(pos, s + L + ROOM, "left")
    cnt = hi - lo
    r = np.repeat(np.arange(s.size), cnt)
    v = order[np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
              + np.arange(int(cnt.sum()))]
    keep = rng.random(r.size) < het
    return r[keep], v[keep]


def _mate_reads(dep, rng, s, L, sim):
    """Forward reads [n, L] from joined starts s, with their catalog
    alleles and errors, and their origins (reads.Mate's fields)."""
    n = s.size
    t = _blank(n, L)
    t["start"] = s.copy()
    W = L + ROOM
    ref = dep.genome[s[:, None] + np.arange(W)]
    win = ref.copy()
    r, v = _variants(dep, rng, s, L, sim["het"])
    fwd, base = win[:, :L].copy(), ref[:, :L].copy()
    inserted = np.zeros((n, L), bool)
    if r.size:
        cat = dep.catalog
        x, kind, k = cat.pos[v] - s[r], cat.kind[v], cat.ln[v]
        snv = kind == 0
        win[r[snv], x[snv]] = cat.alt[v[snv]]
        fwd = win[:, :L].copy()
        # the first indel a read can take: a deletion from its second
        # base on, an insertion that leaves the read a base after it
        isdel = kind == 1
        fits = ~snv & (x >= 1) & np.where(isdel, x < L, x + k < L)
        j = np.flatnonzero(fits)
        j = j[np.unique(r[j], return_index=True)[1]]
        rows, p, kk, dl = r[j], x[j], k[j], isdel[j]
        c = np.arange(L)[None, :]
        after = c >= p[:, None]
        src = np.clip(np.where(after, c + np.where(dl, kk, -kk)[:, None], c),
                      0, W - 1)
        ins = ~dl[:, None] & after & (c < (p + kk)[:, None])
        alle = np.take_along_axis(cat.ins[v[j]],
                                  np.clip(c - p[:, None], 0, 15), 1)
        fwd[rows] = np.where(ins, alle, np.take_along_axis(win[rows], src, 1))
        base[rows] = np.take_along_axis(ref[rows], src, 1)
        inserted[rows] = ins
        t["ev"][rows] = np.where(dl, DEL, INS)
        t["ev_x"][rows], t["ev_k"][rows] = p, kk
    # errors only on bases copied from the genome (no allele, no insert)
    rate = sim.get("error_rate", 0.0) / 100.0
    if rate > 0:
        err = (rng.random((n, L)) < rate) & ~inserted & (fwd == base)
        err &= np.cumsum(err, 1) <= sim.get("max_mismatch", 3)
        er, ec = np.nonzero(err)
        fwd[er, ec] = (fwd[er, ec] + rng.integers(1, 4, er.size)) % 4
    return fwd, t


def generate(dep, params: dict, seed: int, n: int = None) -> Traffic:
    """The pool of reads (or pairs) of one seed, as FASTQ bytes with each
    read's origin."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5E])
    n = int(params["pool"] if n is None else n)
    L = params["read_len"]
    F = max(params.get("fragment", 250), L)
    qr = params.get("quals", [40, 40])
    s = _places(dep, rng, n, F)
    if params.get("paired"):
        f1, t1 = _mate_reads(dep, rng, s, L, params)
        f2, t2 = _mate_reads(dep, rng, s + F - L, L, params)
        t2["rc"][:] = True
        sw = rng.random(n) < 0.5            # mate 1 is the reverse mate
        m1 = np.where(sw[:, None], f2, f1)
        m2 = np.where(sw[:, None], f1, f2)
        a = {k: np.where(sw, t2[k], t1[k]) for k in t1}
        b = {k: np.where(sw, t1[k], t2[k]) for k in t1}
        mates = [_mate(rng, m1, a, L, qr), _mate(rng, m2, b, L, qr)]
    else:
        f, t = _mate_reads(dep, rng, s, L, params)
        t["rc"] = rng.random(n) < 0.5
        mates = [_mate(rng, f, t, L, qr)]
    for m in mates:
        m.fastq, m.ends = fastq(m)
    return Traffic(bool(params.get("paired")), n, mates)
