"""The general read generator: simulated reads from a deployment's genome,
by the parameters of a workload's traffic mix, with the origin of each
read kept for the plain reference.

The mixes copy chip_smoke.py's generators (simulate, simulate_pairs,
simulate_spliced, simulate_config6): DNA reads with sequencing errors,
Ns, short indels and shorter reads; reads across one or two planted
introns, some carrying a junction SNV; pairs whose left mate carries a
catalog allele, with repeat and random mates.  Everything is drawn from
the seed in bulk, and the reads are pre-formatted as FASTQ bytes.

A read's origin is its forward sequence's place on the genome: the joined
start of its first base, whether the fed read is that sequence's reverse
complement, and its edit (none, a deletion or insertion at a read offset,
one or two introns).  `origin_cigar` turns it into the alignment the
read was made from.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# edit kinds of an origin
NONE, DEL, INS, SPLICE1, SPLICE2 = 0, 1, 2, 3, 4


@dataclasses.dataclass
class Mate:
    """One read file's worth: fed codes and quals (read orientation,
    [n, L] uint8, padding code 4), lengths, and the origins."""
    codes: np.ndarray
    quals: np.ndarray
    lens: np.ndarray
    start: np.ndarray       # int64 joined start; -1: no origin (random)
    rc: np.ndarray          # the fed read is the reverse complement
    ev: np.ndarray          # edit kind
    ev_x: np.ndarray        # read offset of the edit (first exon length)
    ev_k: np.ndarray        # indel length / first intron length
    ev_m: np.ndarray        # middle exon length (two introns)
    ev_k2: np.ndarray       # second intron length
    fastq: bytes = b""
    ends: np.ndarray = None  # byte offset after each record


@dataclasses.dataclass
class Traffic:
    paired: bool
    n: int                  # reads, or pairs
    mates: list             # [Mate] (one, or two for pairs)

    def name(self, i: int) -> str:
        return f"r{i:09d}"


def origin_cigar(m: Mate, i: int) -> str:
    """The alignment read i was made from, as a CIGAR on the forward
    strand (no clipping)."""
    L = int(m.lens[i])
    x, k = int(m.ev_x[i]), int(m.ev_k[i])
    ev = int(m.ev[i])
    if ev == NONE:
        ops = [(L, "M")]
    elif ev == DEL:
        ops = [(x, "M"), (k, "D"), (L - x, "M")]
    elif ev == INS:
        ops = [(x, "M"), (k, "I"), (L - x - k, "M")]
    elif ev == SPLICE1:
        ops = [(x, "M"), (k, "N"), (L - x, "M")]
    else:
        mm, k2 = int(m.ev_m[i]), int(m.ev_k2[i])
        ops = [(x, "M"), (k, "N"), (mm, "M"), (k2, "N"),
               (L - x - mm, "M")]
    out, left = [], L
    for n, op in ops:
        if op in "MI":
            n = min(n, left)
            left -= n
        if n > 0 and not (op in "DN" and left == 0):
            out.append(f"{n}{op}")
    return "".join(out)


def _revcomp(codes, lens):
    """Reverse complements of the first lens[i] codes of each row (code 4
    stays 4), padded with 4."""
    n, L = codes.shape
    col = np.arange(L)[None, :]
    src = np.clip(lens[:, None] - 1 - col, 0, L - 1)
    c = np.take_along_axis(codes, src, 1)
    c = np.where(c < 4, 3 - c, 4).astype(np.uint8)
    c[col >= lens[:, None]] = 4
    return c


def _exact(rng, among, share, block):
    """A mask over `among` (a bool mask) with, in every block of `block`
    reads, exactly round(share * its count in `among`) of them set: each
    batch the program reads gets the same mix, in another order."""
    out = np.zeros(among.size, bool)
    for b0 in range(0, among.size, block):
        idx = b0 + np.flatnonzero(among[b0:b0 + block])
        k = int(round(share * idx.size))
        out[rng.permutation(idx)[:k]] = True
    return out


def _even(rng, among, values, block):
    """values spread evenly over `among` in every block (value v where
    the mask is set, -1 elsewhere)."""
    out = np.full(among.size, -1, np.int64)
    for b0 in range(0, among.size, block):
        idx = rng.permutation(b0 + np.flatnonzero(among[b0:b0 + block]))
        out[idx] = np.resize(np.asarray(values), idx.size)
    return out


def _starts(dep, rng, n, span):
    """n joined starts, each with `span` bases inside one chromosome."""
    lens = dep.chrom_lens.astype(np.float64)
    c = rng.choice(len(lens), n, p=lens / lens.sum())
    off = (rng.random(n) * (dep.chrom_lens[c] - span - 400)).astype(
        np.int64) + 200
    return dep.chrom_starts[c] + off


def _blank(n, L):
    z = np.zeros(n, np.int64)
    return dict(start=z.copy(), rc=np.zeros(n, bool), ev=z.copy(),
                ev_x=z.copy(), ev_k=z.copy(), ev_m=z.copy(), ev_k2=z.copy(),
                lens=np.full(n, L, np.int32))


def _errors(rng, fwd, lens, rows, max_k):
    """1..max_k sequencing substitutions on each of `rows` (the first
    always, each later one with probability 0.7)."""
    for k in range(max_k):
        sel = rows if k == 0 else rows[rng.random(rows.size) < 0.7]
        p = (rng.random(sel.size) * lens[sel]).astype(np.int64)
        fwd[sel, p] = np.where(fwd[sel, p] < 4,
                               (fwd[sel, p] + rng.integers(1, 4, sel.size))
                               % 4, fwd[sel, p])


def dna(dep, rng, n, L, mix, block, among=None):
    """chip_smoke.py:simulate's mix: `clean` reads untouched; the rest
    0..max_mismatches substitutions, an N (n_share), a 1..indel_max bp
    indel at offset 10..L-10 (indel_share), a length cut by 1..short_max
    (short_share); half reverse-complemented.  Every block of `block`
    reads holds the shares exactly, of the reads `among` (default all)."""
    g = dep.genome
    t = _blank(n, L)
    W = L + 16
    start = _starts(dep, rng, n, W)
    win = g[start[:, None] + np.arange(W)]
    every = np.ones(n, bool) if among is None else among
    clean = _exact(rng, every, mix["clean"], block) | ~every
    col = np.arange(L)[None, :]
    fwd = win[:, :L].copy()
    ind_m = _exact(rng, ~clean, mix["indel_share"], block)
    ind = np.flatnonzero(ind_m)
    k = rng.integers(1, mix["indel_max"] + 1, ind.size)
    p = rng.integers(10, L - 10, ind.size)
    isdel = _exact(rng, ind_m, 0.5, block)[ind]
    c = col[0][None, :]
    src = np.where(c < p[:, None], c, c + k[:, None])       # deletion
    dele = np.take_along_axis(win[ind], src, 1)
    rnd = rng.integers(0, 4, (ind.size, L), dtype=np.uint8)
    src_i = np.clip(c - k[:, None], 0, W - 1)
    inse = np.where(c < p[:, None], win[ind, :L],
                    np.where(c < (p + k)[:, None], rnd,
                             np.take_along_axis(win[ind], src_i, 1)))
    fwd[ind] = np.where(isdel[:, None], dele, inse)
    t["ev"][ind] = np.where(isdel, DEL, INS)
    t["ev_x"][ind], t["ev_k"][ind] = p, k
    short = _exact(rng, ~clean, mix["short_share"], block)
    t["lens"][short] = L - rng.integers(1, mix["short_max"] + 1,
                                        int(short.sum()))
    nmm = np.maximum(_even(rng, ~clean,
                           np.arange(mix["max_mismatches"] + 1), block), 0)
    for j in range(mix["max_mismatches"]):
        rows = np.flatnonzero(nmm > j)
        q = (rng.random(rows.size) * t["lens"][rows]).astype(np.int64)
        fwd[rows, q] = (fwd[rows, q] + rng.integers(1, 4, rows.size)) % 4
    hn = np.flatnonzero(_exact(rng, ~clean, mix["n_share"], block))
    fwd[hn, (rng.random(hn.size) * t["lens"][hn]).astype(np.int64)] = 4
    t["start"] = start
    t["rc"] = _exact(rng, np.ones(n, bool), 0.5, block)
    return fwd, t


def junction_masks(rng, n, sp, block):
    """Which reads cross one intron, which two: exact shares a block."""
    every = np.ones(n, bool)
    one = _exact(rng, every, sp["one"], block)
    two = _exact(rng, ~one, sp["two"] / (1 - sp["one"]), block)
    return one, two


def spliced(dep, rng, fwd, t, L, sp, block, one_m, two_m):
    """Overwrite a share of the reads with reads across one intron (split
    uniform in split, no other edit), or across a pair of introns (first
    exon pair_left bp), a junction_snv share of the one-intron reads
    carrying their intron's junction SNV (chip_smoke.py:
    simulate_spliced / simulate_config6)."""
    g = dep.genome
    one, two = np.flatnonzero(one_m), np.flatnonzero(two_m)
    c = np.arange(L)[None, :]
    it = np.asarray([(d, e, cl) for d, e, cl in dep.introns], np.int64)
    j = rng.integers(0, len(it), one.size)
    d, e = it[j, 0], it[j, 1]
    x = rng.integers(sp["split"][0], sp["split"][1] + 1, one.size)
    idx = np.where(c < x[:, None], (d - x)[:, None] + c,
                   (e - x)[:, None] + c)
    fwd[one] = g[idx]
    pr = np.asarray([(a, b, cc, dd) for (a, b), (cc, dd) in
                     dep.intron_pairs], np.int64)
    j2 = rng.integers(0, len(pr), two.size)
    d1, e1, d2, e2 = (pr[j2, q] for q in range(4))
    x2 = rng.integers(sp["pair_left"][0], sp["pair_left"][1] + 1, two.size)
    mid = d2 - e1
    idx2 = np.where(c < x2[:, None], (d1 - x2)[:, None] + c,
                    np.where(c < (x2 + mid)[:, None], (e1 - x2)[:, None] + c,
                             (e2 - x2 - mid)[:, None] + c))
    fwd[two] = g[idx2]
    for rows, st, kind in ((one, d - x, SPLICE1), (two, d1 - x2, SPLICE2)):
        t["start"][rows] = st
        t["lens"][rows] = L
        t["ev"][rows] = kind
        t["ev_m"][rows] = 0
        t["ev_k2"][rows] = 0
    t["ev_x"][one], t["ev_k"][one] = x, e - d
    t["ev_x"][two], t["ev_k"][two] = x2, e1 - d1
    t["ev_m"][two], t["ev_k2"][two] = mid, e2 - d2
    # a junction SNV on a share of the one-intron reads
    carry = _exact(rng, one_m, sp["junction_snv"], block)[one]
    for q in np.flatnonzero(carry):
        hit = dep.jsnv.get(int(d[q]))
        if hit is None:
            continue
        p, alt = hit
        off = p - int(d[q] - x[q])
        if off >= 0:
            fwd[one[q], off] = alt
    return fwd, t


def pairs(dep, rng, n, L, pm, block):
    """chip_smoke.py:simulate_pairs' mix: --fr fragments of fragment[0]..
    fragment[1] bp; the left mate carries one catalog SNV (snv), one
    catalog indel (indel) or 1-3 errors (errors), the rest are reference
    copies; repeat_mate pairs start inside a planted repeat copy,
    random_mate pairs have a right mate of random sequence; errors pairs
    take 1-3 errors on the right mate too; half the pairs come from the
    reverse strand (mate 1 is then the right mate)."""
    g = dep.genome
    cat = dep.catalog
    every = np.ones(n, bool)
    rep = _exact(rng, every, pm["repeat_mate"], block)
    rnd = _exact(rng, ~rep, pm["random_mate"] / (1 - pm["repeat_mate"]),
                 block)
    plain = ~rep & ~rnd
    a = pm["allele_mix"]
    kind = _even(rng, plain, np.repeat(
        [0, 1, 2, 3], np.round(np.array(
            [a["snv"], a["indel"], a["errors"],
             1 - a["snv"] - a["indel"] - a["errors"]]) * 100).astype(int)),
        block)
    snv, indel, errs = kind == 0, kind == 1, kind == 2
    Fmax = pm["fragment"][1]
    ci = dep.chrom_of(cat.pos)
    roomy = (cat.pos - dep.chrom_starts[ci] > 200) & (
        dep.chrom_starts[ci] + dep.chrom_lens[ci] - cat.pos > Fmax + 200)
    snvs = np.flatnonzero((cat.kind == 0) & roomy)
    dels = np.flatnonzero((cat.kind == 1) & roomy)
    inss = np.flatnonzero((cat.kind == 2) & roomy)
    dsel = _exact(rng, indel, 0.5, block)
    vid = np.where(snv, snvs[rng.integers(0, snvs.size, n)],
                   np.where(dsel, dels[rng.integers(0, dels.size, n)],
                            inss[rng.integers(0, inss.size, n)]))
    off = rng.integers(12, L - 12, n)
    F = rng.integers(pm["fragment"][0], Fmax + 1, n)
    s = np.where(snv | indel, cat.pos[vid] - off,
                 _starts(dep, rng, n, Fmax + 40))
    spots = dep.repeats
    u = rng.integers(0, spots.shape[0], n)
    cc = rng.integers(0, spots.shape[1], n)
    s = np.where(rep, spots[u, cc] + 10, s)
    c = np.arange(L)[None, :]
    W = L + 16
    win = g[s[:, None] + np.arange(W)]
    left = win[:, :L].copy()
    tl, tr = _blank(n, L), _blank(n, L)
    rows = np.flatnonzero(snv)
    left[rows, off[rows]] = cat.alt[vid[rows]]
    rows = np.flatnonzero(indel)
    k = cat.ln[vid[rows]]
    p = off[rows]
    isdel = cat.kind[vid[rows]] == 1
    src = np.where(c < p[:, None], c, c + k[:, None])
    dele = np.take_along_axis(win[rows], src, 1)
    insc = cat.ins[vid[rows]]
    src_i = np.clip(c - k[:, None], 0, W - 1)
    inse = np.where(c < p[:, None], win[rows, :L],
                    np.where(c < (p + k)[:, None],
                             np.take_along_axis(
                                 insc, np.clip(c - p[:, None], 0, 15), 1),
                             np.take_along_axis(win[rows], src_i, 1)))
    left[rows] = np.where(isdel[:, None], dele, inse)
    tl["ev"][rows] = np.where(isdel, DEL, INS)
    tl["ev_x"][rows], tl["ev_k"][rows] = p, k
    rs = s + F - L
    right = g[rs[:, None] + np.arange(L)].copy()
    right[rnd] = rng.integers(0, 4, (int(rnd.sum()), L), dtype=np.uint8)
    er = np.flatnonzero(errs)
    lensv = np.full(n, L, np.int64)
    for m in (left, right):
        _errors(rng, m, lensv, er, a["max_errors"])
    tl["start"], tl["rc"] = s, np.zeros(n, bool)
    tr["start"], tr["rc"] = np.where(rnd, -1, rs), np.ones(n, bool)
    # half of each kind of pair forward, so that both mate files get the
    # same mix in every block
    fw = np.zeros(n, bool)
    for part in (dsel, indel & ~dsel, snv, errs, rep, rnd,
                 plain & ~snv & ~indel & ~errs):
        fw |= _exact(rng, part, 0.5, block)
    m1 = np.where(fw[:, None], left, right)
    m2 = np.where(fw[:, None], right, left)
    t1 = {k_: np.where(fw, tl[k_], tr[k_]) for k_ in tl}
    t2 = {k_: np.where(fw, tr[k_], tl[k_]) for k_ in tl}
    return (m1, t1), (m2, t2)


def _mate(rng, fwd, t, L, qr):
    n = fwd.shape[0]
    lens = t["lens"].astype(np.int32)
    col = np.arange(L)[None, :]
    fwd[col >= lens[:, None]] = 4
    fed = np.where(t["rc"][:, None], _revcomp(fwd, lens), fwd)
    quals = rng.integers(qr[0], qr[1] + 1, (n, L), dtype=np.uint8)
    quals[col >= lens[:, None]] = 0
    t = {k: v for k, v in t.items() if k != "lens"}
    return Mate(codes=fed.astype(np.uint8), quals=quals, lens=lens, **t)


_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def fastq(m: Mate):
    """The mate's reads as FASTQ bytes (names r%09d) and the byte offset
    after each record, built in one scatter."""
    n, L = m.codes.shape
    lens = m.lens.astype(np.int64)
    hdr = 12                                  # "@r%09d\n"
    rec = hdr + 2 * lens + 4                  # seq "\n+\n" qual "\n"
    ends = np.cumsum(rec)
    beg = ends - rec
    buf = np.zeros(int(ends[-1]) if n else 0, np.uint8)
    ids = np.arange(n, dtype=np.int64)
    buf[beg] = ord("@")
    buf[beg + 1] = ord("r")
    for d in range(9):
        buf[beg + 2 + d] = ord("0") + (ids // 10 ** (8 - d)) % 10
    buf[beg + hdr - 1] = ord("\n")
    col = np.arange(L)[None, :]
    inlen = col < lens[:, None]
    buf[(beg[:, None] + hdr + col)[inlen]] = \
        _ASCII[np.minimum(m.codes, 4)][inlen]
    nl1 = beg + hdr + lens
    buf[nl1] = ord("\n")
    buf[nl1 + 1] = ord("+")
    buf[nl1 + 2] = ord("\n")
    q_at = (nl1[:, None] + 3 + col)[inlen]
    buf[q_at] = (m.quals + 33)[inlen]
    buf[ends - 1] = ord("\n")
    return buf.tobytes(), ends


def reorder(tr: Traffic, seed: int) -> Traffic:
    """The same pool, its reads (or pairs) in an order drawn from seed."""
    perm = np.random.default_rng([int(seed) % 2 ** 63, 0x0D]).permutation(
        tr.n)
    mates = []
    for m in tr.mates:
        m = Mate(**{f.name: getattr(m, f.name)[perm]
                    for f in dataclasses.fields(Mate)
                    if f.name not in ("fastq", "ends")})
        m.fastq, m.ends = fastq(m)
        mates.append(m)
    return Traffic(tr.paired, tr.n, mates)


def generate(dep, params: dict, seed: int, n: int = None) -> Traffic:
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    n = int(params["pool"] if n is None else n)
    L = params["read_len"]
    qr = params["quals"]
    block = params["block"]
    if params.get("paired"):
        (f1, t1), (f2, t2) = pairs(dep, rng, n, L, params["pairs"], block)
        mates = [_mate(rng, f1, t1, L, qr), _mate(rng, f2, t2, L, qr)]
    else:
        sp = params.get("spliced")
        if sp:
            one, two = junction_masks(rng, n, sp, block)
            fwd, t = dna(dep, rng, n, L, params["dna"], block, ~(one | two))
            fwd, t = spliced(dep, rng, fwd, t, L, sp, block, one, two)
        else:
            fwd, t = dna(dep, rng, n, L, params["dna"], block)
        mates = [_mate(rng, fwd, t, L, qr)]
    for m in mates:
        m.fastq, m.ends = fastq(m)
    return Traffic(bool(params.get("paired")), n, mates)
