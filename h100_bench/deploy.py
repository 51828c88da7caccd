"""A configuration's deployment, made from its file: the genome, the
variant catalog, the introns and splice sites, and the index the program
builds from them once per checkout.

Everything here is a function of the configuration's fixed seeds, so the
reads (made from --seed by a traffic generator) and the plain reference
see the same genome in every run.  The genome is plain ACGT with no N, so
a joined coordinate is the chromosome's start plus the offset on it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")

# dinucleotide codes (first base * 4 + second, A C G T = 0 1 2 3)
GT, GC, AT, AG, AC = 11, 9, 3, 2, 1


@dataclasses.dataclass
class Catalog:
    """Variants as arrays: kind 0 SNV / 1 deletion / 2 insertion, joined
    position (0-based; a deletion removes g[pos:pos+len], an insertion
    goes before g[pos]), SNV alt, length, inserted chars [n, 16], name."""
    kind: np.ndarray
    pos: np.ndarray
    alt: np.ndarray
    ln: np.ndarray
    ins: np.ndarray
    names: list


@dataclasses.dataclass
class Deployment:
    cfg: dict
    genome: np.ndarray              # uint8 joined text
    chrom_names: list
    chrom_starts: np.ndarray        # int64 joined start of each chromosome
    chrom_lens: np.ndarray
    repeats: np.ndarray             # int64 [units, copies] joined starts
    catalog: Catalog | None
    introns: list                   # [(donor d, acceptor e, class)]
    intron_pairs: list              # [((d1, e1), (d2, e2))]
    jsnv: dict                      # donor d -> (joined pos, alt)
    known_ss: list                  # [(d, e)] written to the .ss file

    def chrom_of(self, joined):
        return np.searchsorted(self.chrom_starts, joined, "right") - 1


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _unique_positions(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n distinct sorted integers in [lo, hi)."""
    if n <= 0:
        return np.zeros(0, np.int64)
    draw = np.unique(rng.integers(lo, hi, int(n * 1.05) + 64))
    while draw.size < n:
        draw = np.unique(np.concatenate([draw, rng.integers(lo, hi, n)]))
    return np.sort(rng.permutation(draw)[:n])


def make_genome(cfg: dict):
    chroms = cfg["chromosomes"]
    names = [c[0] for c in chroms]
    lens = np.array([c[1] for c in chroms], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    g = np.random.default_rng(cfg["genome_seed"]).integers(
        0, 4, int(lens.sum()), dtype=np.uint8)
    return g, names, starts, lens


def plant_repeats(g, cfg, starts, names) -> np.ndarray:
    """Distinct units, each copied at a fixed spacing inside one
    chromosome (chip_smoke.py:plant_repeats' layout)."""
    rp = cfg.get("repeats")
    if not rp:
        return np.zeros((0, 0), np.int64)
    rng = np.random.default_rng(rp["seed"])
    base0 = int(starts[names.index(rp["chrom"])]) + rp["base"]
    spots = np.zeros((rp["units"], rp["copies"]), np.int64)
    for u in range(rp["units"]):
        unit = rng.integers(0, 4, rp["unit_bp"]).astype(np.uint8)
        base = base0 + u * (rp["copies"] + 1) * rp["spacing"]
        for c in range(rp["copies"]):
            at = base + rp["spacing"] * c
            spots[u, c] = at
            g[at:at + rp["unit_bp"]] = unit
    return spots


def make_catalog(g, cfg, starts, lens) -> Catalog | None:
    """A seeded catalog at the configuration's density (per Gbp), spread
    over the chromosomes by length, 200 bp clear of their ends; indels
    1-16 bp, mostly 1-3 (chip_smoke.py:make_catalog's mix)."""
    cc = cfg.get("catalog")
    if not cc:
        return None
    rng = np.random.default_rng(cc["seed"])
    n = int(lens.sum())
    counts = [round(cc[k] * n / 1e9) for k in
              ("snv_per_gbp", "deletions_per_gbp", "insertions_per_gbp")]
    nv = sum(counts)
    share = np.round(nv * lens / n).astype(np.int64)
    share[-1] = nv - share[:-1].sum()
    pos = np.concatenate([
        s + _unique_positions(rng, 200, int(ln) - 200, int(k))
        for s, ln, k in zip(starts, lens, share)])
    kind = rng.permutation(np.repeat(np.arange(3, dtype=np.int8), counts))
    ln = np.where(rng.random(nv) < 0.85, rng.integers(1, 4, nv),
                  rng.integers(4, 17, nv)).astype(np.int64)
    ln[kind == 0] = 1
    alt = ((g[pos].astype(np.int64) + rng.integers(1, 4, nv)) % 4)
    ins = rng.integers(0, 4, (nv, 16), dtype=np.uint8)
    return Catalog(kind, pos, alt, ln, ins, [f"v{i}" for i in range(nv)])


def _first(g, code: int, at: int) -> int:
    """The first position p >= at with g[p] * 4 + g[p + 1] == code."""
    span = 256
    while True:
        w = g[at:at + span + 1].astype(np.int16)
        hit = np.flatnonzero(w[:-1] * 4 + w[1:] == code)
        if hit.size:
            return at + int(hit[0])
        at += span


def _donor_acc(g, dk, ak, d0, ln):
    d = _first(g, dk, d0)
    return d, _first(g, ak, d + ln - 2) + 2


def pick_introns(g, rng, first_slot: int, ic: dict):
    """Introns on dinucleotides the genome already has, one per 55 kbp
    slot from first_slot (chip_smoke.py:pick_introns' mix): canonical
    GT-AG (half 80-400 bp, half log-uniform 400-50,000 bp), semi-canonical
    (GC-AG, AT-AC) and non-canonical ones, and pairs of canonical introns
    close enough for one read to cross both.  Classes: 0 canonical,
    1 semi-canonical, 2 none."""
    slots = iter(first_slot + ic.get("slot_bp", 55_000) * np.arange(10_000))
    long_max = ic.get("long_max", 50_000)
    introns = []
    for k in range(ic["canonical"]):
        ln = (int(rng.integers(80, 400)) if k % 2 == 0 else
              int(np.exp(rng.uniform(np.log(400), np.log(long_max)))))
        introns.append(_donor_acc(g, GT, AG, int(next(slots)), ln) + (0,))
    for k in range(ic["semi_canonical"]):
        dk, ak = (GC, AG) if k % 2 == 0 else (AT, AC)
        introns.append(_donor_acc(g, dk, ak, int(next(slots)),
                                  int(rng.integers(80, 3000))) + (1,))
    # motifs the aligner classifies (canonical or semi-canonical, either
    # strand): a non-canonical intron takes none of them
    CT, GA_ = 7, 8
    classified = {(GT, AG), (GC, AG), (AT, AC), (CT, AC), (CT, GC),
                  (GT, AT), (GA_, AT)}
    for k in range(ic["non_canonical"]):
        d = int(next(slots))
        while True:
            e = d + int(rng.integers(80, 3000))
            code = (int(g[d]) * 4 + int(g[d + 1]),
                    int(g[e - 2]) * 4 + int(g[e - 1]))
            if code not in classified:
                break
            d += 1
        introns.append((d, e, 2))
    pairs = []
    for k in range(ic["pairs"]):
        d1, e1 = _donor_acc(g, GT, AG, int(next(slots)),
                            int(rng.integers(80, 400)))
        while True:
            d2 = _first(g, GT, e1 + 20)
            if d2 <= e1 + 40:
                break
            d1, e1 = _donor_acc(g, GT, AG, e1 + 500,
                                int(rng.integers(80, 400)))
        e2 = _first(g, AG, d2 + int(rng.integers(80, 400)) - 2) + 2
        pairs.append(((d1, e1), (d2, e2)))
    return introns, pairs


def _clear_of(cat: Catalog | None):
    """A test of whether joined position p is free of the catalog's
    variants: no variant at p, and no deletion spanning it."""
    if cat is None:
        return lambda p: True
    order = np.argsort(cat.pos, kind="stable")
    pos, kind, ln = cat.pos[order], cat.kind[order], cat.ln[order]

    def clear(p):
        lo = int(np.searchsorted(pos, p - 16, "left"))
        hi = int(np.searchsorted(pos, p, "right"))
        return not any(pos[j] == p or (kind[j] == 1 and p < pos[j] + ln[j])
                       for j in range(lo, hi))
    return clear


def make(cfg: dict) -> Deployment:
    g, names, starts, lens = make_genome(cfg)
    spots = plant_repeats(g, cfg, starts, names)
    cat = make_catalog(g, cfg, starts, lens)
    introns, pairs, jsnv, known = [], [], {}, []
    ic = cfg.get("introns")
    if ic:
        rng = np.random.default_rng(ic["seed"])
        for s, ln in zip(starts, lens):
            i_, p_ = pick_introns(g, rng, int(s + ln // 20), ic)
            introns += i_
            pairs += p_
        # one catalog SNV within 10 bp upstream of each canonical donor,
        # on a base that no drawn variant touches (moved upstream past
        # one that does), so that no position carries two entries
        clear = _clear_of(cat)
        for d, e, c in introns:
            if c == 0:
                p = d - int(rng.integers(1, 11))
                while not clear(p):
                    p -= 1
                jsnv[d] = (p, (int(g[p]) + int(rng.integers(1, 4))) % 4)
        can = [(d, e) for d, e, c in introns if c == 0]
        known = can[::ic["known_site_every"]]
        if cat is not None and jsnv:
            items = sorted(jsnv.values())
            k0 = len(cat.names)
            cat = Catalog(
                np.concatenate([cat.kind, np.zeros(len(items), np.int8)]),
                np.concatenate([cat.pos, [p for p, _ in items]]),
                np.concatenate([cat.alt, [a for _, a in items]]),
                np.concatenate([cat.ln, np.ones(len(items), np.int64)]),
                np.concatenate([cat.ins, np.zeros((len(items), 16),
                                                  np.uint8)]),
                cat.names + [f"j{k}" for k in range(len(items))])
            assert len(cat.names) == k0 + len(items)
    return Deployment(cfg, g, names, starts, lens, spots, cat, introns,
                      pairs, jsnv, known)


# -- the program's index, built once per checkout ---------------------------

# bumped whenever make() would give a configuration another deployment
DEPLOY_VERSION = 2


def _digest(cfg: dict) -> str:
    return hashlib.sha256(json.dumps([DEPLOY_VERSION, cfg], sort_keys=True)
                          .encode()).hexdigest()[:16]


def index_base(cfg: dict, cache: str = CACHE) -> str:
    return os.path.join(cache, cfg["name"], "index")


def write_snp(dep: Deployment, path: str):
    cat = dep.catalog
    ci = dep.chrom_of(cat.pos)
    acgt = np.array(list("ACGT"))
    kinds = ("single", "deletion", "insertion")
    with open(path, "w") as f:
        for i in range(len(cat.names)):
            k = int(cat.kind[i])
            p = int(cat.pos[i] - dep.chrom_starts[ci[i]])
            if k == 0:
                allele = acgt[cat.alt[i]]
            elif k == 1:
                allele = str(int(cat.ln[i]))
            else:
                allele = "".join(acgt[cat.ins[i, :cat.ln[i]]])
            f.write(f"{cat.names[i]}\t{kinds[k]}\t"
                    f"{dep.chrom_names[ci[i]]}\t{p}\t{allele}\n")


def write_ss(dep: Deployment, path: str):
    """hisat2's .ss lines: chromosome, the last exon base before the
    intron and the first after it (0-based), strand."""
    with open(path, "w") as f:
        for d, e in dep.known_ss:
            c = int(dep.chrom_of(d))
            s = int(dep.chrom_starts[c])
            f.write(f"{dep.chrom_names[c]}\t{d - s - 1}\t{e - s}\t+\n")


def ensure_index(dep: Deployment, cache: str = CACHE, log=print) -> tuple:
    """The index's basename, building it first where this checkout has
    none for this configuration.  Returns (basename, seconds built or
    None)."""
    import time
    cfg = dep.cfg
    base = index_base(cfg, cache)
    stamp = base + ".built"
    want = _digest(cfg)
    if os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == want:
                return base, None
    os.makedirs(os.path.dirname(base), exist_ok=True)
    t0 = time.perf_counter()
    from hisat2_tpu_torch.index.builder import build_fm_index
    seqs = [(n, dep.genome[s:s + ln]) for n, s, ln in
            zip(dep.chrom_names, dep.chrom_starts, dep.chrom_lens)]
    idx = build_fm_index(seqs, shard_bp=cfg.get("shard_bp"))
    snp = base + ".snp" if cfg.get("snp_index") else None
    ss = base + ".ss" if cfg.get("ss_index") else None
    if snp:
        write_snp(dep, snp)
    if ss:
        write_ss(dep, ss)
    if snp or ss:
        from hisat2_tpu_torch.index.variants import attach_variants
        idx = attach_variants(idx, snp_file=snp, ss_file=ss)
        idx._variants.save(base)
    idx.save(base)
    with open(stamp, "w") as f:
        f.write(want)
    dt = time.perf_counter() - t0
    log(f"[setup] built the {cfg['name']} index in {dt:.1f} s at {base}")
    return base, dt
