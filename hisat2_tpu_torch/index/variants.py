"""Variant / splice-site / exon database (ALT, ALTDB, Haplotype equivalents;
reference: hisat2's alt.h:32-294, parsed by GFM's ctor from .snp/.ss/
.exon/.haplotype text inputs, gfm.h:1311-1720).

Stored beside the FM index as `<base>.var.npz`.  Record layouts:
  SNPs:   kind (0=single 1=deletion 2=insertion), ref_id, pos (0-based on
          reference), joined_pos (-1 if inside an excluded N gap), length,
          seq (2-bit packed alt allele, <=32 bp in an int64 — same packing
          as ALT::seq, alt.h:60-75), name
  Splice sites: ref_id, left, right (0-based last exonic positions flanking
          the intron, like ALT_SPLICESITE), strand (+1/-1), known-flag
  Exons:  ref_id, left, right, strand
  Haplotypes: ref_id, left, right, comma-joined alt ids (alt.h:209)

Copied verbatim from hisat2_tpu/index/variants.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

SNP_SGL, SNP_DEL, SNP_INS = 0, 1, 2
_KIND = {"single": SNP_SGL, "deletion": SNP_DEL, "insertion": SNP_INS}
_KIND_NAMES = {v: k for k, v in _KIND.items()}
_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


@dataclasses.dataclass
class VariantDB:
    snp_names: list
    snp_kind: np.ndarray     # int8  [V]
    snp_ref: np.ndarray      # int32 [V]
    snp_pos: np.ndarray      # int32 [V]
    snp_joined: np.ndarray   # int32 [V]
    snp_len: np.ndarray      # int32 [V]
    snp_seq: np.ndarray      # int64 [V]
    ss_ref: np.ndarray       # int32 [S]
    ss_left: np.ndarray      # int32 [S]
    ss_right: np.ndarray     # int32 [S]
    ss_strand: np.ndarray    # int8  [S]
    exon_ref: np.ndarray
    exon_left: np.ndarray
    exon_right: np.ndarray
    exon_strand: np.ndarray
    hap_ref: np.ndarray
    hap_left: np.ndarray
    hap_right: np.ndarray
    hap_alts: list           # list[list[int]] snp indices per haplotype

    @property
    def n_snps(self):
        return len(self.snp_kind)

    def save(self, base: str) -> None:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name not in ("snp_names", "hap_alts")}
        np.savez(base + ".var.npz",
                 __names__=np.frombuffer(
                     json.dumps(self.snp_names).encode(), np.uint8),
                 __haps__=np.frombuffer(
                     json.dumps([list(map(int, h))
                                 for h in self.hap_alts]).encode(), np.uint8),
                 **d)

    @staticmethod
    def load(base: str) -> "VariantDB":
        with np.load(base + ".var.npz") as z:
            names = json.loads(bytes(z["__names__"]).decode())
            haps = json.loads(bytes(z["__haps__"]).decode())
            kw = {k: z[k] for k in z.files if not k.startswith("__")}
        return VariantDB(snp_names=names, hap_alts=haps, **kw)


def pack_allele(seq: str) -> int:
    """2-bit pack an allele string (<=32 bp) into an int64 (alt.h:60)."""
    v = 0
    for i, ch in enumerate(seq):
        v |= _BASE.get(ch.upper(), 0) << (2 * i)
    return v


def unpack_allele(v: int, ln: int) -> str:
    return "".join("ACGT"[(v >> (2 * i)) & 3] for i in range(ln))


def _ref_ids(meta):
    return {nm: i for i, nm in enumerate(meta.ref_names)}


def _to_joined(index, rid: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """(ref id, ref offset) -> joined offset, or -1 inside an N gap.
    int64: a sharded multi-gigabase GLOBAL joined space exceeds int32."""
    fj = np.asarray(index.frag_joined)
    fr = np.asarray(index.frag_ref)
    fo = np.asarray(index.frag_off)
    out = np.full(len(rid), -1, np.int64)
    for r in np.unique(rid):
        sel = rid == r
        frs = np.flatnonzero(fr == r)
        if not len(frs):
            continue
        starts = fo[frs]
        spans = fj[frs + 1] - fj[frs]
        f = np.searchsorted(starts, pos[sel], "right") - 1
        f = np.clip(f, 0, len(frs) - 1)
        inside = (pos[sel] >= starts[f]) & (pos[sel] < starts[f] + spans[f])
        j = fj[frs[f]] + (pos[sel] - starts[f])
        out[sel] = np.where(inside, j, -1).astype(np.int64)
    return out


def load_snps(index, snp_file: str) -> dict:
    """Parse a hisat2 .snp file (format: gfm.h:1320-1420 parser;
    `id single|deletion|insertion chr pos allele`)."""
    names, kind, refs, pos, ln, seq = [], [], [], [], [], []
    rids = _ref_ids(index.meta)
    with open(snp_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            sid, k, chrom, p, allele = parts[:5]
            if chrom not in rids or k not in _KIND:
                continue
            names.append(sid)
            kind.append(_KIND[k])
            refs.append(rids[chrom])
            pos.append(int(p))
            if k == "single":
                ln.append(1)
                seq.append(_BASE.get(allele.upper(), 0))
            elif k == "deletion":
                ln.append(int(allele))
                seq.append(0)
            else:
                ln.append(len(allele))
                seq.append(pack_allele(allele))
    return dict(names=names, kind=np.array(kind, np.int8),
                ref=np.array(refs, np.int32), pos=np.array(pos, np.int32),
                len=np.array(ln, np.int32), seq=np.array(seq, np.int64))


def _load_sites(index, path: str):
    """Parse .ss / .exon lines: `chr left right strand`."""
    rids = _ref_ids(index.meta)
    ref, left, right, strand = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3 or parts[0] not in rids:
                continue
            ref.append(rids[parts[0]])
            left.append(int(parts[1]))
            right.append(int(parts[2]))
            strand.append(1 if (len(parts) < 4 or parts[3] == "+") else -1)
    return (np.array(ref, np.int32), np.array(left, np.int32),
            np.array(right, np.int32), np.array(strand, np.int8))


def attach_variants(index, snp_file=None, haplotype_file=None,
                    ss_file=None, exon_file=None):
    """Build the VariantDB next to an index; returns index unchanged (the DB
    saves/loads alongside via index basename)."""
    empty32 = np.zeros(0, np.int32)
    empty8 = np.zeros(0, np.int8)
    db = VariantDB(snp_names=[], snp_kind=empty8, snp_ref=empty32,
                   snp_pos=empty32, snp_joined=empty32, snp_len=empty32,
                   snp_seq=np.zeros(0, np.int64),
                   ss_ref=empty32, ss_left=empty32, ss_right=empty32,
                   ss_strand=empty8, exon_ref=empty32, exon_left=empty32,
                   exon_right=empty32, exon_strand=empty8,
                   hap_ref=empty32, hap_left=empty32, hap_right=empty32,
                   hap_alts=[])
    if snp_file:
        s = load_snps(index, snp_file)
        db.snp_names = s["names"]
        db.snp_kind = s["kind"]
        db.snp_ref = s["ref"]
        db.snp_pos = s["pos"]
        db.snp_len = s["len"]
        db.snp_seq = s["seq"]
        db.snp_joined = _to_joined(index, s["ref"], s["pos"])
    if ss_file:
        db.ss_ref, db.ss_left, db.ss_right, db.ss_strand = (
            _load_sites(index, ss_file))
    if exon_file:
        db.exon_ref, db.exon_left, db.exon_right, db.exon_strand = (
            _load_sites(index, exon_file))
    if haplotype_file:
        rids = _ref_ids(index.meta)
        name_to_i = {n: i for i, n in enumerate(db.snp_names)}
        hr, hl, hR, ha = [], [], [], []
        with open(haplotype_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5 or parts[1] not in rids:
                    continue
                hr.append(rids[parts[1]])
                hl.append(int(parts[2]))
                hR.append(int(parts[3]))
                ha.append([name_to_i[a] for a in parts[4].split(",")
                           if a in name_to_i])
        db.hap_ref = np.array(hr, np.int32)
        db.hap_left = np.array(hl, np.int32)
        db.hap_right = np.array(hR, np.int32)
        db.hap_alts = ha
    index._variants = db
    return index


def print_variants(index_base_or_idx, snps=False, ss=False, base: str = None,
                   ref_names=None):
    """hisat2-inspect --snp/--ss rendering (hisat2_inspect.cpp:214-260:
    `name  type  chr  pos  allele` / `chr  left  right  strand`)."""
    db = (index_base_or_idx._variants
          if hasattr(index_base_or_idx, "_variants")
          else VariantDB.load(base))
    if ref_names is None and base is not None:
        from .format import FMIndex
        ref_names = FMIndex.load(base).meta.ref_names
    nm = (lambda r: ref_names[r]) if ref_names is not None else str
    if snps:
        for i in range(db.n_snps):
            kind = _KIND_NAMES[int(db.snp_kind[i])]
            if db.snp_kind[i] == SNP_SGL:
                allele = unpack_allele(int(db.snp_seq[i]), 1)
            elif db.snp_kind[i] == SNP_DEL:
                allele = str(int(db.snp_len[i]))
            else:
                allele = unpack_allele(int(db.snp_seq[i]),
                                       int(db.snp_len[i]))
            print(f"{db.snp_names[i]}\t{kind}\t{nm(int(db.snp_ref[i]))}\t"
                  f"{int(db.snp_pos[i])}\t{allele}")
    if ss:
        for i in range(len(db.ss_ref)):
            st = "+" if db.ss_strand[i] > 0 else "-"
            print(f"{nm(int(db.ss_ref[i]))}\t{int(db.ss_left[i])}\t"
                  f"{int(db.ss_right[i])}\t{st}")
