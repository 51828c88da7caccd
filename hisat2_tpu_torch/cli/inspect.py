"""hisat2-tpu-inspect: index inspection CLI
(reference: hisat2's hisat2_inspect.cpp).

Modes: default = reconstruct FASTA from the packed reference; -n names;
-s summary.

Copied verbatim from hisat2_tpu/cli/inspect.py; only the imports, and
the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="hisat2-tpu-inspect")
    p.add_argument("base", help="index basename")
    p.add_argument("-n", "--names", action="store_true",
                   help="print reference names only")
    p.add_argument("-s", "--summary", action="store_true",
                   help="print summary only")
    p.add_argument("-a", "--across", type=int, default=60,
                   help="characters per FASTA line")
    p.add_argument("--snp", action="store_true", help="print SNPs")
    p.add_argument("--ss", action="store_true", help="print splice sites")
    p.add_argument("--ss-all", dest="ss_all", action="store_true",
                   help="print all splice sites")
    p.add_argument("--exon", action="store_true", help="print exons")
    args = p.parse_args(argv)

    from ..index.format import FMIndex
    from ..utils import bitops

    idx = FMIndex.load(args.base)
    m = idx.meta
    if args.names:
        for nm in m.ref_names:
            print(nm)
        return 0
    if args.summary:
        # field-for-field the reference summary (hisat2_inspect.cpp
        # print_index_summary; graph index => Flags 1)
        import os
        nsnp = nss = nexon = 0
        if os.path.exists(args.base + ".var.npz"):
            from ..index.variants import VariantDB
            db = VariantDB.load(args.base)
            nsnp = db.n_snps
            nss = len(db.ss_ref)
            nexon = len(getattr(db, "exon_ref", []))
        print("Index version\t2.1.0")
        print(f"Flags\t{1 if nsnp or nss else 0}")
        print("2.0-compatible\t0")
        print(f"SA-Sample\t1 in {1 << m.off_rate}")
        print(f"FTab-Chars\t{m.ftab_k}")
        for i, (nm, ln) in enumerate(zip(m.ref_names, m.ref_lens)):
            print(f"Sequence-{i + 1}\t{nm}\t{ln}")
        print(f"Num. SNPs: {nsnp}")
        print(f"Num. Splice Sites: {nss}")
        print(f"Num. Exons: {nexon}")
        return 0
    if args.snp or args.ss or args.ss_all or args.exon:
        from ..index.variants import print_variants
        print_variants(None, snps=args.snp,
                       ss=args.ss or args.ss_all, base=args.base,
                       ref_names=m.ref_names)
        return 0
    # reconstruct FASTA: fragments back into per-reference sequences with
    # N gaps restored
    joined = bitops.unpack_2bit(np.asarray(idx.ref_words), m.n)
    fj = np.asarray(idx.frag_joined)
    fr = np.asarray(idx.frag_ref)
    fo = np.asarray(idx.frag_off)
    for rid, (nm, ln) in enumerate(zip(m.ref_names, m.ref_lens)):
        seq = np.full(ln, 4, np.uint8)
        for f in np.flatnonzero(fr == rid):
            span = fj[f + 1] - fj[f]
            seq[fo[f]:fo[f] + span] = joined[fj[f]:fj[f + 1]]
        print(f">{nm}")
        s = bitops.decode_dna(seq)
        w = max(args.across, 1)
        for i in range(0, len(s), w):
            print(s[i:i + w])
    return 0


if __name__ == "__main__":
    sys.exit(main())
