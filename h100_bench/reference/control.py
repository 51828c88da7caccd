"""The control of the check: an aligner that breaks the configuration's
gapped (and spliced) alignment guarantee, put in the program's place.

It aligns each sampled read where it was made, ungapped and unspliced, end
to end: the read's bases against the genome from its origin's start, and
reports it unaligned where that scores below --score-min.  Its records
are exact by construction (the checker's own walk), so only the share of
reads below their origin can fail it.  Run at a cell's own size:

    python3 h100_bench/reference/control.py --workload <cell> --seeds 1 2 3

prints, per seed, the share of sampled reads the control puts below
their origin, the number the cell's limit must stay under.
"""

from __future__ import annotations

import os
import sys


def control_reading(dep, traffic, cfg, picks, cigar_of):
    from h100_bench.reference.judge import (_COMP, below, checker,
                                            fed_read, origin_score)
    ck = checker(dep, cfg)
    nb = nbase = 0
    for i in picks:
        i = int(i) % traffic.n             # the stream repeats the pool
        for m in traffic.mates:
            o = origin_score(ck, m, i, cigar_of)
            if o is None:
                continue
            seq, qual = fed_read(m, i)
            if m.rc[i]:
                seq, qual = seq.translate(_COMP)[::-1], qual[::-1]
            L = len(seq)
            start = int(m.start[i])
            got = ck.score_origin(start, f"{L}M", seq, list(qual))
            minsc = ck.sc.min_score(L)
            if got < minsc:
                got = None
            b = below(o, got, minsc)
            if b is not None:
                nbase += 1
                nb += b
    return 100.0 * nb / nbase if nbase else 0.0


def main(argv=None):
    import argparse
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(here))
    from h100_bench import deploy, harness
    from h100_bench.reference.judge import sample
    from h100_bench.traffic.reads import origin_cigar
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fed", type=int, default=None,
                   help="reads a run feeds (default: the whole pool)")
    a = p.parse_args(argv)
    man = harness.load_manifest()
    entry = harness.cell_entry(man, a.workload)
    wl = harness.load_workload(a.workload)
    cfg = deploy.load_config(entry["config"])
    dep = deploy.make(cfg)
    gen = __import__(f"h100_bench.traffic.{wl['generator']}",
                     fromlist=["generate"])
    out = []
    for seed in a.seeds:
        tr = harness.make_traffic(gen, dep, wl, seed)
        fed = a.fed or tr.n
        picks = sample(tr, fed, wl["sample"], seed)
        v = control_reading(dep, tr, cfg, picks, origin_cigar)
        out.append(v)
        print(f"[control] {a.workload} seed {seed}: below_origin_pct "
              f"{v!r}", flush=True)
    print(f"[control] {a.workload}: least {min(out)!r} over "
          f"{len(out)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
