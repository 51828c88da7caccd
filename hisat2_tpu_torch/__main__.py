"""Command dispatcher: python -m hisat2_tpu_torch {align,build,inspect,...}

The same nine commands as `python -m hisat2_tpu` (hisat2_tpu/__main__.py):
`align` runs the torch aligner (the default when the first argument is an
option), `genotype` types through it; `build`, `inspect`, the extractors
and `simulate-reads` are the port's copies of the JAX package's numpy
tools.
"""

import sys


def main():
    argv = sys.argv[1:]
    cmd = "align"
    if argv and not argv[0].startswith("-"):
        cmd, argv = argv[0], argv[1:]
    if cmd == "align":
        from .cli.align import main as m
    elif cmd == "build":
        from .cli.build import main as m
    elif cmd == "inspect":
        from .cli.inspect import main as m
    elif cmd == "extract-splice-sites":
        from .tools.gtf import main_ss as m
    elif cmd == "extract-exons":
        from .tools.gtf import main_exons as m
    elif cmd == "extract-snps-haplotypes":
        from .tools.variants import main as m
    elif cmd == "extract-snps-haplotypes-ucsc":
        from .tools.variants_ucsc import main as m
    elif cmd == "simulate-reads":
        from .tools.simulate import main as m
    elif cmd == "genotype":
        from .genotype.driver import main as m
    else:
        print(f"unknown command {cmd!r}: expected align|build|inspect|"
              "extract-splice-sites|extract-exons|extract-snps-haplotypes|"
              "simulate-reads|genotype", file=sys.stderr)
        return 2
    return m(argv)


if __name__ == "__main__":
    sys.exit(main())
