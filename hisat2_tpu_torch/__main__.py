"""Command dispatcher: python -m hisat2_tpu_torch {align,build} ...

`align` runs the torch aligner (the default when the first argument is an
option); `build` is the index builder (cli/build.py, the port's copy of
the JAX package's numpy builder).
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
    else:
        print(f"unknown command {cmd!r}: expected align|build "
              "(other hisat2_tpu commands are not ported)", file=sys.stderr)
        return 2
    return m(argv)


if __name__ == "__main__":
    sys.exit(main())
