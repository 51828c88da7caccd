"""--un/--al/--un-conc/--al-conc read demultiplexing (the reference
implements these in the Perl wrapper, hisat2's hisat2:241-334, by
post-filtering SAM; here reads are written directly as they are classified).

Output format follows the input: FASTQ when qualities exist in the input,
FASTA otherwise.  A path ending in .gz is gzip-compressed.  Paired sinks
expand '%' to the mate number, or insert .1/.2 before the final extension
(bowtie2/hisat2 wrapper convention).

Copied verbatim from hisat2_tpu/io/demux.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import gzip

from ..utils import bitops


def _open_w(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "wt")
    return open(path, "w")


class ReadSink:
    def __init__(self, path: str, fastq: bool):
        self.f = _open_w(path)
        self.fastq = fastq

    def write(self, name, codes, quals):
        seq = bitops.decode_dna(codes)
        if self.fastq:
            qual = "".join(chr(int(q) + 33) for q in quals)
            self.f.write(f"@{name}\n{seq}\n+\n{qual}\n")
        else:
            self.f.write(f">{name}\n{seq}\n")

    def close(self):
        self.f.close()


def mate_paths(path: str) -> tuple[str, str]:
    if "%" in path:
        return path.replace("%", "1"), path.replace("%", "2")
    base, dot, ext = path.rpartition(".")
    if dot and ext and "/" not in ext:
        return f"{base}.1.{ext}", f"{base}.2.{ext}"
    return path + ".1", path + ".2"


class PairSink:
    def __init__(self, path: str, fastq: bool):
        p1, p2 = mate_paths(path)
        self.s1 = ReadSink(p1, fastq)
        self.s2 = ReadSink(p2, fastq)

    def write(self, name, codes1, quals1, codes2, quals2):
        self.s1.write(name, codes1, quals1)
        self.s2.write(name, codes2, quals2)

    def close(self):
        self.s1.close()
        self.s2.close()
