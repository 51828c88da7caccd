"""Host-side FASTA/FASTQ reading into padded code batches.

Pattern-source equivalent of hisat2's pat.h:936-1478 (FASTA) and
pat.h:1360 (FASTQ), reshaped for batch processing: instead of a mutex-guarded
per-read cursor feeding worker threads, the host parses whole files (or
chunks) into [B, L] code arrays + length vectors that stream to the device.

Copied verbatim from hisat2_tpu/io/fasta.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from ..utils import bitops


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        import bz2
        return bz2.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (name, codes uint8) per record."""
    name, parts = None, []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, bitops.encode_dna(b"".join(parts))
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
        if name is not None:
            yield name, bitops.encode_dna(b"".join(parts))


def decode_quals(qual: bytes, mode: str = "phred33") -> np.ndarray:
    """Quality-string decoding (qual.h:1-90): --phred33 (default), --phred64,
    --solexa-quals (10*log10(1+10^(s/10)) remap), --int-quals (space-sep)."""
    if mode == "int":
        q = np.array([int(x) for x in qual.split()], np.int16)
    elif mode == "phred64":
        q = np.frombuffer(qual, np.uint8).astype(np.int16) - 64
    elif mode == "solexa":
        s = np.frombuffer(qual, np.uint8).astype(np.float64) - 64
        q = np.rint(10.0 * np.log10(1.0 + 10.0 ** (s / 10.0))).astype(
            np.int16)
    else:
        q = np.frombuffer(qual, np.uint8).astype(np.int16) - 33
    return np.clip(q, 0, 63).astype(np.uint8)


def iter_reads(path: str, fmt: str = "auto", qual_mode: str = "phred33",
               qc_filter: bool = False
               ) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
    """Yield (name, codes, quals) per read.

    fmt: auto (sniff @/> like the Perl wrapper), fasta, fastq, raw (-r:
    one sequence per line, ordinal names — pat.h:1478), qseq (11-field
    tabbed Illumina qseq, pat.h:1112).  FASTA/raw reads get quality 40
    everywhere ('I'), matching the reference's treatment of quality-less
    input (pat.h fasta parsers set quals to 'I')."""
    if fmt == "auto":
        with _open(path) as f:
            first = f.read(1)
        fmt = "fastq" if first == b"@" else "fasta"
    if fmt == "fastq":
        yield from _iter_fastq(path, qual_mode)
    elif fmt == "raw":
        with _open(path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                codes = bitops.encode_dna(line)
                yield str(i), codes, np.full(len(codes), 40, np.uint8)
    elif fmt == "qseq":
        # machine run lane tile x y index mate seq qual filter; name is the
        # underscore-join of the id fields (pat.h:1112 qseq parser)
        with _open(path) as f:
            for line in f:
                p = line.rstrip(b"\n").split(b"\t")
                if len(p) < 10:
                    continue
                name = b"_".join(p[:7]).decode()
                # mate field appends /1 or /2 (pat.h qseq parser)
                if p[7].strip() in (b"1", b"2"):
                    name += "/" + p[7].strip().decode()
                seq = p[8].replace(b".", b"N")
                rec = (name, bitops.encode_dna(seq),
                       decode_quals(p[9], qual_mode))
                if qc_filter:
                    # 11th field: 1 = passed QC (pat.h qseq; --qc-filter)
                    bad = len(p) >= 11 and p[10].strip() == b"0"
                    yield rec + (bad,)
                else:
                    yield rec
    else:
        for name, codes in iter_fasta(path):
            yield name, codes, np.full(len(codes), 40, np.uint8)


def iter_cmdline(seqs: str) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
    """-c: the -U/-1/-2 operands ARE comma-separated sequences, named by
    ordinal (pat.h:707 VectorPatternSource)."""
    for i, s in enumerate(seqs.split(",")):
        codes = bitops.encode_dna(s.encode())
        yield str(i), codes, np.full(len(codes), 40, np.uint8)


def iter_tabbed(path: str, qual_mode: str = "phred33"):
    """--12: one read (name seq qual) or pair (name seq1 qual1 seq2 qual2)
    per tab-separated line (pat.h:1025).  Yields (name, c1, q1) for
    unpaired lines, (name, c1, q1, c2, q2) for paired lines."""
    with _open(path) as f:
        for line in f:
            p = line.rstrip(b"\n").split(b"\t")
            if len(p) >= 6:
                # tab6: name1 seq1 qual1 name2 seq2 qual2
                yield (p[0].decode(), bitops.encode_dna(p[1]),
                       decode_quals(p[2], qual_mode),
                       bitops.encode_dna(p[4]), decode_quals(p[5], qual_mode))
            elif len(p) >= 5:
                yield (p[0].decode(), bitops.encode_dna(p[1]),
                       decode_quals(p[2], qual_mode),
                       bitops.encode_dna(p[3]), decode_quals(p[4], qual_mode))
            elif len(p) >= 3:
                yield (p[0].decode(), bitops.encode_dna(p[1]),
                       decode_quals(p[2], qual_mode))


def _iter_fastq(path: str, qual_mode: str = "phred33"):
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.strip()
            if not h:
                continue
            seq = f.readline().strip()
            f.readline()  # +
            qual = f.readline().strip()
            name = h[1:].split()[0].decode()
            codes = bitops.encode_dna(seq)
            yield name, codes, decode_quals(qual, qual_mode)


class ReadBatch:
    """A padded batch: names, codes [B, L], quals [B, L], lens [B]."""

    def __init__(self, names, codes_list, quals_list, pad_to: int = None,
                 qc_fail=None):
        self.names = names
        self.qc_fail = (np.asarray(qc_fail, bool) if qc_fail is not None
                        else np.zeros(len(names), bool))
        B = len(names)
        L = max((len(c) for c in codes_list), default=0)
        if pad_to is not None:
            L = pad_to
        self.codes = np.full((B, L), 4, np.uint8)
        self.quals = np.zeros((B, L), np.uint8)
        self.lens = np.zeros(B, np.int32)
        for i, (c, q) in enumerate(zip(codes_list, quals_list)):
            m = min(len(c), L)
            self.codes[i, :m] = c[:m]
            self.quals[i, :m] = q[:m]
            self.lens[i] = m

    def __len__(self):
        return len(self.names)


def _trim(codes, quals, trim5: int, trim3: int):
    if trim5 or trim3:
        end = len(codes) - trim3
        codes, quals = codes[trim5:end], quals[trim5:end]
    return codes, quals


def batch_stream(records, batch_size: int, pad_to: int = None,
                 skip: int = 0, limit: int = None,
                 trim5: int = 0, trim3: int = 0):
    """Batch any (name, codes, quals) iterator (-u/-s/-5/-3 equivalents)."""
    names, cs, qs, qc = [], [], [], []
    seen = 0
    for rec in records:
        name, codes, quals = rec[:3]
        bad = bool(rec[3]) if len(rec) > 3 else False
        if seen < skip:
            seen += 1
            continue
        if limit is not None and seen - skip >= limit:
            break
        seen += 1
        codes, quals = _trim(codes, quals, trim5, trim3)
        names.append(name)
        cs.append(codes)
        qs.append(quals)
        qc.append(bad)
        if len(names) == batch_size:
            yield ReadBatch(names, cs, qs, pad_to, qc)
            names, cs, qs, qc = [], [], [], []
    if names:
        yield ReadBatch(names, cs, qs, pad_to, qc)


def read_batches(path: str, batch_size: int, pad_to: int = None,
                 skip: int = 0, limit: int = None, fmt: str = "auto",
                 qual_mode: str = "phred33", trim5: int = 0, trim3: int = 0,
                 qc_filter: bool = False):
    """Stream ReadBatches of at most batch_size reads from one file."""
    yield from batch_stream(iter_reads(path, fmt, qual_mode, qc_filter),
                            batch_size, pad_to, skip, limit, trim5, trim3)
