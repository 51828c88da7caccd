"""SAM output formatting (reference: hisat2's sam.h SamConfig,
aln_sink.h:1363-1480 AlnSinkSam::appendMate, aln_sink.cpp printAlSumm).

Host-side: the device produces (position, score, edit-count) tuples; this
module renders SAM lines with the same field/tag layout as the reference
(AS, XN, XM, XO, XG, NM, MD, NH, YS, YT) and the end-of-run summary in both
unpaired and paired shapes.

Copied verbatim from hisat2_tpu/io/sam.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np

from ..utils import bitops

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100


def md_and_nm(read_codes: np.ndarray, ref_codes: np.ndarray):
    """MD:Z string + NM count for an ungapped alignment (O(#mismatches))."""
    mism = np.flatnonzero((read_codes != ref_codes) | (read_codes > 3))
    if not mism.size:
        return str(len(read_codes)), 0
    parts = []
    prev = -1
    for i in mism:
        parts.append(str(i - prev - 1))
        parts.append("ACGTN"[min(ref_codes[i], 4)])
        prev = i
    parts.append(str(len(read_codes) - prev - 1))
    return "".join(parts), int(mism.size)


def md_across_segments(seg_pairs, del_refs):
    """MD:Z + mismatch-NM across aligned segments.

    seg_pairs: [(read_codes, ref_codes)] per aligned segment;
    del_refs[i]: deleted reference codes rendered '^...' AFTER segment i
    (None for splices/insertions — they are invisible in MD).
    Returns (md, n_mismatch, n_del)."""
    parts = []
    match_run = 0
    n_mm = n_del = 0
    for i, (rd, ref) in enumerate(seg_pairs):
        mism = np.flatnonzero((rd != ref) | (rd > 3))
        prev = -1
        for m in mism:
            parts.append(str(match_run + (m - prev - 1)))
            parts.append("ACGTN"[min(ref[m], 4)])
            match_run = 0
            prev = m
            n_mm += 1
        match_run += len(rd) - prev - 1
        if i < len(del_refs) and del_refs[i] is not None \
                and len(del_refs[i]):
            parts.append(str(match_run))
            parts.append("^" + "".join("ACGTN"[min(c, 4)]
                                       for c in del_refs[i]))
            match_run = 0
            n_del += len(del_refs[i])
    parts.append(str(match_run))
    return "".join(parts), n_mm, n_del


class SamWriter:
    def __init__(self, out, ref_names, ref_lens, cmdline: str = "",
                 no_head: bool = False, no_unal: bool = False,
                 rg_id: str = None, rg: list = None, annotator=None,
                 rna_strandness: str = "unstranded",
                 omit_sec_seq: bool = False, no_sq: bool = False):
        self.rna_strandness = rna_strandness
        self.omit_sec_seq = omit_sec_seq  # --omit-sec-seq (sam.h)
        self.out = out if hasattr(out, "write") else open(out, "w")
        self.ref_names = ref_names
        self.ref_lens = ref_lens
        self.no_unal = no_unal
        # annotator(aln, rd_aligned) -> (Zs string | None, snp offsets)
        self.annotator = annotator
        # unpaired counters
        self.n_reads = 0
        self.n_unal = 0
        self.n_uniq = 0
        self.n_multi = 0
        # paired counters
        self.n_pairs = 0
        self.n_conc_uniq = 0
        self.n_conc_multi = 0
        self.n_disc = 0
        self.n_mate_unal = 0
        self.n_mate_uniq = 0
        self.n_mate_multi = 0
        if not no_head:
            self.out.write("@HD\tVN:1.0\tSO:unsorted\n")
            if not no_sq:
                for nm, ln in zip(ref_names, ref_lens):
                    self.out.write(f"@SQ\tSN:{nm}\tLN:{ln}\n")
            if rg_id:
                self.out.write("@RG\tID:" + rg_id
                               + "".join("\t" + r for r in (rg or [])) + "\n")
            self.out.write(
                "@PG\tID:hisat2-tpu\tPN:hisat2-tpu\tVN:0.1.0"
                + (f"\tCL:\"{cmdline}\"" if cmdline else "") + "\n")

    # ------------------------------------------------------------------
    def _line(self, name, codes, quals, a, ref_codes_fn, flag_extra=0,
              rnext="*", pnext=0, tlen=0, yt="UU", mate_score=None):
        """One aligned SAM line."""
        flag = ((FLAG_REVERSE if a.rc else 0)
                | (FLAG_SECONDARY if a.secondary else 0) | flag_extra)
        rd = bitops.revcomp_codes(codes) if a.rc else codes
        if a.secondary and self.omit_sec_seq:
            seq = qual = "*"
        else:
            seq = bitops.decode_dna(rd)
            qual = (np.asarray(quals, np.uint8) + 33).tobytes().decode()
            if a.rc:
                qual = qual[::-1]
        L = len(codes)
        cl, cr = a.clip_l, a.clip_r
        mid = L - cl - cr
        xs_tag = None
        xo = xg = 0
        if a.junc_kind == 0:
            cigar = (f"{cl}S" if cl else "") + f"{mid}M" \
                + (f"{cr}S" if cr else "")
            rd_aligned = rd[cl:L - cr]
            if a.n_mm == 0 and a.n_n == 0 and self.annotator is None:
                # edit-free (and no SNP annotation that could put ref
                # chars in MD): skip the reference gather entirely
                md, nm = str(mid), 0
            else:
                ref = ref_codes_fn(a.joined_pos + cl, mid)
                md, nm = md_and_nm(rd_aligned, ref)
            xm = nm
        else:
            # junction alignment: xM (gap op) yM [(gap op) zM] with clips
            segs, juncs = a.segments(L)
            cig = [f"{cl}S"] if cl else []
            seg_pairs, del_refs = [], []
            xo = xg = ins_total = 0
            for si, (lo, hi, diag) in enumerate(segs):
                cig.append(f"{hi - lo}M")
                seg_pairs.append((rd[lo:hi], ref_codes_fn(diag + lo,
                                                          hi - lo)))
                if si < len(juncs):
                    jx, jkind, jlen, jdir = juncs[si]
                    if jkind == 1:
                        cig.append(f"{jlen}N")
                        del_refs.append(None)
                    elif jkind == 2:
                        cig.append(f"{jlen}D")
                        del_refs.append(ref_codes_fn(diag + jx, jlen))
                        xo += 1
                        xg += jlen
                    else:
                        ins = -jlen
                        cig.append(f"{ins}I")
                        del_refs.append(None)
                        xo += 1
                        xg += ins
                        ins_total += ins
                    if jkind == 1 and jdir:
                        xs_tag = "+" if jdir in (1, 3) else "-"
            if cr:
                cig.append(f"{cr}S")
            cigar = "".join(cig)
            md, n_mm_md, n_del = md_across_segments(seg_pairs, del_refs)
            nm = n_mm_md + n_del + ins_total
            xm = n_mm_md
            rd_aligned = rd[cl:L - cr]
        if self.rna_strandness != "unstranded":
            # stranded libraries tag EVERY alignment (sam.h:918-945): the
            # transcript strand follows the mate orientation and protocol
            mate2 = bool(flag_extra & FLAG_SECOND)
            s = self.rna_strandness
            if not mate2:
                minus = (not a.rc and s in ("R", "RF")) \
                    or (a.rc and s in ("F", "FR"))
            else:
                minus = (not a.rc and s in ("F", "FR")) \
                    or (a.rc and s in ("R", "RF"))
            xs_tag = "-" if minus else "+"
        zs_tag = None
        if self.annotator is not None:
            zs_tag, snp_offs = self.annotator(a, rd_aligned)
            nm -= len(snp_offs)  # known-SNP matches don't count as edits
            xm = nm if a.junc_kind == 0 else xm - len(snp_offs)
            if a.junc_kind in (2, 3) and a.junc_known and a.junc_snp >= 0:
                # a known ALT indel is not an edit (snpID-tagged gaps score
                # 0 and are excluded from NM/XO/XG — verified vs oracle:
                # 50M2D50M with NM:i:0 XO:i:0 XG:i:0 Zs:Z:50|D|rsid)
                nm -= xg
                xo = xg = 0
        # tag order mirrors AlnSinkSam::appendMate (sam.h):
        # AS ZS XN XM XO XG NM MD YS XS YT NH Zs
        tags = [f"AS:i:{a.score}"]
        if a.zs is not None:
            tags.append(f"ZS:i:{a.zs}")
        tags += ["XN:i:0", f"XM:i:{xm}", f"XO:i:{xo}", f"XG:i:{xg}",
                 f"NM:i:{nm}", f"MD:Z:{md}"]
        if mate_score is not None:
            tags.append(f"YS:i:{mate_score}")
        tags.append(f"YT:Z:{yt}")
        if xs_tag:
            tags.append(f"XS:A:{xs_tag}")
        tags.append(f"NH:i:{a.nh}")
        if zs_tag:
            tags.append(f"Zs:Z:{zs_tag}")
        return (f"{name}\t{flag}\t{self.ref_names[a.ref_id]}\t"
                f"{a.ref_pos + 1}\t{a.mapq}\t{cigar}\t{rnext}\t{pnext}\t"
                f"{tlen}\t{seq}\t{qual}\t" + "\t".join(tags) + "\n")

    def _unal_line(self, name, codes, quals, flag_extra=0, rname="*",
                   pos=0, rnext="*", pnext=0, yt="UU", yf=None):
        seq = bitops.decode_dna(codes)
        qual = (np.asarray(quals, np.uint8) + 33).tobytes().decode()
        tail = f"\tYF:Z:{yf}" if yf else ""
        return (f"{name}\t{FLAG_UNMAPPED | flag_extra}\t{rname}\t{pos}\t0\t*"
                f"\t{rnext}\t{pnext}\t0\t{seq}\t{qual}\tYT:Z:{yt}"
                f"{tail}\n")

    # ------------------------------------------------------------------
    def write_batch(self, names, codes2d, quals2d, lens, alns_list,
                    ref_codes, n_filtered=None):
        """All SAM lines for a batch of unpaired reads — vectorized.

        Replaces the write_read loop on the hot path: sequence/quality
        ASCII decoding (both orientations) and ungapped MD/NM computation
        run as whole-batch numpy ops; only line assembly is per record.
        Junction / SNP-annotated records fall back to _line (bit-identical
        output by construction).

        codes2d/quals2d: [B, L] padded; lens: [B]; alns_list: per-read
        alignment lists; ref_codes: the joined reference as a uint8 array.
        """
        B, L = codes2d.shape
        lens = np.asarray(lens, np.int64)
        codes2d = np.asarray(codes2d, np.uint8)
        lut = np.frombuffer(b"ACGTN", np.uint8)
        fw_ascii = lut[np.minimum(codes2d, 4)]
        q_ascii = (np.asarray(quals2d, np.uint8) + 33)
        # rc view: reverse each row within its length
        ridx = np.clip(lens[:, None] - 1 - np.arange(L)[None, :], 0, L - 1)
        rc_codes = np.take_along_axis(
            np.where(codes2d < 4, 3 - codes2d, codes2d), ridx, axis=1)
        rc_ascii = lut[np.minimum(rc_codes, 4)]
        rq_ascii = np.take_along_axis(q_ascii, ridx, axis=1)
        fw_b = fw_ascii.tobytes()
        rc_b = rc_ascii.tobytes()
        q_b = q_ascii.tobytes()
        rq_b = rq_ascii.tobytes()

        def seq_of(i, rc):
            s = i * L
            return (rc_b if rc else fw_b)[s:s + lens[i]].decode()

        def qual_of(i, rc):
            s = i * L
            return (rq_b if rc else q_b)[s:s + lens[i]].decode()

        # pass 1: collect simple (ungapped, unannotated) records for the
        # batched MD/NM computation
        simple = []          # (read i, aln a, rc, cl, mid, start)
        for i, alns in enumerate(alns_list):
            for a in alns:
                if a.junc_kind == 0 and self.annotator is None:
                    li = int(lens[i])
                    simple.append((i, a, int(a.clip_l),
                                   li - a.clip_l - a.clip_r))
        md_strs = {}
        if simple:
            ri = np.array([s[0] for s in simple], np.int64)
            cl = np.array([s[2] for s in simple], np.int64)
            mid = np.array([s[3] for s in simple], np.int64)
            st = np.array([s[1].joined_pos for s in simple], np.int64) + cl
            isrc = np.array([s[1].rc for s in simple], bool)
            col = np.arange(L, dtype=np.int64)[None, :]
            colm = col < mid[:, None]
            refm = ref_codes[np.clip(st[:, None] + col, 0,
                                     len(ref_codes) - 1)]
            rdall = np.where(isrc[:, None], rc_codes[ri], codes2d[ri])
            rdal = np.take_along_axis(
                rdall, np.minimum(cl[:, None] + col, L - 1), axis=1)
            mm = ((rdal != refm) | (rdal > 3)) & colm
            nmv = mm.sum(axis=1)
            wr, wc = np.nonzero(mm)
            # group mismatch columns per record (wr ascending)
            bounds = np.searchsorted(wr, np.arange(len(simple) + 1))
            for k in range(len(simple)):
                if nmv[k] == 0:
                    md_strs[k] = (str(int(mid[k])), 0)
                else:
                    cols = wc[bounds[k]:bounds[k + 1]]
                    parts = []
                    prev = -1
                    rrow = refm[k]
                    for m in cols:
                        parts.append(str(m - prev - 1))
                        parts.append("ACGTN"[min(rrow[m], 4)])
                        prev = m
                    parts.append(str(int(mid[k]) - prev - 1))
                    md_strs[k] = ("".join(parts), int(nmv[k]))

        out_w = self.out.write
        srd = self.rna_strandness
        k = 0
        for i, alns in enumerate(alns_list):
            name = names[i]
            self.n_reads += 1
            if not alns:
                self.n_unal += 1
                if not self.no_unal:
                    nf = n_filtered[i] if n_filtered is not None else False
                    tail = "\tYF:Z:NS" if nf else ""
                    out_w(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                          f"{seq_of(i, False)}\t{qual_of(i, False)}"
                          f"\tYT:Z:UU{tail}\n")
                continue
            if alns[0].nh == 1:
                self.n_uniq += 1
            else:
                self.n_multi += 1
            for a in alns:
                if not (a.junc_kind == 0 and self.annotator is None):
                    out_w(self._line(
                        name, codes2d[i, :lens[i]], q_ascii[i, :lens[i]] - 33,
                        a, lambda p, s: ref_codes[p:p + s]))
                    continue
                md, nm = md_strs[k]
                k += 1
                flag = (16 if a.rc else 0) | (256 if a.secondary else 0)
                if a.secondary and self.omit_sec_seq:
                    seq = qual = "*"
                else:
                    seq = seq_of(i, a.rc)
                    qual = qual_of(i, a.rc)
                cl_, cr_ = a.clip_l, a.clip_r
                mid_ = lens[i] - cl_ - cr_
                cigar = ((f"{cl_}S" if cl_ else "") + f"{mid_}M"
                         + (f"{cr_}S" if cr_ else ""))
                zs = f"\tZS:i:{a.zs}" if a.zs is not None else ""
                if srd != "unstranded":
                    minus = (not a.rc and srd in ("R", "RF")) \
                        or (a.rc and srd in ("F", "FR"))
                    xs = "\tXS:A:" + ("-" if minus else "+")
                else:
                    xs = ""
                out_w(f"{name}\t{flag}\t{self.ref_names[a.ref_id]}\t"
                      f"{a.ref_pos + 1}\t{a.mapq}\t{cigar}\t*\t0\t0\t"
                      f"{seq}\t{qual}\tAS:i:{a.score}{zs}\tXN:i:0\t"
                      f"XM:i:{nm}\tXO:i:0\tXG:i:0\tNM:i:{nm}\tMD:Z:{md}"
                      f"\tYT:Z:UU{xs}\tNH:i:{a.nh}\n")
            # skip md slots consumed by fallback records
        assert k == len(simple) or self.annotator is not None

    # ------------------------------------------------------------------
    def write_batch_raw(self, names, codes2d, quals2d, lens, raw,
                        ref_codes, n_filtered=None, finalize=None):
        """Array-native unpaired batch writer: renders straight from
        BatchResult.raw columns without materializing Alignment objects.

        Reads that need per-read logic (multimaps -> RNG tie-break via the
        `finalize` callback, junction CIGARs, SNP annotation) fall back to
        the object path; everything else renders from whole-batch numpy.
        Output is byte-identical to the write_read loop."""
        B, L = codes2d.shape
        lens = np.asarray(lens, np.int64)
        codes2d = np.asarray(codes2d, np.uint8)
        lut = np.frombuffer(b"ACGTN", np.uint8)
        fw_ascii = lut[np.minimum(codes2d, 4)]
        q_ascii = (np.asarray(quals2d, np.uint8) + 33)
        if bool((lens == L).all()):
            # uniform lengths: reverse-complement is a flip, not a gather
            rc_codes = np.ascontiguousarray(
                np.where(codes2d < 4, 3 - codes2d, codes2d)[:, ::-1])
            rq_ascii = np.ascontiguousarray(q_ascii[:, ::-1])
        else:
            ridx = np.clip(lens[:, None] - 1 - np.arange(L)[None, :],
                           0, L - 1)
            rc_codes = np.take_along_axis(
                np.where(codes2d < 4, 3 - codes2d, codes2d), ridx, axis=1)
            rq_ascii = np.take_along_axis(q_ascii, ridx, axis=1)
        rc_ascii = lut[np.minimum(rc_codes, 4)]
        fw_b, rc_b = fw_ascii.tobytes(), rc_ascii.tobytes()
        q_b, rq_b = q_ascii.tobytes(), rq_ascii.tobytes()

        lens_sl = lens.tolist()

        def seq_of(i, rc):
            s = i * L
            return (rc_b if rc else fw_b)[s:s + lens_sl[i]].decode()

        def qual_of(i, rc):
            s = i * L
            return (rq_b if rc else q_b)[s:s + lens_sl[i]].decode()

        cols = raw["cols"] if raw is not None else None
        if cols is None or not len(cols[0]):
            rd_col = np.empty(0, np.int64)
        else:
            rd_col = np.asarray(cols[0])
        counts = np.bincount(rd_col, minlength=B)
        cplx = counts > 1
        if len(rd_col):
            jk_col = np.asarray(cols[16])
            cplx[rd_col[jk_col != 0]] = True
        if self.annotator is not None:
            cplx[:] = True
        # simple rows: the read's single ungapped alignment
        simp = np.flatnonzero(~cplx[rd_col]) if len(rd_col) else rd_col
        from ..native import get_samfmt
        lib = get_samfmt()
        md_cache = {}
        mmdat = None
        if simp.size:
            ri = rd_col[simp]
            isrc = np.asarray(cols[1])[simp].astype(bool)
            cl = np.asarray(cols[5])[simp]
            cr = np.asarray(cols[6])[simp]
            mid = lens[ri] - cl - cr
            st = np.asarray(cols[4])[simp] + cl
            col = np.arange(L, dtype=np.int64)[None, :]
            colm = col < mid[:, None]
            refm = ref_codes[np.clip(st[:, None] + col, 0,
                                     len(ref_codes) - 1)]
            rdall = np.where(isrc[:, None], rc_codes[ri], codes2d[ri])
            rdal = np.take_along_axis(
                rdall, np.minimum(cl[:, None] + col, L - 1), axis=1)
            mm = ((rdal != refm) | (rdal > 3)) & colm
            nmv = mm.sum(axis=1)
            wr, wc = np.nonzero(mm)
            bounds = np.searchsorted(wr, np.arange(simp.size + 1))
            if lib is not None:
                # the native renderer builds MD inline from the raw
                # mismatch positions + ref chars
                mmdat = (ri, nmv, wr, wc, refm)
            else:
                for t in range(simp.size):
                    if nmv[t] == 0:
                        md_cache[simp[t]] = (str(int(mid[t])), 0)
                    else:
                        cc = wc[bounds[t]:bounds[t + 1]]
                        parts = []
                        prev = -1
                        rrow = refm[t]
                        for m in cc:
                            parts.append(str(m - prev - 1))
                            parts.append("ACGTN"[min(rrow[m], 4)])
                            prev = m
                        parts.append(str(int(mid[t]) - prev - 1))
                        md_cache[simp[t]] = ("".join(parts), int(nmv[t]))
        # per-read first-row offsets (rows sorted by read)
        row0 = np.searchsorted(rd_col, np.arange(B)).tolist()
        if lib is not None:
            return self._render_batch_native(
                lib, names, B, L, lens, counts, cplx, row0, mmdat,
                cols, rd_col, fw_ascii, q_ascii, rc_ascii, rq_ascii,
                codes2d, n_filtered, finalize, ref_codes,
                lens_sl, seq_of, qual_of)
        (c_rc, c_rid, c_rpos, c_cl, c_cr, c_sc, c_mq, c_hs, c_zs) = (
            np.asarray(cols[j]).tolist()
            for j in (1, 2, 3, 5, 6, 8, 11, 14, 15)
        ) if len(rd_col) else ([],) * 9
        counts = counts.tolist()
        cplx_l = cplx.tolist()
        out_w = self.out.write
        srd = self.rna_strandness
        simp_md = md_cache
        n_filt = (n_filtered.tolist()
                  if isinstance(n_filtered, np.ndarray) else n_filtered)
        for i in range(B):
            name = names[i]
            self.n_reads += 1
            if counts[i] == 0 or (n_filt is not None
                                  and n_filt[i] == 2):
                self.n_unal += 1
                if not self.no_unal:
                    nf = n_filt[i] if n_filt is not None else False
                    tail = ("\tYF:Z:QC" if nf == 2 else
                            "\tYF:Z:NS" if nf else "")
                    out_w(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                          f"{seq_of(i, False)}\t{qual_of(i, False)}"
                          f"\tYT:Z:UU{tail}\n")
                continue
            if cplx_l[i]:
                alns = finalize(i)
                if not alns:
                    self.n_unal += 1
                    if not self.no_unal:
                        out_w(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                              f"{seq_of(i, False)}\t{qual_of(i, False)}"
                              f"\tYT:Z:UU\n")
                    continue
                if alns[0].nh == 1:
                    self.n_uniq += 1
                else:
                    self.n_multi += 1
                for a in alns:
                    out_w(self._line(
                        name, codes2d[i, :lens_sl[i]],
                        q_ascii[i, :lens_sl[i]].astype(np.int32) - 33, a,
                        lambda p, s: ref_codes[p:p + s]))
                continue
            self.n_uniq += 1
            t = row0[i]
            md, nm = simp_md[t]
            rc = c_rc[t]
            flag = 16 if rc else 0
            seq = seq_of(i, rc)
            qual = qual_of(i, rc)
            cl_, cr_ = c_cl[t], c_cr[t]
            mid_ = lens_sl[i] - cl_ - cr_
            cigar = ((f"{cl_}S" if cl_ else "") + f"{mid_}M"
                     + (f"{cr_}S" if cr_ else ""))
            zs = f"\tZS:i:{c_zs[t]}" if c_hs[t] else ""
            if srd != "unstranded":
                minus = (not rc and srd in ("R", "RF")) \
                    or (rc and srd in ("F", "FR"))
                xs = "\tXS:A:" + ("-" if minus else "+")
            else:
                xs = ""
            out_w(f"{name}\t{flag}\t{self.ref_names[c_rid[t]]}\t"
                  f"{c_rpos[t] + 1}\t{c_mq[t]}\t{cigar}\t*\t0\t0\t"
                  f"{seq}\t{qual}\tAS:i:{c_sc[t]}{zs}\tXN:i:0\t"
                  f"XM:i:{nm}\tXO:i:0\tXG:i:0\tNM:i:{nm}\tMD:Z:{md}"
                  f"\tYT:Z:UU{xs}\tNH:i:1\n")

    def _render_batch_native(self, lib, names, B, L, lens, counts, cplx,
                             row0, mmdat, cols, rd_col,
                             fw_ascii, q_ascii, rc_ascii, rq_ascii,
                             codes2d, n_filtered, finalize,
                             ref_codes, lens_sl, seq_of, qual_of):
        """Native fast path of write_batch_raw: unaligned + simple-unique
        records render in C (native/samfmt.c); complex reads keep the
        object path and interleave in read order.  Byte-identical to the
        Python loop."""
        counts_a = np.asarray(counts, np.int64)
        unal = counts_a == 0
        kind = np.full(B, 1, np.int8)
        kind[unal] = 0
        if n_filtered is not None:
            nfa = np.asarray(n_filtered)
            kind[unal & (nfa.astype(bool))] = 4
            # --qc-filter: filtered reads report unaligned + YF:Z:QC
            # regardless of any device rows
            kind[nfa == 2] = 6
            unal = unal | (nfa == 2)
        kind[np.asarray(cplx, bool) & ~unal] = 3
        row0_a = np.asarray(row0, np.int64)
        nrow = len(rd_col)
        t = np.clip(row0_a, 0, max(nrow - 1, 0))

        def g(j, dt=np.int32):
            if not nrow:
                return np.zeros(B, dt)
            return np.ascontiguousarray(np.asarray(cols[j])[t].astype(dt))

        rc_r = g(1, np.int8)
        rid_r = g(2)
        rpos1 = g(3, np.int64) + 1
        mq_r, cl_r, cr_r, sc_r = g(11), g(5), g(6), g(8)
        hs_r, zs_r = g(14, np.int8), g(15)
        # mismatch arrays for the in-C MD build: rows of mmdat are the
        # simple reads in ascending read order, matching the cumsum
        mm_off = np.zeros(B + 1, np.int64)
        mm_pos = np.zeros(0, np.int32)
        mm_ref = np.zeros(0, np.uint8)
        if mmdat is not None:
            ri, nmv, wr, wc, refm = mmdat
            cnt = np.zeros(B, np.int64)
            cnt[ri] = nmv
            mm_off[1:] = np.cumsum(cnt)
            mm_pos = np.ascontiguousarray(wc.astype(np.int32))
            lut = np.frombuffer(b"ACGTN", np.uint8)
            mm_ref = np.ascontiguousarray(
                lut[np.minimum(refm[wr, wc], 4)])
        srd = self.rna_strandness
        xs_code = np.zeros(B, np.int8)
        if srd != "unstranded":
            rcb = rc_r.astype(bool)
            minus = (~rcb if srd in ("R", "RF") else rcb)
            xs_code = np.where(minus, 2, 1).astype(np.int8)
        nb = np.frombuffer("".join(names).encode(), np.uint8)
        noff = np.zeros(B + 1, np.int64)
        noff[1:] = np.cumsum([len(n) for n in names])
        if getattr(self, "_ref_nb", None) is None:
            self._ref_nb = np.frombuffer(
                "".join(self.ref_names).encode(), np.uint8)
            ro = np.zeros(len(self.ref_names) + 1, np.int64)
            ro[1:] = np.cumsum([len(r) for r in self.ref_names])
            self._ref_off = ro
        maxname = int((noff[1:] - noff[:-1]).max()) if B else 8
        stride = maxname + 4 * L + 192
        outb = np.empty(B * stride, np.uint8)
        outl = np.zeros(B, np.int32)
        lens32 = np.ascontiguousarray(np.asarray(lens, np.int32))
        cp = lambda a: a.ctypes.data  # noqa: E731
        lib.sam_render_batch(
            B, L, stride, cp(nb), cp(noff),
            cp(fw_ascii), cp(q_ascii), cp(rc_ascii), cp(rq_ascii),
            cp(lens32), cp(kind), cp(rc_r),
            cp(self._ref_nb), cp(self._ref_off),
            cp(rid_r), cp(rpos1), cp(mq_r), cp(cl_r), cp(cr_r),
            cp(sc_r), cp(hs_r), cp(zs_r), cp(xs_code),
            cp(mm_off), cp(mm_pos), cp(mm_ref),
            np.int8(1 if self.no_unal else 0), cp(outb), cp(outl))
        self.n_reads += B
        self.n_unal += int(unal.sum())
        self.n_uniq += int((kind == 1).sum())
        ob = outb.tobytes()
        ol = outl.tolist()
        kind_l = kind.tolist()
        parts = []
        rfn = lambda p, s: ref_codes[p:p + s]  # noqa: E731
        for i in range(B):
            if kind_l[i] == 3:
                alns = finalize(i)
                if not alns:
                    self.n_unal += 1
                    if not self.no_unal:
                        parts.append(
                            (f"{names[i]}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                             f"{seq_of(i, False)}\t{qual_of(i, False)}"
                             f"\tYT:Z:UU\n").encode())
                    continue
                if alns[0].nh == 1:
                    self.n_uniq += 1
                else:
                    self.n_multi += 1
                qp = q_ascii[i, :lens_sl[i]].astype(np.int32) - 33
                for a in alns:
                    parts.append(self._line(
                        names[i], codes2d[i, :lens_sl[i]], qp, a,
                        rfn).encode())
            elif ol[i]:
                parts.append(ob[i * stride:i * stride + ol[i]])
        self.out.write(b"".join(parts).decode())

    # ------------------------------------------------------------------
    def write_read(self, name, codes, quals, alns, ref_codes_fn,
                   n_filtered: bool = False):
        """All SAM lines for one unpaired read.  n_filtered marks reads
        rejected by the N-ceiling (YF:Z:NS, sam.h / nFilter)."""
        self.n_reads += 1
        if not alns:
            self.n_unal += 1
            if not self.no_unal:
                self.out.write(self._unal_line(
                    name, codes, quals,
                    yf="NS" if n_filtered else None))
            return
        if alns[0].nh == 1:
            self.n_uniq += 1
        else:
            self.n_multi += 1
        for a in alns:
            self.out.write(self._line(name, codes, quals, a, ref_codes_fn))

    # ------------------------------------------------------------------
    def write_pair(self, name, codes1, quals1, codes2, quals2,
                   pairs, alns1, alns2, ref_codes_fn, discordant=False):
        """All SAM lines for one read pair.

        pairs: list of (a1, a2, tlen1, tlen2) concordant (or
        discordant) combos;
        if empty, falls back to mixed/unpaired records from alns1/alns2."""
        self.n_pairs += 1
        if pairs:
            if discordant:
                self.n_disc += 1
                yt = "DP"
                proper = 0
            else:
                if len(pairs) == 1:
                    self.n_conc_uniq += 1
                else:
                    self.n_conc_multi += 1
                yt = "CP"
                proper = FLAG_PROPER
            for (a1, a2, tlen1, tlen2) in pairs:
                f1 = (FLAG_PAIRED | proper | FLAG_FIRST
                      | (FLAG_MATE_REVERSE if a2.rc else 0))
                f2 = (FLAG_PAIRED | proper | FLAG_SECOND
                      | (FLAG_MATE_REVERSE if a1.rc else 0))
                rn1 = "=" if a1.ref_id == a2.ref_id else \
                    self.ref_names[a2.ref_id]
                rn2 = "=" if a1.ref_id == a2.ref_id else \
                    self.ref_names[a1.ref_id]
                self.out.write(self._line(
                    name, codes1, quals1, a1, ref_codes_fn, flag_extra=f1,
                    rnext=rn1, pnext=a2.ref_pos + 1, tlen=tlen1, yt=yt,
                    mate_score=a2.score))
                self.out.write(self._line(
                    name, codes2, quals2, a2, ref_codes_fn, flag_extra=f2,
                    rnext=rn2, pnext=a1.ref_pos + 1, tlen=tlen2, yt=yt,
                    mate_score=a1.score))
            return
        # mixed mode: report mates independently (YT:Z:UP); when exactly one
        # mate aligns the reference emits the ALIGNED record first
        # (AlnSinkWrap::finishRead mate ordering)
        mates = [(codes1, quals1, alns1, alns2, FLAG_FIRST),
                 (codes2, quals2, alns2, alns1, FLAG_SECOND)]
        if not alns1 and alns2:
            mates.reverse()
        for codes, quals, alns, other, fmate in mates:
            base = FLAG_PAIRED | fmate
            if alns:
                if alns[0].nh == 1:
                    self.n_mate_uniq += 1
                else:
                    self.n_mate_multi += 1
                oa = other[0] if other else None
                for a in alns:
                    fx = base | (0 if other else FLAG_MATE_UNMAPPED)
                    if oa is not None and oa.rc:
                        fx |= FLAG_MATE_REVERSE
                    if oa is not None:
                        rnext = "=" if oa.ref_id == a.ref_id else \
                            self.ref_names[oa.ref_id]
                        pnext = oa.ref_pos + 1
                    else:
                        # unmapped mate is placed at this alignment
                        rnext = "="
                        pnext = a.ref_pos + 1
                    self.out.write(self._line(
                        name, codes, quals, a, ref_codes_fn, flag_extra=fx,
                        rnext=rnext, pnext=pnext, yt="UP",
                        mate_score=oa.score if oa is not None else None))
            else:
                self.n_mate_unal += 1
                oa = other[0] if other else None
                fx = base | (0 if other else FLAG_MATE_UNMAPPED)
                if oa is not None:
                    if oa.rc:
                        fx |= FLAG_MATE_REVERSE
                    if not self.no_unal:
                        self.out.write(self._unal_line(
                            name, codes, quals, flag_extra=fx,
                            rname=self.ref_names[oa.ref_id],
                            pos=oa.ref_pos + 1, rnext="=",
                            pnext=oa.ref_pos + 1, yt="UP"))
                elif not self.no_unal:
                    self.out.write(self._unal_line(
                        name, codes, quals, flag_extra=fx, yt="UP"))

    # ------------------------------------------------------------------
    def summary(self, new: bool = False) -> str:
        """printAlSumm-equivalent summary (aln_sink.cpp:_printAlSumm);
        new=True gives the machine-friendly --new-summary style
        (aln_sink.h:1506-1526)."""
        if new:
            pct = lambda a, b: f"{100.0 * a / max(b, 1):.2f}%"  # noqa: E731
            ls = ["HISAT2 summary stats:"]
            if self.n_pairs:
                n = self.n_pairs
                nc0 = n - self.n_conc_uniq - self.n_conc_multi
                nodisc = nc0 - self.n_disc
                mates = nodisc * 2
                al_mates = mates - self.n_mate_unal
                tot_cand = n * 2
                tot_al = (self.n_conc_uniq + self.n_conc_multi
                          + self.n_disc) * 2 + al_mates
                ls += [f"\tTotal pairs: {n}",
                       "\t\tAligned concordantly or discordantly 0 time: "
                       f"{nodisc} ({pct(nodisc, n)})",
                       f"\t\tAligned concordantly 1 time: "
                       f"{self.n_conc_uniq} ({pct(self.n_conc_uniq, n)})",
                       f"\t\tAligned concordantly >1 times: "
                       f"{self.n_conc_multi} ({pct(self.n_conc_multi, n)})",
                       f"\t\tAligned discordantly 1 time: "
                       f"{self.n_disc} ({pct(self.n_disc, n)})",
                       f"\tTotal unpaired reads: {mates}",
                       f"\t\tAligned 0 time: {self.n_mate_unal} "
                       f"({pct(self.n_mate_unal, mates)})",
                       f"\t\tAligned 1 time: {self.n_mate_uniq} "
                       f"({pct(self.n_mate_uniq, mates)})",
                       f"\t\tAligned >1 times: {self.n_mate_multi} "
                       f"({pct(self.n_mate_multi, mates)})"]
            else:
                n = self.n_reads
                tot_cand = n
                tot_al = n - self.n_unal
                ls += [f"\tTotal reads: {n}",
                       f"\t\tAligned 0 time: {self.n_unal} "
                       f"({pct(self.n_unal, n)})",
                       f"\t\tAligned 1 time: {self.n_uniq} "
                       f"({pct(self.n_uniq, n)})",
                       f"\t\tAligned >1 times: {self.n_multi} "
                       f"({pct(self.n_multi, n)})"]
            ls.append(f"\tOverall alignment rate: "
                      f"{pct(tot_al, tot_cand)}")
            return "\n".join(ls) + "\n"
        if self.n_pairs:
            n = self.n_pairs
            conc0 = n - self.n_conc_uniq - self.n_conc_multi
            nodisc = conc0 - self.n_disc
            mates = nodisc * 2
            pct = lambda a, b: f"{100.0 * a / max(b, 1):.2f}%"
            total_reads = n * 2
            unal = self.n_mate_unal
            rate = 100.0 * (total_reads - unal) / max(total_reads, 1)
            return (
                f"{n} reads; of these:\n"
                f"  {n} ({pct(n, n)}) were paired; of these:\n"
                f"    {conc0} ({pct(conc0, n)}) aligned concordantly 0 times\n"
                f"    {self.n_conc_uniq} ({pct(self.n_conc_uniq, n)}) "
                f"aligned concordantly exactly 1 time\n"
                f"    {self.n_conc_multi} ({pct(self.n_conc_multi, n)}) "
                f"aligned concordantly >1 times\n"
                f"    ----\n"
                f"    {conc0} pairs aligned concordantly 0 times; of these:\n"
                f"      {self.n_disc} ({pct(self.n_disc, conc0)}) "
                f"aligned discordantly 1 time\n"
                f"    ----\n"
                f"    {nodisc} pairs aligned 0 times concordantly or "
                f"discordantly; of these:\n"
                f"      {mates} mates make up the pairs; of these:\n"
                f"        {unal} ({pct(unal, mates)}) aligned 0 times\n"
                f"        {self.n_mate_uniq} ({pct(self.n_mate_uniq, mates)})"
                f" aligned exactly 1 time\n"
                f"        {self.n_mate_multi} "
                f"({pct(self.n_mate_multi, mates)}) aligned >1 times\n"
                f"{rate:.2f}% overall alignment rate\n")
        n = max(self.n_reads, 1)
        rate = 100.0 * (self.n_reads - self.n_unal) / n
        return (f"{self.n_reads} reads; of these:\n"
                f"  {self.n_reads} (100.00%) were unpaired; of these:\n"
                f"    {self.n_unal} ({100.0 * self.n_unal / n:.2f}%) "
                f"aligned 0 times\n"
                f"    {self.n_uniq} ({100.0 * self.n_uniq / n:.2f}%) "
                f"aligned exactly 1 time\n"
                f"    {self.n_multi} ({100.0 * self.n_multi / n:.2f}%) "
                f"aligned >1 times\n"
                f"{rate:.2f}% overall alignment rate\n")

    def close(self):
        if hasattr(self.out, "close"):
            self.out.close()
