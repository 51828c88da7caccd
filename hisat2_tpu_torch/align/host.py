"""The numpy host phase of the aligner, carried from the JAX package.

hisat2_tpu/align/pipeline.py imports jax at module scope (:26-27), so the
port cannot import it on a machine without JAX.  This module is a copy of
its numpy-only host code, for unpaired and paired reads, DNA and spliced:

  SpillOverflow, Alignment, RAW_COLS, _materialize_alignments,
  read_alignments, BatchResult          <- pipeline.py:43-222
  HostPhase._fetch_out, _unspill        <- pipeline.py:632-722
  HostPhase._eval_order_suppress        <- pipeline.py:2012-2121
  HostPhase._host_phase                 <- pipeline.py:2123-3020

_host_phase is verbatim: the q2_/q3_/r2_/r3_ composite columns of the
spliced step (multi-junction spans), the --tmo and --dta-cufflinks
filters, the conflicting-splice-strand penalty, and the spliced
trimmed-representation ZS model are all in it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..ops.splice import KIND_DEL, KIND_INS, KIND_NONE, KIND_SPL
from ..utils.trace import section_timer
from . import mapq as mapq_mod
from .scoring import SimpleFunc


class SpillOverflow(Exception):
    """A spill-layout batch had more valid non-head slots than its S=2B
    spill rows (multimap-saturated input); callers re-run full_out."""


@dataclasses.dataclass
class Alignment:
    """One reported alignment (AlnRes equivalent, aligner_result.h).

    Junction fields describe at most one splice/indel join (combineWith
    product, hi_aligner.h:1286): the read splits at `junc_x` (first read
    base of the right segment); `junc_len` is the reference skip (intron or
    deletion length; negative = insertion length); `spl_dir` is the
    SPL_FW/RC/SEMI_* classification driving the XS:A tag."""
    read_idx: int
    rc: bool              # reverse-complement orientation
    ref_id: int
    ref_pos: int          # 0-based ref position of the first ALIGNED base
    joined_pos: int       # joined position of the (unclipped) read start
    clip_l: int           # soft-clipped bases at alignment start (trim5)
    clip_r: int           # soft-clipped bases at alignment end (trim3)
    aln_span: int         # aligned reference span (incl. intron/del skip)
    score: int
    n_mm: int
    n_n: int
    mapq: int
    nh: int
    secondary: bool
    zs: Optional[int] = None   # secbest score (SAM ZS:i), when one exists
    junc_kind: int = 0         # 0 none, 1 splice (N), 2 deletion, 3 insertion
    junc_x: int = 0            # read pos of the right segment's first base
    junc_len: int = 0          # REFERENCE-space skip (>0 N/D; <0 insertion;
                               #   may exceed the joined gap across N runs)
    junc_d2: int = 0           # joined diagonal of the right segment
    spl_dir: int = 0           # splice_ops.SPL_*
    junc_known: bool = False   # known splice site / known ALT indel
    junc_snp: int = -1         # VariantDB snp index of a known ALT indel
    # optional SECOND junction (multi-exon reads): read splits at
    # junc_x < junc2_x into three segments on diagonals
    # (joined_pos, junc_d2, junc2_d3)
    junc2_kind: int = 0
    junc2_x: int = 0
    junc2_len: int = 0
    junc2_d3: int = 0
    junc2_dir: int = 0
    # optional THIRD junction (4 exons in one read; the reference's
    # hybridSearch_recur recurses arbitrarily, spliced_aligner.h:183-214 —
    # depth 3 covers every read a 2-pass left+right composite can reach)
    junc3_kind: int = 0
    junc3_x: int = 0
    junc3_len: int = 0
    junc3_d4: int = 0
    junc3_dir: int = 0

    def segments(self, read_len: int):
        """[(read_lo, read_hi, joined_diag)] aligned segments plus the
        junction list [(x, kind, ref_len, dir)] — the generic shape SAM
        rendering and site collection iterate over."""
        cl, cr = self.clip_l, self.clip_r
        if self.junc_kind == 0:
            return ([(cl, read_len - cr, self.joined_pos)], [])
        ins1 = max(-self.junc_len, 0) if self.junc_kind == 3 else 0
        segs = [(cl, self.junc_x, self.joined_pos)]
        juncs = [(self.junc_x, self.junc_kind, self.junc_len,
                  self.spl_dir)]
        if self.junc2_kind == 0:
            segs.append((self.junc_x + ins1, read_len - cr, self.junc_d2))
            return segs, juncs
        ins2 = max(-self.junc2_len, 0) if self.junc2_kind == 3 else 0
        segs.append((self.junc_x + ins1, self.junc2_x, self.junc_d2))
        juncs.append((self.junc2_x, self.junc2_kind, self.junc2_len,
                      self.junc2_dir))
        if self.junc3_kind == 0:
            segs.append((self.junc2_x + ins2, read_len - cr,
                         self.junc2_d3))
            return segs, juncs
        segs.append((self.junc2_x + ins2, self.junc3_x, self.junc2_d3))
        segs.append((self.junc3_x, read_len - cr, self.junc3_d4))
        juncs.append((self.junc3_x, self.junc3_kind, self.junc3_len,
                      self.junc3_dir))
        return segs, juncs

    @property
    def aln_start(self) -> int:
        """Joined position of the first aligned base."""
        return self.joined_pos + self.clip_l


# column order of BatchResult.raw["cols"] (one entry per kept alignment,
# rows sorted by read then report rank) — matches the Alignment fields
# materialized in _materialize_alignments
RAW_COLS = ("read", "rc", "ref_id", "ref_pos", "joined_pos", "clip_l",
            "clip_r", "aln_span", "score", "n_mm", "n_n", "mapq", "nh",
            "secondary", "has_sec", "zs", "junc_kind", "junc_x",
            "junc_len", "junc_d2", "spl_dir", "junc_known", "junc_snp",
            "junc2_kind", "junc2_x", "junc2_len", "junc2_d3", "junc2_dir",
            "junc3_kind", "junc3_x", "junc3_len", "junc3_d4", "junc3_dir")


def _materialize_alignments(raw, n_reads):
    """Build per-read Alignment object lists from the raw column arrays
    (the slow path — array-native consumers read raw directly)."""
    per_read = [[] for _ in range(n_reads)]
    if raw is None or not len(raw["cols"][0]):
        return per_read
    cols = [c.tolist() for c in raw["cols"]]
    for t in range(len(cols[0])):
        (rd, rc_t, rid, rpos, jp, cl, cr, span, sct, nmm, nnn, mqt,
         nrep, sec2, hs, zs2, jk, jx, jl, jd2, sd, jkn, jsnp,
         j2k, j2x, j2l, j2d3, j2d,
         j3k, j3x, j3l, j3d4, j3d) = (c[t] for c in cols)
        per_read[rd].append(Alignment(
            read_idx=rd, rc=bool(rc_t), ref_id=rid,
            ref_pos=rpos, joined_pos=jp,
            clip_l=cl, clip_r=cr, aln_span=span,
            score=sct, n_mm=nmm, n_n=nnn,
            mapq=mqt, nh=nrep,
            secondary=bool(sec2),
            zs=(zs2 if hs else None),
            junc_kind=jk, junc_x=jx, junc_len=jl,
            junc_d2=jd2, spl_dir=sd,
            junc_known=bool(jkn), junc_snp=jsnp,
            junc2_kind=j2k, junc2_x=j2x,
            junc2_len=j2l, junc2_d3=j2d3,
            junc2_dir=j2d,
            junc3_kind=j3k, junc3_x=j3x,
            junc3_len=j3l, junc3_d4=j3d4,
            junc3_dir=j3d))
    return per_read


def read_alignments(raw, i):
    """Alignment objects for ONE read from the raw columns (rows are
    sorted by read, so a binary search bounds the slice)."""
    if raw is None:
        return []
    rd = raw["cols"][0]
    lo = int(np.searchsorted(rd, i))
    hi = int(np.searchsorted(rd, i + 1))
    if lo == hi:
        return []
    sub = {"cols": [c[lo:hi] for c in raw["cols"]]}
    return _materialize_alignments(sub, i + 1)[i]


@dataclasses.dataclass
class BatchResult:
    n_reads: int
    # per-lane search metadata (lane = read for fw, read + n_reads for rc)
    # for the paired give-up replay: round log words, round counts,
    # align() verdict, per-lane best reported score
    lanes: Optional[dict] = None
    # unpaired orientation report ranks [B, 2] from the eval-order replay
    orient_ranks: Optional[np.ndarray] = None
    # array-native result: {"cols": [arrays in RAW_COLS order]} — rows are
    # kept alignments sorted by read then report rank.  The vectorized SAM
    # renderer consumes this directly; Alignment objects materialize only
    # on first .alignments access (pair/splice/genotype consumers).
    raw: Optional[dict] = None
    _alignments: Optional[list] = None

    @property
    def alignments(self):
        if self._alignments is None:
            self._alignments = _materialize_alignments(self.raw,
                                                       self.n_reads)
        return self._alignments

    @property
    def n_aligned(self):
        return sum(1 for a in self.alignments if a)

    @property
    def n_unique(self):
        return sum(1 for a in self.alignments if a and a[0].nh == 1)

    @property
    def n_multi(self):
        return sum(1 for a in self.alignments if a and a[0].nh > 1)


class HostPhase:
    """Host-side halves of the aligner: unpacking the device buffer and
    the per-batch selection / MAPQ / ZS policy.  Expects the attributes
    TorchAligner sets (scoring, meta, k, msize, min_k, frag_*, no_fw,
    no_rc, _out_specs, _spill_meta)."""

    def _fetch_out(self, packed) -> dict:
        buf = np.asarray(packed)         # ONE device->host transfer
        specs = self._out_specs[buf.shape[1]]
        out = {}
        off = 0
        # transfer layout: int32 columns, then int16 halves, then int8 quads
        n16 = sum(w for *_, w, m in specs if m == "i16")
        n8 = sum(w for *_, w, m in specs if m == "i8")
        w32 = sum(w for *_, w, m in specs if m == "i32")
        if n16:
            words = buf[:, w32:w32 + (n16 + 1) // 2]
            lo = (words << 16) >> 16            # sign-extended low half
            hi = words >> 16
            halves = np.empty((buf.shape[0], 2 * words.shape[1]),
                              np.int32)
            halves[:, 0::2] = lo
            halves[:, 1::2] = hi
        if n8:
            q0 = w32 + (n16 + 1) // 2
            qw = buf[:, q0:q0 + (n8 + 3) // 4]
            quads = np.empty((buf.shape[0], 4 * qw.shape[1]), np.int32)
            quads[:, 0::4] = (qw << 24) >> 24   # sign-extended bytes
            quads[:, 1::4] = (qw << 16) >> 24
            quads[:, 2::4] = (qw << 8) >> 24
            quads[:, 3::4] = qw >> 24
        off16 = off8 = 0
        for k, dt, shape, w, mode in specs:
            if mode == "i32":
                v = np.ascontiguousarray(buf[:, off:off + w])
                off += w
            elif mode == "i8":
                v = np.ascontiguousarray(quads[:, off8:off8 + w])
                off8 += w
            else:
                v = np.ascontiguousarray(halves[:, off16:off16 + w])
                off16 += w
            v = v.reshape((buf.shape[0],) + shape)
            if dt == "float32":
                v = v.view(np.float32)
            elif dt == "bool":
                v = v != 0
            elif mode == "i16":
                # restore clamped invalid-score sentinels
                v = np.where(v == -32768, np.int32(-(2 ** 30)), v)
            out[k] = v
        if "sp_src" in out:
            out = self._unspill(out, self._spill_meta[buf.shape[1]])
        return out

    @staticmethod
    def _unspill(o, meta):
        """Reconstruct dense [2B, Mdev] u_* arrays from the spill D2H
        layout (2 dense head slots + S compacted spill rows)."""
        Mdev, spliced = meta
        src = o.pop("sp_src")                       # [S]
        spw = o.pop("sp_w")                         # [S, 4|5]
        spev = o.pop("sp_ev", None)
        if src.size and src[-1] == -2:
            raise SpillOverflow
        lanes2 = o["u_score"].shape[0]
        Msp = Mdev - 2
        sel = src >= 0
        s2 = src[sel]
        ln = s2 // Msp
        sl = 2 + s2 % Msp

        def full(head, fill, dec):
            a = np.full((lanes2, Mdev), fill, np.int32)
            a[:, :2] = head
            a[ln, sl] = dec
            return a

        w0, w1, w2, w3 = (spw[sel, i] for i in range(4))
        o["u_d1"] = full(o["u_d1"], 0, w0)
        o["u_score"] = full(o["u_score"], -(2 ** 30),
                            ((w1 & 0xFFFF) ^ 0x8000) - 0x8000)
        o["u_flags"] = full(o["u_flags"], 0, (w1 >> 16) & 0x7F)
        o["u_ab"] = full(o["u_ab"], 127, (w1 >> 24) & 0x7F)
        o["u_clip_l"] = full(o["u_clip_l"], 0, w2 & 0xFF)
        o["u_clip_r"] = full(o["u_clip_r"], 0, (w2 >> 8) & 0xFF)
        o["u_n_mm"] = full(o["u_n_mm"], 0, (w2 >> 16) & 0xFF)
        o["u_n_n"] = full(o["u_n_n"], 0, (w2 >> 24) & 0x7F)
        o["u_x"] = full(o["u_x"], 0, w3 & 0xFF)
        if spliced:
            o["u_d2"] = full(o["u_d2"], 0, spw[sel, 4])
        else:
            o["u_dd"] = full(o["u_dd"], 0,
                             (((w3 >> 8) & 0xFF) ^ 0x80) - 0x80)
        if spev is not None:
            o["u_event"] = full(o["u_event"], -1, spev[sel])
        return o

    def _eval_order_suppress(self, valid, score, junc_kind, lanes_meta,
                             lens, minsc, B, K):
        """Unpaired interleaved-search replay + sink best gating.

        Replays the reference's fw/rc round interleave (HI_Aligner::go)
        per read, drops candidates of lanes the reference never aligned,
        and suppresses candidates whose score is below the best reported
        by earlier-completing lanes (`minsc = max(minsc,
        sink.bestUnp1())`, spliced_aligner.h:635-637).  Returns (valid,
        best_before_lane [2B], orientation report ranks [B, 2]).

        Python replay runs only for reads where order can matter: both
        orientations carry candidates, a give-up gate could fire, or a
        lane completes with a false align() verdict."""
        v2 = valid.reshape(2 * B, K)
        sc2 = np.where(v2, score.reshape(2 * B, K), np.int64(-2 ** 40))
        lane_best = sc2.max(axis=1)                             # [2B]
        ms64 = np.asarray(minsc, np.int64)
        # vectorized round log: byte t of lane l = len*2 + uniq
        words = np.asarray(lanes_meta["h_rounds"])
        rn2b = np.asarray(lanes_meta["h_rn"]).astype(np.int64)
        bts = ((words[:, :, None] >> (np.arange(4) * 8)[None, None, :])
               & 0xFF).reshape(2 * B, -1)
        minw_cap = 2 * max(2 * self.k, 10)
        verdict2b = np.asarray(lanes_meta["h_alignable"]).astype(bool) \
            & (np.asarray(lanes_meta["h_minw"]) <= minw_cap)
        spl_l = (v2 & (junc_kind.reshape(2 * B, K)
                       == KIND_SPL)).any(axis=1)
        spl = (spl_l[:B] | spl_l[B:]).astype(np.int64)

        # ---- fully vectorized 2-lane interleave (replay_pair, unpaired
        # flow) across all reads: lanes are (fw, rc) of the same mate,
        # found[] = {last align() verdict, False}, so the FIRST lane that
        # completes with a false verdict ends the whole search
        R = bts.shape[1]
        rlen = (bts >> 1).astype(np.int64).reshape(2, B, R) \
            .transpose(1, 0, 2)                                # [B, 2, R]
        runiq = (bts & 1).astype(bool).reshape(2, B, R).transpose(1, 0, 2)
        rn = np.stack([rn2b[:B], rn2b[B:]], axis=1)            # [B, 2]
        verdict = np.stack([verdict2b[:B], verdict2b[B:]], axis=1)
        lbest = np.stack([lane_best[:B], lane_best[B:]], axis=1)
        idxmask = np.arange(R)[None, None, :] < rn[:, :, None]
        P2 = np.zeros((B, 2, R + 1), np.int64)
        P2[:, :, 1:] = np.cumsum(np.where(idxmask, rlen * rlen, 0), axis=2)
        mk2 = np.int64(self.min_k) ** 2
        mmmax = max(self.scoring.mm_max, 1)
        NEG = np.int64(-2 ** 62)
        INF = np.int64(2 ** 62 - 1)
        k = np.zeros((B, 2), np.int64)
        na = np.zeros((B, 2), np.int64)
        done = rn == 0                       # empty lanes never complete
        ended = np.zeros(B, bool)
        comp_rank = np.full((B, 2), -1, np.int64)
        order_ctr = np.zeros(B, np.int64)
        best_unp = np.full(B, np.int64(-2 ** 40))
        ar = np.arange(B)
        for _ in range(2 * R + 4):
            act = ~ended & ~done.all(axis=1)
            if not act.any():
                break
            cum = np.take_along_axis(P2, k[:, :, None], axis=2)[:, :, 0]
            pen = np.minimum(2 * na, 62)
            scl = np.where(k == 0, INF,
                           cum - na * mk2 - (np.int64(1) << pen))
            scl = np.where(done, NEG, scl)
            pick = np.argmax(scl, axis=1)            # ties -> fw (lane 0)
            pna = na[ar, pick]
            # budget gate (hi_aligner.h:3993-4027): unpaired -> search over
            maxmm = -(-np.maximum(-best_unp, 0) // mmmax)
            budget = act & (best_unp >= ms64[:B]) \
                & (pna > maxmm + spl + 1)
            # sibling gate (hi_aligner.h:4030-4036): search over
            sibna = na[ar, 1 - pick]
            sibdone = done[ar, 1 - pick]
            sib = act & ~budget & sibdone & (best_unp < ms64[:B]) \
                & (pna > sibna + 1)
            ended |= budget | sib
            consume = act & ~budget & ~sib
            kp = k[ar, pick]
            uq = runiq[ar, pick, np.minimum(kp, R - 1)]
            k[ar, pick] = np.where(consume, kp + 1, kp)
            na[ar, pick] = np.where(consume & ~uq, pna + 1, pna)
            complete = consume & (k[ar, pick] == rn[ar, pick])
            done[ar, pick] |= complete
            vd = verdict[ar, pick]
            newrank = complete & vd & (comp_rank[ar, pick] < 0)
            comp_rank[ar, pick] = np.where(newrank, order_ctr,
                                           comp_rank[ar, pick])
            order_ctr += newrank
            upd = complete & vd & (lbest[ar, pick] >= ms64[:B])
            best_unp = np.where(upd, np.maximum(best_unp,
                                                lbest[ar, pick]),
                                best_unp)
            # go() break: a false-verdict completion ends the search
            ended |= complete & ~vd

        completed = comp_rank >= 0                              # [B, 2]
        # sink best gate: lanes completing later report only candidates
        # that beat the best accepted by earlier lanes
        first = np.where(completed & (comp_rank == 0), lbest,
                         np.int64(-2 ** 40)).max(axis=1)
        first = np.where(first >= ms64[:B], first, np.int64(-2 ** 40))
        bb = np.where(comp_rank >= 1, first[:, None], np.int64(-2 ** 40))
        bb = np.where(completed, bb, np.int64(2 ** 40))        # drop all
        best_before = np.concatenate([bb[:, 0], bb[:, 1]])
        gate = np.maximum(best_before,
                          ms64[np.arange(2 * B) % B])
        v2 &= sc2 >= gate[:, None]
        ranks = np.where(comp_rank < 0, 2, comp_rank)
        return v2.reshape(-1), best_before, ranks

    def _host_phase(self, o_np: dict, codes: np.ndarray, quals: np.ndarray,
                    lens: np.ndarray, minsc: np.ndarray,
                    paired: bool = False) -> BatchResult:
        tick = section_timer("host_phase")
        B = codes.shape[0]
        # unpack the per-slot flags byte and the DNA-mode d2 delta (see
        # _align_device's D2H shrink)
        if "u_flags" in o_np:
            fl = o_np.pop("u_flags")
            cs = (fl >> 4) & 7
            o_np["u_valid"] = fl & 1
            o_np["u_post"] = (fl >> 1) & 1
            o_np["u_selfgap"] = (fl >> 2) & 1
            o_np["u_known"] = (fl >> 3) & 1
            o_np["u_kind"] = np.where(cs >= 4, np.int32(KIND_SPL),
                                      cs)
            o_np["u_spldir"] = np.where(cs >= 4, cs - 3, 0)
        if "u_dd" in o_np:
            o_np["u_d2"] = o_np["u_d1"] + o_np.pop("u_dd")
        U = o_np["u_score"].shape[1]    # unified slots (device-compacted)
        # composite columns: (2 two-junction + 1 three-junction) per
        # swept base pair (top-2 raw pairs)
        Q = 0
        qpfx = []
        for p2, p3 in (("q2_", "q3_"), ("r2_", "r3_")):
            if p2 + "score" in o_np:
                qpfx.append((p2, p3))
                Q += 3 if p3 + "score" in o_np else 2
        K = U + Q

        # int32 math throughout the host phase when positions fit (the
        # arrays are memory-bound; int64 doubles the traffic) — sharded
        # multi-gigabase genomes fall back to int64
        hdt = np.int64 if self.meta.n >= 2 ** 31 - 2 ** 24 else np.int32

        def flat(u, q=None):
            if not Q:
                # reshape of a C-contiguous [2B, U] int32 array is a VIEW
                return u.astype(hdt, copy=False).reshape(-1)
            blocks_ = [u.astype(hdt, copy=False),
                       (np.zeros((2 * B, Q)) if q is None
                        else q).astype(hdt, copy=False)]
            return np.concatenate(blocks_, axis=1).reshape(-1)

        q_j3x = q_j3d4 = q_j3kind = q_j3dir = None
        if Q:
            # per swept base pair: column 0 = right-extension composite
            # (junctions at bx then sweep x); column 1 = left-extension
            # (sweep x then bx); column 2 = the 3-junction combo
            # (left x, bx, right x)
            ones = np.ones(2 * B, np.int32)
            zeros = np.zeros(2 * B, np.int32)
            cs = {k: [] for k in ("start", "score", "j1x", "j1d2",
                                  "j1kind", "j1dir", "j1known", "j2x",
                                  "j2d3", "j2kind", "j2dir", "j3x",
                                  "j3d4", "j3kind", "j3dir")}
            for p2, p3 in qpfx:
                g = lambda k: o_np[p2 + k]  # noqa: E731
                cs["start"] += [g("bd1"), g("d")[:, 1]]
                cs["score"] += [g("score")[:, 0], g("score")[:, 1]]
                cs["j1x"] += [g("bx"), g("x")[:, 1]]
                cs["j1d2"] += [g("bd2"), g("bd1")]
                cs["j1kind"] += [g("bkind"), ones]
                cs["j1dir"] += [g("bdir"), g("dir")[:, 1]]
                cs["j1known"] += [g("bknown"), zeros]
                cs["j2x"] += [g("x")[:, 0], g("bx")]
                cs["j2d3"] += [g("d")[:, 0], g("bd2")]
                cs["j2kind"] += [ones, g("bkind")]
                cs["j2dir"] += [g("dir")[:, 0], g("bdir")]
                cs["j3x"] += [zeros, zeros]
                cs["j3d4"] += [zeros, zeros]
                cs["j3kind"] += [zeros, zeros]
                cs["j3dir"] += [zeros, zeros]
                if p3 + "score" in o_np:
                    g3 = lambda k: o_np[p3 + k]  # noqa: E731
                    cs["start"].append(g3("ld"))
                    cs["score"].append(g3("score"))
                    cs["j1x"].append(g3("lx"))
                    cs["j1d2"].append(g("bd1"))
                    cs["j1kind"].append(ones)
                    cs["j1dir"].append(g3("ldir"))
                    cs["j1known"].append(zeros)
                    cs["j2x"].append(g("bx"))
                    cs["j2d3"].append(g("bd2"))
                    cs["j2kind"].append(g("bkind"))
                    cs["j2dir"].append(g("bdir"))
                    cs["j3x"].append(g3("rx"))
                    cs["j3d4"].append(g3("rd"))
                    cs["j3kind"].append(ones)
                    cs["j3dir"].append(g3("rdir"))
            q_start = np.stack(cs["start"], 1)
            q_score = np.stack(cs["score"], 1).astype(np.int64)
            q_j1x = np.stack(cs["j1x"], 1)
            q_j1d2 = np.stack(cs["j1d2"], 1)
            q_j1kind = np.stack(cs["j1kind"], 1)
            q_j1dir = np.stack(cs["j1dir"], 1)
            q_j1known = np.stack(cs["j1known"], 1)
            q_j2x = np.stack(cs["j2x"], 1)
            q_j2d3 = np.stack(cs["j2d3"], 1)
            q_j2kind = np.stack(cs["j2kind"], 1)
            q_j2dir = np.stack(cs["j2dir"], 1)
            q_j3x = np.stack(cs["j3x"], 1)
            q_j3d4 = np.stack(cs["j3d4"], 1)
            q_j3kind = np.stack(cs["j3kind"], 1)
            q_j3dir = np.stack(cs["j3dir"], 1)
        else:
            q_start = q_score = q_j1x = q_j1d2 = q_j1kind = None
            q_j1dir = q_j1known = q_j2x = q_j2d3 = q_j2kind = q_j2dir = None

        starts = flat(o_np["u_d1"], q_start)
        score = flat(o_np["u_score"], q_score)
        n_mm = flat(o_np["u_n_mm"])
        n_n_dev = flat(o_np["u_n_n"])
        clip_l = flat(o_np["u_clip_l"])
        clip_r = flat(o_np["u_clip_r"])
        junc_kind = flat(o_np["u_kind"], q_j1kind)
        junc_x = flat(o_np["u_x"], q_j1x)
        d2 = flat(o_np["u_d2"], q_j1d2)
        spl_dir = flat(o_np["u_spldir"], q_j1dir)
        junc_known = flat(o_np["u_known"], q_j1known)
        junc_event = flat(o_np.get("u_event",
                                   np.full((2 * B, U), -1, np.int32)),
                          np.full((2 * B, Q), -1) if Q else None)
        junc2_kind = flat(np.zeros((2 * B, U)), q_j2kind)
        junc2_x = flat(np.zeros((2 * B, U)), q_j2x)
        junc2_d3 = flat(o_np["u_d2"], q_j2d3)
        junc2_dir = flat(np.zeros((2 * B, U)), q_j2dir)
        junc3_kind = flat(np.zeros((2 * B, U)), q_j3kind)
        junc3_x = flat(np.zeros((2 * B, U)), q_j3x)
        junc3_d4 = flat(o_np["u_d2"], q_j3d4)
        junc3_dir = flat(np.zeros((2 * B, U)), q_j3dir)
        # u_alt ships one value per LANE per shard (its best slot's
        # trimmed-rep score); scatter it back to the lane's globally best
        # slot (same argmax as the device ran per shard)
        NOALT = -(2 ** 30)
        us_b = np.where(o_np["u_valid"] > 0, o_np["u_score"], NOALT)
        bs_b = us_b.argmax(axis=1)
        lrange = np.arange(2 * B)
        ualt_full = np.full((2 * B, U), NOALT, o_np["u_alt"].dtype)
        ualt_full[lrange, bs_b] = o_np["u_alt"][
            lrange, bs_b // (U // o_np["u_alt"].shape[1])]
        alt_dev = flat(ualt_full,
                       np.full((2 * B, Q), -(2 ** 30)) if Q else None)
        # map indel-event table rows to VariantDB snp indices
        # u_event was mapped to GLOBAL VariantDB rows in _merge_shards
        junc_snp = junc_event.astype(np.int64)
        BIGV = 2 ** 29
        vparts = [o_np["u_valid"] > 0]
        if Q:
            vparts.append((q_score > -BIGV)
                          & (q_j1kind != KIND_NONE))
        valid = np.concatenate(vparts, axis=1).reshape(-1)

        lanes_meta = ({k: o_np[k] for k in
                       ("h_rounds", "h_rn", "h_minw", "h_alignable",
                        "h_stop")}
                      if "h_rounds" in o_np else None)
        if "h_sat" in o_np:
            lanes_meta = dict(lanes_meta or {}, h_sat=o_np["h_sat"])
        lane = np.repeat(np.arange(2 * B, dtype=np.int64), K)
        tick("unpack")
        # host-side policy filters (all vectorized)
        # vectorize per-length scoring bounds over the distinct lengths
        ulens, uinv = np.unique(lens, return_inverse=True)
        maxn = np.array([self.scoring.max_n(int(l)) for l in ulens],
                        np.int64)[uinv]
        read_of_lane = lane % B
        is_rc = lane >= B
        # pairs span the whole read: their N count is the read's N count
        inlen = np.arange(codes.shape[1])[None, :] < np.asarray(lens)[:, None]
        n_read = ((codes > 3) & inlen).sum(axis=1).astype(np.int64)
        n_n = np.where(junc_kind > 0, n_read[read_of_lane], n_n_dev)
        if self.tmo:
            # --tmo: every splice junction must be a known site
            # (hisat2.cpp tranMapOnly); second/third junctions come from
            # the novel sweep, so composites are dropped outright
            valid = valid & ~((junc_kind == KIND_SPL)
                              & (junc_known == 0))
            valid = valid & (junc2_kind != KIND_SPL) \
                & (junc3_kind != KIND_SPL)
        if self.require_xs:
            # --dta-cufflinks: spliced alignments need a classified
            # strand (XS) or a known site (hisat2.cpp dta-cufflinks)
            valid = valid & ~((junc_kind == KIND_SPL)
                              & (spl_dir == 0) & (junc_known == 0))
        if self.no_fw:
            valid = valid & is_rc
        if self.no_rc:
            valid = valid & ~is_rc
        # conflicting splice-strand evidence across one read's junctions
        # (hi_aligner.h:3644-3705): penConflictSplice, driver default
        # 1,000,000 (hisat2.cpp:483) — with the default this simply
        # drops multi-junction composites whose classified dirs disagree
        if self.scoring.pen_conflict_splice:
            dd = np.stack([
                np.where(junc_kind == KIND_SPL, spl_dir, 0),
                np.where(junc2_kind == KIND_SPL, junc2_dir, 0),
                np.where(junc3_kind == KIND_SPL, junc3_dir, 0)])
            fwish = ((dd == 1) | (dd == 3)).any(axis=0)
            rcish = ((dd == 2) | (dd == 4)).any(axis=0)
            score = np.where(
                fwish & rcish,
                score - np.int64(self.scoring.pen_conflict_splice), score)
        is_pair = junc_kind > 0
        valid = valid & (n_n <= maxn[read_of_lane]) \
            & (is_pair | (score >= minsc[read_of_lane]))
        # column compaction: all downstream work (containment, merge loops,
        # lexsorts) scales with K, but each lane rarely carries more than a
        # few valid candidates — keep the M best (valid-first, score desc)
        # slots per lane and drop the rest of the K columns
        ab = flat(o_np["u_ab"])
        post = flat(o_np["u_post"]).astype(bool)
        selfgap = flat(o_np["u_selfgap"]).astype(bool)
        tick("policy")
        M = max(10, self.msize + 2)
        if M < K:
            v2 = valid.reshape(2 * B, K)
            sc2 = np.where(v2, score.reshape(2 * B, K), np.int64(-2 ** 40))
            ordc = np.lexsort((-sc2, ~v2), axis=1)[:, :M]
            take = (np.arange(2 * B, dtype=np.int64)[:, None] * K
                    + ordc).reshape(-1)
            (valid, starts, score, n_mm, n_n, clip_l, clip_r, junc_kind,
             junc_x, d2, spl_dir, junc_known, junc_event, junc_snp,
             junc2_kind, junc2_x, junc2_d3, junc2_dir,
             junc3_kind, junc3_x, junc3_d4, junc3_dir, ab, post,
             selfgap, alt_dev) = (a[take] for a in (
                 valid, starts, score, n_mm, n_n, clip_l, clip_r, junc_kind,
                 junc_x, d2, spl_dir, junc_known, junc_event, junc_snp,
                 junc2_kind, junc2_x, junc2_d3, junc2_dir,
                 junc3_kind, junc3_x, junc3_d4, junc3_dir, ab, post,
                 selfgap, alt_dev))
            K = M
            lane = np.repeat(np.arange(2 * B, dtype=np.int64), K)
            read_of_lane = lane % B
            is_rc = lane >= B
            is_pair = junc_kind > 0
        tick("compact")
        # fragment containment (joinedToTextOff straddle check, gfm.h:5076);
        # junction candidates check each segment separately, and a splice may
        # cross an N-gap fragment boundary within the same reference.
        # COMPRESSED to the valid slots (typically a few % of the [2B, K]
        # grid; the full-size planes consumed downstream scatter back and
        # are don't-care at invalid slots).
        N = len(starts)
        vi = np.flatnonzero(valid)
        st_v, d2_v = starts[vi], d2[vi]
        jk_v, jx_v = junc_kind[vi], junc_x[vi]
        cl_v, cr_v = clip_l[vi], clip_r[vi]
        ip_v = jk_v > 0
        L_v = lens[read_of_lane[vi]].astype(hdt)
        insl_v = np.where(jk_v == KIND_INS, st_v - d2_v, 0)
        as_v = st_v + cl_v
        le_v = np.where(ip_v, st_v + jx_v,
                        as_v + L_v - cl_v - cr_v)           # exclusive
        rs_v = np.where(jk_v == KIND_INS, st_v + jx_v, d2_v + jx_v)
        j2k_v, j2x_v = junc2_kind[vi], junc2_x[vi]
        isq2_v = j2k_v > 0
        j3k_v, j3x_v = junc3_kind[vi], junc3_x[vi]
        isq3_v = j3k_v > 0
        span_r_v = np.where(isq2_v, j2x_v, L_v) - jx_v - insl_v
        nfr = len(self.frag_ref)
        fl = np.clip(np.searchsorted(self.frag_joined, as_v,
                                     "right") - 1, 0, nfr - 1)
        contained_l = (as_v >= self.frag_joined[fl]) & \
            (le_v <= self.frag_joined[fl + 1])
        fr = np.clip(np.searchsorted(self.frag_joined, rs_v, "right") - 1,
                     0, nfr - 1)
        contained_r = (rs_v >= self.frag_joined[fr]) & \
            (rs_v + span_r_v <= self.frag_joined[fr + 1])
        same_chr = self.frag_ref[fl] == self.frag_ref[fr]
        pair_ok = contained_l & contained_r & same_chr & \
            ((jk_v == KIND_SPL) | (fl == fr))
        ok_v = np.where(ip_v, pair_ok, contained_l)
        # reference-space skip length (an intron may span an N gap)
        rp_l_end = self.frag_off[fl] + (le_v - 1 - self.frag_joined[fl])
        rp_r = self.frag_off[fr] + (rs_v - self.frag_joined[fr])
        jl_v = np.where(
            jk_v == KIND_SPL, rp_r - rp_l_end - 1,
            np.where(jk_v == KIND_DEL, d2_v - st_v,
                     np.where(jk_v == KIND_INS, -(st_v - d2_v), 0)))
        ok_v &= ~((jk_v == KIND_SPL) & (jl_v < 1))
        # second junction (always a splice): third segment containment +
        # reference-space intron length
        j2l_v = np.zeros(len(vi), np.int64)
        j3l_v = np.zeros(len(vi), np.int64)
        if Q:
            rs3 = junc2_d3[vi] + j2x_v
            span3 = np.where(isq3_v, j3x_v, L_v) - j2x_v
            f3 = np.clip(np.searchsorted(self.frag_joined, rs3,
                                         "right") - 1, 0, nfr - 1)
            contained_3 = (rs3 >= self.frag_joined[f3]) & \
                (rs3 + span3 <= self.frag_joined[f3 + 1])
            seg2_end = rs_v + span_r_v      # exclusive, on the d2 diagonal
            rp_2end = self.frag_off[fr] + (seg2_end - 1
                                           - self.frag_joined[fr])
            rp_3 = self.frag_off[f3] + (rs3 - self.frag_joined[f3])
            j2l_v = np.where(isq2_v, rp_3 - rp_2end - 1, 0)
            ok_v &= ~isq2_v | (contained_3
                               & (self.frag_ref[f3] == self.frag_ref[fr])
                               & (j2l_v >= 1))
            # fourth segment (3-junction composites): containment +
            # reference-space intron length of the third junction
            rs4 = junc3_d4[vi] + j3x_v
            span4 = L_v - j3x_v
            f4 = np.clip(np.searchsorted(self.frag_joined, rs4,
                                         "right") - 1, 0, nfr - 1)
            contained_4 = (rs4 >= self.frag_joined[f4]) & \
                (rs4 + span4 <= self.frag_joined[f4 + 1])
            seg3_end = rs3 + span3
            rp_3end = self.frag_off[f3] + (seg3_end - 1
                                           - self.frag_joined[f3])
            rp_4 = self.frag_off[f4] + (rs4 - self.frag_joined[f4])
            j3l_v = np.where(isq3_v, rp_4 - rp_3end - 1, 0)
            ok_v &= ~isq3_v | (contained_4
                               & (self.frag_ref[f4] == self.frag_ref[f3])
                               & (j3l_v >= 1))
        valid = np.zeros(N, bool)
        valid[vi[ok_v]] = True
        ins_len = np.zeros(N, hdt)
        ins_len[vi] = insl_v
        junc_len = np.zeros(N, hdt)
        junc_len[vi] = jl_v
        junc2_len = np.zeros(N, hdt)
        junc2_len[vi] = j2l_v
        junc3_len = np.zeros(N, hdt)
        junc3_len[vi] = j3l_v
        L_of = lens[read_of_lane].astype(hdt, copy=False)

        tick("contain")
        # search-budget replay (nextBWT give-up, hi_aligner.h:3988-4035):
        # once an alignment scoring `best` exists, the reference performs at
        # most maxmm(best) + #splices(best) + 1 further non-unique search
        # rounds per orientation; candidates born in later rounds are never
        # generated.  `ab` = non-unique rounds before a candidate's earliest
        # source segment.
        selfgap_shadow = np.full(B, -2 ** 40, np.int64)
        vsel = np.flatnonzero(valid)
        if vsel.size:
            r_v = read_of_lane[vsel]
            sc_v = score[vsel]
            bestr = np.full(B, -2 ** 40, np.int64)
            np.maximum.at(bestr, r_v, sc_v)
            isb_v = sc_v == bestr[r_v]
            best_spl = np.zeros(B, bool)
            best_spl[r_v[(junc_kind[vsel] == KIND_SPL)
                         & isb_v]] = True
            maxmm = -(-np.maximum(-bestr, 0) // max(self.scoring.mm_max, 1))
            allowed = maxmm + best_spl + 1
            keep_v = (ab[vsel] <= allowed[r_v]) | isb_v
            # single-anchor gap joins survive only at the read's best
            # score: the reference's best-first local search never pursues
            # a strictly-worse gap once a better alignment exists (verified
            # vs oracle: an equal-score remote 32M1D68M IS reported, a
            # worse-by-2 remote 86M1I13M is not and never feeds ZS)
            sg_sup = selfgap[vsel] & (sc_v < bestr[r_v])
            keep_v &= ~sg_sup
            # ...but a worse gap join that is a representation of the BEST
            # placement's own region (diagonals differ by at most the gap
            # length) IS evaluated by the reference — extending that anchor
            # produces both forms — and its score feeds secbest/ZS without
            # ever being reported (oracle: 92M8S AS:-16 ZS:-17 where -17
            # is the suppressed 92M4D8M of the same locus; a gap at any
            # OTHER region never feeds ZS — the best-first search never
            # pursues it)
            # ...gated by the reference's local-search flank floors (the
            # gap must be reachable: head flank >= minAnchorLen, or for a
            # TAIL flank >= 8 read chars (del) / >= 9 genome chars (ins)
            # — oracle probe: a 6-char del tail or a 4bp-ins-in-6 tail is
            # never evaluated, so it must not feed ZS either)
            sup_i = np.flatnonzero(sg_sup & (sc_v >= minsc[r_v]))
            for j in sup_i:
                rj = r_v[j]
                cj = vsel[j]
                Lr = int(lens[rj])
                x = int(junc_x[cj])
                gl = int(junc_len[cj])
                if x <= Lr - x:           # head-side flank
                    if x < 7:
                        continue
                elif junc_kind[cj] == KIND_INS:
                    if Lr - x - max(-gl, 0) < 9:
                        continue
                elif Lr - x < 8:          # tail-side del
                    continue
                # the gap is only pursued off a CLIPPED best (an ungapped
                # extension with an unexplained tail); a clean best ends
                # the region's evaluation before any gap
                near_best = isb_v & (r_v == rj) \
                    & ((clip_l[vsel] + clip_r[vsel]) > 0) & (
                    np.abs(starts[vsel] - starts[vsel[j]]) <= 64)
                if near_best.any():
                    selfgap_shadow[rj] = max(selfgap_shadow[rj],
                                             int(sc_v[j]))
            # post-anchor-stop candidates exist only when the pre-stop
            # anchor's extension leaves part of the read uncovered
            # (hybridSearch re-search); a full-coverage candidate in the
            # same lane means the reference never searched further
            full0 = np.zeros(2 * B, bool)
            l_v = lane[vsel]
            full0[l_v[keep_v & ~post[vsel]
                      & (clip_l[vsel] + clip_r[vsel] == 0)]] = True
            keep_v &= ~(post[vsel] & full0[l_v])
            valid = np.zeros(N, bool)
            valid[vsel[keep_v]] = True

        tick("budget")
        # candidate-region merge (getAnchorHits `overlapped`, hi_aligner.h:
        # 4408-4419): a coordinate within maxIntronLen of a STRICTLY better
        # candidate merges into it (equal-score multimaps all survive -
        # verified vs oracle on an 800 bp-apart duplicated unit)
        W = self.scoring.max_intron_len
        Km0 = K
        validm0 = valid.reshape(2 * B, Km0)
        # only lanes with >= 2 surviving candidates can merge anything —
        # run the column scan on that (few-%) row subset only
        multi0 = np.flatnonzero(validm0.sum(axis=1) >= 2)
        if multi0.size:
            v_m = validm0[multi0]
            s_m0 = starts.reshape(2 * B, Km0)[multi0]
            sc_m0 = np.where(v_m, score.reshape(2 * B, Km0)[multi0],
                             np.int64(-2 ** 40))
            jk_m0 = junc_kind.reshape(2 * B, Km0)[multi0]
            ordm0 = np.lexsort((-jk_m0, s_m0, -sc_m0), axis=1)
            s_s0 = np.take_along_axis(s_m0, ordm0, axis=1)
            v_s0 = np.take_along_axis(v_m, ordm0, axis=1)
            sc_s0 = np.take_along_axis(sc_m0, ordm0, axis=1)
            R0 = multi0.size
            jk_s0 = np.take_along_axis(jk_m0, ordm0, axis=1)
            cl_s0 = np.take_along_axis(
                (clip_l + clip_r).astype(np.int64).reshape(
                    2 * B, Km0)[multi0], ordm0, axis=1)
            kept0 = np.zeros((R0, Km0), bool)
            kept_pos0 = np.full((R0, Km0), -2 ** 60, np.int64)
            kept_sc0 = np.full((R0, Km0), -2 ** 40, np.int64)
            kept_gap0 = np.zeros((R0, Km0), bool)
            minsc_m0 = minsc[multi0 % B]
            for r in range(Km0):
                # rows are sorted valid-(score desc)-first: the first column
                # with no valid entry anywhere ends the scan
                if not v_s0[:, r].any():
                    break
                cand = s_s0[:, r]
                csc = sc_s0[:, r]
                dk = np.abs(kept_pos0 - cand[:, None])
                better = kept_sc0 > csc[:, None]
                near = ((dk <= W) & better).any(axis=1)
                keep_r = v_s0[:, r] & ~near
                kept0[:, r] = keep_r
                # a merged-away representation of the SAME region (the
                # reference's ungapped anchor extension vs its gap join;
                # diagonals differ by at most the gap length) was still
                # EVALUATED by the reference: its score feeds secbest/ZS
                # (oracle: 90M2I8M AS:-11 ZS:-18, -18 = the merged clip
                # form); remote merged candidates never feed ZS
                # ...ungapped forms only: a merged gapped/spliced variant
                # (e.g. the novel-penalized twin of a known-injected
                # junction) is the SAME evaluation in the reference, not a
                # second one.  The clip form fires only with a clip of
                # trimMax-1..trimMax (= 9..10 at defaults) — oracle probe:
                # gap-best with clip form 8 or >= 11 shows no ZS, 9-10 do
                # (the trim5/trim3 re-report branch is what surfaces it)
                tmax0 = np.maximum(-minsc_m0, 0) \
                    // max(self.scoring.mm_min, 1)
                sup_r = v_s0[:, r] & near & (csc >= minsc_m0) \
                    & (jk_s0[:, r] == 0) \
                    & (cl_s0[:, r] >= tmax0 - 1) & (cl_s0[:, r] <= tmax0) \
                    & ((dk <= 64) & better & kept_gap0).any(axis=1)
                if sup_r.any():
                    np.maximum.at(selfgap_shadow, multi0[sup_r] % B,
                                  csc[sup_r])
                kept_pos0[:, r] = np.where(keep_r, cand, np.int64(-2 ** 60))
                kept_sc0[:, r] = np.where(keep_r, csc, np.int64(-2 ** 40))
                # DEL/INS bests only: a SPLICED best's clip form is never
                # re-reported (oracle: 90M200N10M AS:0 carries no ZS)
                kept_gap0[:, r] = keep_r & (
                    (jk_s0[:, r] == KIND_DEL)
                    | (jk_s0[:, r] == KIND_INS))
            vm0 = np.zeros((R0, Km0), bool)
            np.put_along_axis(vm0, ordm0, kept0, axis=1)
            validm0[multi0] &= vm0          # writes through into `valid`

        tick("regionmerge")
        # evaluation-order suppression (sink best gating): every combined
        # representation is reported only if its score beats the mate's
        # best-so-far (`minsc = max(minsc, sink.bestUnp1())`,
        # spliced_aligner.h:635-637 et al.) — a lane whose search completes
        # AFTER a better lane reports NOTHING below that best, and its
        # candidates never feed ZS/NH.  Completion order comes from the
        # interleaved-search replay (align/replay.py).
        best_before = np.full(2 * B, np.int64(-2 ** 40))
        orient_ranks = None
        if not paired and lanes_meta is not None \
                and "h_rounds" in lanes_meta:
            # the interleave replay runs for GRAPH indexes too: the
            # linear-FM round structure it replays is the same (variants
            # are handled in extension, not search), and enabling it
            # closed 29 graph-fuzz divergences (102 -> 73)
            valid, best_before, orient_ranks = self._eval_order_suppress(
                valid, score, junc_kind, lanes_meta, lens, minsc, B, K)

        tick("evalorder")
        # redundancy rule (HI_Aligner::redundant): a candidate whose
        # leftmost aligned position falls WITHIN the reference extent of an
        # already-reported alignment of the same mate (either orientation)
        # is never reported.  Processing order approximates the reference's
        # best-first reporting: score desc, junction forms first on ties
        # (the spliced extension of an anchor wins over an equal-scoring
        # ungapped placement it contains), then position.
        Km = K
        K2 = 2 * Km
        validm = valid.reshape(2 * B, Km)
        # fold fw/rc lanes of the same mate together (redundant() scans all
        # reported alignments of the mate regardless of orientation); only
        # reads with >= 2 surviving candidates can suppress anything — the
        # column scan runs on that (few-%) row subset only
        vread = np.concatenate([validm[:B], validm[B:]], axis=1)  # [B, 2Km]
        shadow_sec = selfgap_shadow.copy()
        rsel = np.flatnonzero(vread.sum(axis=1) >= 2)
        if rsel.size:
            rsel2 = np.concatenate([rsel, rsel + B])   # both lanes
            ext_start = ((starts + clip_l)
                         .reshape(2 * B, Km)[rsel2])   # [2R, Km]
            span_m = ((L_of - clip_l - clip_r
                       - np.where(is_pair, ins_len, 0)
                       + np.where(junc_kind > 0, junc_len, 0)
                       + junc2_len + junc3_len).reshape(2 * B, Km)[rsel2])
            R = rsel.size
            vsub = vread[rsel]
            s_r = np.concatenate([ext_start[:R], ext_start[R:]], axis=1)
            e_r = s_r + np.concatenate([span_m[:R], span_m[R:]],
                                       axis=1) - 1
            scm = score.reshape(2 * B, Km)[rsel2]
            sc_r = np.where(vsub, np.concatenate([scm[:R], scm[R:]],
                                                 axis=1),
                            np.int64(-2 ** 40))
            jkm = junc_kind.reshape(2 * B, Km)[rsel2]
            jk_r = np.concatenate([jkm[:R], jkm[R:]], axis=1)
            jxm = junc_x.reshape(2 * B, Km)[rsel2]
            jx_r = np.concatenate([jxm[:R], jxm[R:]], axis=1)
            # known-site junction forms outrank novel ones at equal
            # (score, start): the reference's combineWith tries known
            # sites first and keeps the first perfect form, so an
            # equal-scoring novel placement must not shadow the known
            # one (observed: a known len-127 intron vs a chance novel
            # len-138 form, both score 0)
            knm = junc_known.reshape(2 * B, Km)[rsel2]
            kn_r = np.concatenate([knm[:R], knm[R:]], axis=1)
            # forgiven catalog-indel representations rank BELOW plain
            # forms at equal (score, start): the reference's extension
            # walk engages ALT indels only at raw mismatches, so an
            # equal-scoring 96M1I3M twin of a plain 100M (fz933/jf66
            # class: the injected event does not absorb a mismatch) is
            # never generated there — the plain form must be kept and
            # the indel twin treated as a duplicate (no ZS; the sink's
            # same-coord record is the plain one)
            evm = junc_snp.reshape(2 * B, Km)[rsel2]
            ev_r = np.concatenate([evm[:R], evm[R:]], axis=1)
            forg_ind = ((jk_r == KIND_DEL)
                        | (jk_r == KIND_INS)) & (ev_r >= 0)
            ordm = np.lexsort((-jk_r, -kn_r, forg_ind, s_r, -sc_r),
                              axis=1)
            s_s = np.take_along_axis(s_r, ordm, axis=1)
            e_s = np.take_along_axis(e_r, ordm, axis=1)
            v_s = np.take_along_axis(vsub, ordm, axis=1)
            crm = (clip_l + clip_r).reshape(2 * B, Km)[rsel2]
            full_r = np.concatenate([crm[:R], crm[R:]], axis=1) == 0
            full_s = np.take_along_axis(full_r, ordm, axis=1)
            sc_s = np.take_along_axis(sc_r, ordm, axis=1)
            jx_s = np.take_along_axis(jx_r, ordm, axis=1)
            fi_s = np.take_along_axis(forg_ind, ordm, axis=1)
            kept = np.zeros((R, K2), bool)
            kept_s = np.full((R, K2), -2 ** 60, np.int64)
            kept_e = np.full((R, K2), -2 ** 60, np.int64)
            kept_jx = np.full((R, K2), -1, np.int64)
            # redundancy-suppressed candidates still count as secondary-best
            # evidence (the reference's sink saw them; they feed ZS but
            # neither NH nor MAPQ - observed: spliced primary with ZS:i:0
            # from its contained equal-scoring ungapped representation)
            shadow_sub = np.full(R, -2 ** 40, np.int64)
            for r in range(K2):
                if not v_s[:, r].any():
                    break
                cand = s_s[:, r]
                inside = ((cand[:, None] >= kept_s)
                          & (cand[:, None] <= kept_e)).any(axis=1)
                keep_r = v_s[:, r] & ~inside
                kept[:, r] = keep_r
                kept_s[:, r] = np.where(keep_r, cand, np.int64(-2 ** 60))
                kept_e[:, r] = np.where(keep_r, e_s[:, r],
                                        np.int64(-2 ** 60))
                kept_jx[:, r] = np.where(keep_r, jx_s[:, r], -1)
                # an exact same-start suppression with the SAME junction
                # shape is a duplicate representation of the kept
                # alignment, not secondary evidence; a same-start form
                # with a DIFFERENT junction (e.g. a shifted motif-less
                # splice point from a neighboring temp site) is a
                # distinct alignment the reference reports, so its score
                # still feeds ZS
                same_start = ((cand[:, None] == kept_s)
                              & (jx_s[:, r][:, None] == kept_jx)) \
                    .any(axis=1)
                # a forgiven-indel twin at the SAME start as any kept
                # form is a duplicate representation (fz933 class: the
                # oracle's sink holds only the plain same-coord record,
                # ZS comes from the true second-best placement)
                same_start |= (fi_s[:, r]
                               & (cand[:, None] == kept_s).any(axis=1))
                supp = v_s[:, r] & inside & full_s[:, r] & ~same_start
                shadow_sub = np.where(
                    supp, np.maximum(shadow_sub, sc_s[:, r]), shadow_sub)
            vr = np.zeros((R, K2), bool)
            np.put_along_axis(vr, ordm, kept, axis=1)
            validm[rsel] &= vr[:, :Km]      # writes through into `valid`
            validm[rsel + B] &= vr[:, Km:]
            shadow_sec[rsel] = shadow_sub

        tick("redundancy")
        lane_best = np.full(2 * B, -2 ** 40, np.int64)
        sel = np.flatnonzero(valid)
        if sel.size:
            np.maximum.at(lane_best, lane[sel], score[sel])
        if lanes_meta is not None:
            lanes_meta["best"] = lane_best
        if not sel.size:
            return BatchResult(n_reads=B, lanes=lanes_meta,
                               orient_ranks=orient_ranks)
        # dedup identical (read, orient, start, junction), keeping the BEST
        # score per placement (a known splice site and the novel sweep can
        # produce the same junction; the known, unpenalized one must win)
        r = read_of_lane[sel]
        o = is_rc[sel].astype(np.int64)
        s = starts[sel].astype(np.int64)
        key = ((((((r * 2 + o) << 33) + s) << 2) + junc_kind[sel]) << 7) \
            + junc_x[sel]
        kd2 = (junc_len[sel] * 256 + junc2_x[sel] % 256) * 128 \
            + junc3_x[sel] % 128
        perm = np.lexsort((-score[sel], kd2, key))
        kk, kk2 = key[perm], kd2[perm]
        firstmask = np.ones(len(perm), bool)
        firstmask[1:] = (kk[1:] != kk[:-1]) | (kk2[1:] != kk2[:-1])
        idx = sel[perm[firstmask]]
        r, o = read_of_lane[idx], is_rc[idx].astype(np.int64)
        s = starts[idx].astype(np.int64)
        sc = score[idx].astype(np.int64)
        # deterministic selection order: per read, score desc then position,
        # ungapped before junction candidates at equal (score, position)
        order = np.lexsort((junc_x[idx], -junc_known[idx],
                            junc_kind[idx], o, s, -sc, r))
        idx, r, o, s, sc = idx[order], r[order], o[order], s[order], sc[order]
        # per-read segments
        bnd = np.flatnonzero(np.diff(r, prepend=-1))
        seg_len = np.diff(np.append(bnd, len(r)))
        seg_of = np.repeat(np.arange(len(bnd)), seg_len)
        pos_in_seg = np.arange(len(r)) - bnd[seg_of]
        # per-segment summary -> MAPQ (vectorized BowtieMapq2).  The secbest
        # considers BOTH the second distinct placement and the best
        # alternate representation of the best placement (trimmed variants
        # the reference also counts into AlnSetSumm — hence ZS with NH:i:1)
        seg_read = r[bnd]
        best = sc[bnd]
        # trimmed-representation ZS: the reference's trim5/trim3 branches
        # (spliced_aligner.h:1065-1105) REPORT a soft-clipped copy of the
        # anchor when the clip needed to shed the outermost penalized
        # column is within trimMax = -minsc / mm_min of the lane end
        # (probe-verified against the oracle: at defaults a 5' clip fires
        # for <= 10, a 3' clip for <= 9, independent of orientation and
        # window content).  The trimmed copy enters the report buffer and
        # becomes ZS, but the selected best's MAPQ ignores it.
        tick("dedup")
        gb = idx[bnd]
        alt_of_best = np.full(len(bnd), -2 ** 40, np.int64)
        # trimmed-representation scores come precomputed from the device
        # (extend_grouped alt_score: T-gated trim-through-first/last
        # penalized column, the probe-verified zsalt formula) — the host
        # only applies the minsc and sink-best gates, on eligible segments
        # (full ungapped best alignments with >= 1 penalized column)
        # ungapped bests with any penalized or clipped column are
        # eligible; the device alt already excludes the selected form
        # itself (ops/extend.py anchor-form model), so clipped bests
        # can carry a losing both-clips form (oracle: mm@{8,99} primary
        # 99M1S with ZS:-20)
        el = np.flatnonzero((junc_kind[gb] == 0)
                            & (((n_mm[gb] + n_n[gb]) > 0)
                               | (clip_l[gb] > 0) | (clip_r[gb] > 0)))
        if el.size:
            ge = gb[el]
            rde = seg_read[el]
            alt = alt_dev[ge].astype(np.int64)
            alt = np.where(alt >= minsc[rde], alt, np.int64(-2 ** 40))
            # a trimmed representation is reported during its candidate's
            # own processing, but still sits behind the sink best gate of
            # earlier-completing lanes
            alt = np.where(alt >= best_before[lane[ge]], alt,
                           np.int64(-2 ** 40))
            alt_of_best[el] = alt
        # spliced trimmed-representation ZS: for a single-junction best
        # with raw mismatch(es) in a terminal flank, the reference's
        # recursion REPORTS the intermediate soft-clipped form before the
        # 1-mm-per-level direct extension completes the alignment
        # (spliced_aligner.h:1065-1105 trim branch, then :1770-1830) —
        # each such intermediate scores best + pen(trimmed mms) -
        # clip(k) and feeds secbest/ZS (oracle-verified closed form on
        # the RNA fuzz: ZS = AS + 6 - 2k at q40 for every flank mm)
        # (the raw n_mm column is 0 for spliced candidates — flank
        # mismatches are only recovered at render time — so eligibility
        # is by score and the mismatch scan below decides)
        # the stage-walk caps below (r_cap 9/5/0, left 10, mkl=8) were
        # oracle-fitted AT DEFAULT SCORING (--mp 6,2 --sp 2,1
        # --score-min L,0,-0.2); under other penalty settings the
        # trimmed-intermediate geometry changes and the zs_cand > best_e
        # branch could silently rewrite the primary — gate the whole
        # model to default scoring and fall back to no-ZS otherwise
        sc_def = self.scoring
        default_scoring = (
            sc_def.mm_max == 6 and sc_def.mm_min == 2
            and sc_def.sp_max == 2 and sc_def.sp_min == 1
            and not sc_def.no_softclip
            and sc_def.score_min == SimpleFunc("L", 0.0, -0.2))
        elj = np.flatnonzero((junc_kind[gb] == 1)
                             & (junc2_kind[gb] == 0)
                             & (clip_l[gb] == 0) & (clip_r[gb] == 0)
                             & (best < 0)) if default_scoring else \
            np.empty(0, np.int64)
        if elj.size:
            mmtab = self.scoring.mm_pen_table()
            cliptab = self.scoring.clip_pen_table()
            ref = self.ref_codes
            snv_pos = snv_alt = None
            if self.variants is not None and \
                    len(getattr(self.variants, "snp_pos", ())):
                kind = np.asarray(self.variants.snp_kind)
                sgl = np.flatnonzero(kind == 0)
                jo = np.asarray(self.variants.snp_joined)[sgl]
                so_v = np.argsort(jo, kind="stable")
                snv_pos = jo[so_v].astype(np.int64)
                snv_alt = np.asarray(
                    self.variants.snp_seq)[sgl][so_v].astype(np.int64)

            def forgiven(jpos, rdc):
                if snv_pos is None:
                    return False
                i = int(np.searchsorted(snv_pos, jpos, side="left"))
                while i < len(snv_pos) and snv_pos[i] == jpos:
                    if snv_alt[i] == rdc:
                        return True
                    i += 1
                return False

            for e in elj:
                g = int(gb[e])
                rd = int(seg_read[e])
                L = int(lens[rd])
                rc_f = bool(o[bnd[e]])
                seq_or = codes[rd, :L].astype(np.int64)
                qual_or = quals[rd, :L].astype(np.int64)
                if rc_f:
                    seq_or = np.where(seq_or < 4, 3 - seq_or,
                                      seq_or)[::-1]
                    qual_or = qual_or[::-1]
                # batch quals are PHRED (io.fasta decode_quals)
                ph = np.clip(qual_or, 0, 40)
                s0 = int(s[bnd[e]])
                jx = int(junc_x[g])
                jl = int(junc_len[g])
                if jx <= 0 or jx >= L or jl <= 0 \
                        or s0 + jl + L > len(ref):
                    continue
                exp = np.empty(L, np.int64)
                exp[:jx] = ref[s0:s0 + jx]
                exp[jx:] = ref[s0 + jx + jl:s0 + jl + L]
                diff = np.flatnonzero((exp != seq_or) & (seq_or < 4)
                                      & (exp < 4))
                raw_mm = [int(p) for p in diff
                          if not forgiven(s0 + p + (jl if p >= jx
                                                    else 0),
                                          int(seq_or[p]))]
                if not raw_mm:
                    continue
                best_e = int(best[e])
                gate = max(int(minsc[rd]), int(best_before[lane[g]]))
                pen = {p: int(mmtab[ph[p]]) for p in raw_mm}
                zs_cand = -2 ** 40
                win = None                   # (side, k) of best trim
                # trimMax = (stage - gate) // sc(0), sc(0) = sp_min
                # flank-length caps (oracle-fitted on the RNA fuzz,
                # consistent with the round-2 ungapped probe bounds
                # 5' <= 10 / 3' <= 9): whether the trimmed intermediate
                # completes its own junction re-combine depends on the
                # motif class — right flanks complete for canonical
                # k <= 9, semi-canonical k <= 5, never for motif-less;
                # left flanks for k <= 10 regardless of motif
                sdir = int(spl_dir[g])
                r_cap = 9 if sdir in (1, 2) else (
                    5 if sdir in (3, 4) else 0)
                sp_min = int(cliptab[0])
                # stage walk, innermost flank mm outward: at stage t the
                # recursion is stuck at mm p_t and reports the trim; it
                # advances past p_t only when the direct extension gate
                # holds — rext = gap to the next stop >= min(minK_local,
                # remaining) (spliced_aligner.h:1801: rightext >=
                # min(_minK_local, rdlen - len - rdoff))
                mkl = 8
                # trims may not consume a whole exon segment
                right = sorted(p for p in raw_mm if p > jx)
                for t, p in enumerate(right):
                    k = L - p
                    stage = best_e + sum(pen[q2] for q2 in right[t:])
                    clip = int(cliptab[ph[p:]].sum())
                    cand = stage - clip
                    if k <= r_cap and k < (stage - gate) // sp_min \
                            and cand >= int(minsc[rd]) and cand > zs_cand:
                        zs_cand, win = cand, ("r", k)
                    nxt = right[t + 1] if t + 1 < len(right) else L
                    if nxt - p < min(mkl, k):
                        break          # direct-ext gate fails: no deeper
                left_f = sorted((p for p in raw_mm if p < jx - 1),
                                reverse=True)
                for t, p in enumerate(left_f):
                    k = p + 1
                    stage = best_e + sum(pen[q2] for q2 in left_f[t:])
                    clip = int(cliptab[ph[:p + 1]].sum())
                    cand = stage - clip
                    if k <= 10 and k < (stage - gate) // sp_min and \
                            cand >= int(minsc[rd]) and cand > zs_cand:
                        zs_cand, win = cand, ("l", k)
                    nxt = left_f[t + 1] if t + 1 < len(left_f) else -1
                    if p - nxt < min(mkl, k):
                        break
                if win is None:
                    continue
                if zs_cand > best_e:
                    # the trimmed form outranks the full one: the
                    # reference reports the trim FIRST, then the direct
                    # extension's full form fails the sink-best gate and
                    # is never reported — so the soft-clipped variant IS
                    # the alignment, with no ZS (oracle rf182 shape)
                    if win[0] == "r":
                        clip_r[g] = win[1]
                    else:
                        clip_l[g] = win[1]
                    sc[bnd[e]] = zs_cand
                    best[e] = zs_cand
                elif zs_cand > alt_of_best[e]:
                    alt_of_best[e] = zs_cand
        tick("zsalt")
        alt_valid = alt_of_best >= minsc[seg_read]
        sec_cand = np.where(seg_len > 1,
                            sc[np.minimum(bnd + 1, len(r) - 1)],
                            np.int64(-2 ** 40))
        # ZS counts trimmed representations of the best placement too;
        # MAPQ's secbest counts only DISTINCT placements (the reference
        # reports ZS yet MAPQ 60 when the only secbest is a trimmed variant)
        secbest = np.maximum(sec_cand, np.where(alt_valid, alt_of_best,
                                                np.int64(-2 ** 40)))
        shadow = shadow_sec[seg_read]
        secbest = np.maximum(secbest, shadow)
        has_sec = (seg_len > 1) | alt_valid | (shadow > -2 ** 39)
        perfect = np.array([self.scoring.perfect_score(int(l))
                            for l in ulens], np.int64)[uinv[seg_read]]
        mq = mapq_mod.mapq_selected(best, np.maximum(sec_cand, -2 ** 30),
                              seg_len > 1, perfect, minsc[seg_read])
        seg_zs = np.where(has_sec, secbest, 0)
        n_rep = np.minimum(seg_len, self.k)
        # the report pool keeps ALL selectable placements (the RNG
        # tie-break shuffles the full streak before truncating to k,
        # selectByScore aln_sink.h:2504) — truncation to k happens in
        # finalize_unpaired
        keep = pos_in_seg < np.minimum(seg_len, self.msize)[seg_of]
        # fragment mapping for kept candidates
        ki = np.flatnonzero(keep)
        gi = idx[ki]
        astart = (s[ki] + clip_l[gi]).astype(np.int64)
        fi = np.searchsorted(self.frag_joined, astart, "right") - 1
        ref_id = self.frag_ref[fi]
        ref_pos = self.frag_off[fi] + (astart - self.frag_joined[fi])
        rd_len = lens[r[ki]]
        # array-native result (RAW_COLS order); Alignment objects
        # materialize lazily only for object-path consumers
        so = seg_of[ki]
        cols = [r[ki], o[ki], ref_id, ref_pos, s[ki],
                clip_l[gi], clip_r[gi],
                (rd_len.astype(np.int64) - clip_l[gi] - clip_r[gi]
                 + junc_len[gi] + junc2_len[gi] + junc3_len[gi]),
                sc[ki], n_mm[gi], n_n[gi], mq[so], n_rep[so],
                pos_in_seg[ki] > 0, has_sec[so], seg_zs[so],
                junc_kind[gi], junc_x[gi], junc_len[gi], d2[gi],
                spl_dir[gi], junc_known[gi], junc_snp[gi],
                junc2_kind[gi], junc2_x[gi], junc2_len[gi],
                junc2_d3[gi], junc2_dir[gi],
                junc3_kind[gi], junc3_x[gi], junc3_len[gi],
                junc3_d4[gi], junc3_dir[gi]]
        tick("finish")
        tick(None)
        return BatchResult(n_reads=B, orient_ranks=orient_ranks,
                           lanes=lanes_meta, raw={"cols": cols})
