"""The batched aligner on torch (counterpart of
hisat2_tpu/align/pipeline.py TPUAligner: unpaired and paired reads, DNA
and spliced RNA, against linear, --ss and SNP graph indexes, with mate
rescue; full-SA, sampled-SA and sharded genome-scale indexes, with one
device per shard by shard_devices).

Device half: `_align_device` is TPUAligner._align_device (:725-1446) and
`_pack_out` the output packing of _align_device_packed (:536-600).  The
chain per batch of B reads (2B lanes, fw + rc), every step a hand kernel
on the card:

  partial_search2          kernel 1  (ops/search.py)
  prefix re-search         K17, kernel 1's lane-list mode (spliced only,
                                     ops/search.py:search_lanes_live)
  resolve walk             K19+K20   (ops/resolve.py:resolve_rows_sparse),
                                     sampled-SA index only: the live rows
                                     of the hits (and of the re-search)
  resolve + compaction     kernel 5  (ops/compact.py:compact_cands, K3+K4;
                                     spliced: re-search rows, proximity;
                                     sampled SA: the walk's offsets)
  diag_chars_multi         kernel 2  (K5, ops/splice.py), the windows of the
                                     core candidates and the extra slots on
                                     the reference and, on a graph index,
                                     the SNV planes, in one launch (the
                                     spliced re-search's rc0 in one more)
  extend_grouped           kernel 3  (ops/extend.py), core and extra slots
  pair_sweep               K13+K14   (ops/splice.py), spliced full pass
  inject_known             K16       (ops/splice.py), a spliced aligner and
                                     its lite twin
  inject_indels            kernel 7  (ops/splice.py, K10+K11), full pass on
                                     an index with known ALT indels
  self_indel_sweep         kernel 4  (ops/splice.py), strict rows (+ wide
                                     rows in DNA mode)
  top-Mdev, flags, spill   kernel 6  (ops/compact.py:pack_slots, K9)
  second_sweep             K15       (ops/splice.py), twice, spliced full
                                     pass

Kernel 6 reads the blocks of the unified slot schema in place; the
int32/16/8 packing (`_pack_out`) is torch glue.  The lite tier
(pipeline.py:307-313) skips the sweeps and the extra slots and sets h_sat.

Genome scale (pipeline.py:324-416, :1679-1689, :1941-2000): a
ShardedFMIndex runs one step per shard on the same batch, each against its
shard's device index, graph tables and window of the site tables, with
shard-local positions; `_merge_shards` rebases them into int64 global
joined coordinates and merges the shards' candidates on the host.

Host half: dispatch() enqueues the step on the current stream and starts
the device-to-host copy of the packed buffer into pinned memory, recording
a CUDA event that _fetch_out waits on; the numpy host phase is carried in
align/host.py, and the two-tier routing (lite pass, then the full pass on
the routed reads; for a spliced aligner also by the splice-site boundaries
added since the lite dispatch) below, from pipeline.py:1651-1943.  A
spliced aligner's collect() then runs the temp-site fixed point (the
batch re-runs while its alignments add sites; align/splice_db.py, whose
incremental table merge is K18).  On a CPU device everything runs the
plain versions synchronously (that is what the CPU tests compare with the
JAX package).

Paired reads go through the same step as one fused batch of both mates
(align/driver.py), with `collect(paired=True)`.  `rescue_mates` is the
device part of mate rescue: kernel 8 (ops/rescue.py:rescue_window, K12)
picks each rescue job's 8 best window diagonals, kernels 2 and 3 rescore
them, and the record loop of pipeline.py:1520-1565 runs on the host.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..index.format import (FMIndex, graph_to_device, score_tables,
                            to_device)
from ..ops import compact as compact_ops
from ..ops import extend as extend_ops
from ..ops import rescue as rescue_ops
from ..ops import resolve as resolve_ops
from ..ops import search as search_ops
from ..ops import splice as splice_ops
from ..utils import bitops
from ..utils.intops import wrap_i32
from .host import Alignment, BatchResult, HostPhase, SpillOverflow
from .scoring import Scoring

_I32 = torch.int32
# JAX's rescue_mates reads params["snv1"] on a graph index, which holds
# the SNV planes only when the index has one shard (pipeline.py:412-416):
# on a sharded graph index its first rescue job raises KeyError
SHARDED_GRAPH_RESCUE = (
    "paired reads on a graph index of more than one shard: the JAX "
    "package's mate rescue fails there (KeyError: 'snv1' at "
    "hisat2_tpu/align/pipeline.py:1484; its SNV planes are per shard and "
    "reach the rescue only on one shard, :412-416)")
# JAX's paired give-up replay reads h_rounds whenever a batch has lane
# metadata; on several shards lane metadata is off (pipeline.py:333-336)
# but a lite pass still returns its h_sat (:2280-2281)
SHARDED_SPLICED_PAIRS = (
    "spliced paired reads on an index of more than one shard: the JAX "
    "package's paired give-up replay fails there (KeyError: 'h_rounds' "
    "at hisat2_tpu/align/driver.py:540; lane metadata is off on several "
    "shards, pipeline.py:333-336, and the lite pass's lanes carry only "
    "h_sat, :2280-2281); pass --no-spliced-alignment")
_DT_NAME = {torch.int32: "int32", torch.bool: "bool",
            torch.float32: "float32"}


class TorchAligner(HostPhase):
    """Holds the device-resident index and runs the batch step.

    device: the aligner's device (the batch, the site DB, the small
    tables); shard_devices: a list of devices, shard i of a sharded index
    living on shard_devices[i % len] (default: every shard on `device`)."""

    def __init__(self, index: FMIndex, scoring: Optional[Scoring] = None,
                 k: int = 5, no_fw: bool = False,
                 no_rc: bool = False, lane_meta: bool = False,
                 max_seeds: int = 0, all_hits: bool = False,
                 anchor_stop: bool = True, device="cuda",
                 variants=None, spliced: bool = False, lite: bool = False,
                 inject_ss: bool = False, splice_db=None, tmo: bool = False,
                 require_xs: bool = False, shard_devices=None,
                 _devs=None, _ref_codes=None, _graph_bundle=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None \
                and torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        if (self.device.type == "cuda"
                or any(torch.device(x).type == "cuda"
                       for x in shard_devices or ())) \
                and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no "
                               "CUDA device")
        self.meta = index.meta
        self.scoring = scoring or Scoring()
        self.lite = lite
        # spliced mode (pipeline.py:248-255): the lite twin of a spliced
        # aligner injects known/temp sites; --tmo reports known junctions
        # only, --dta-cufflinks needs an XS strand on spliced alignments
        self.inject_ss = inject_ss
        self.use_ss = spliced or inject_ss
        self.tmo = tmo
        self.require_xs = require_xs
        self.anchor_stop = anchor_stop
        self.k = k
        self.all_hits = all_hits
        self.max_seeds = max_seeds if max_seeds else max(5, 2 * k)
        if all_hits:
            self.k = 10 ** 9
            self.max_seeds = 10 ** 9
        self.msize = min(max(self.k, self.max_seeds), 64)
        self.max_hits = 4              # TPUAligner's defaults
        self.ss_slots = 2
        self.max_pairs = 4
        n = index.meta.n
        self.min_k = 0
        while n > 0:
            n >>= 2
            self.min_k += 1
        if spliced:
            # short boundary anchors feed the junction pair sweep, +8
            # candidate slots, 16 short rows (pipeline.py:280-297)
            self.min_hit_len = 7
            self.core_cands = max(k + 1, 6) + 8
            self.max_cands = max(self.core_cands, self.msize + 1)
            self.short_rows = 16
        else:
            # DNA mode (pipeline.py:298-313)
            self.min_hit_len = 16
            self.core_cands = max(k + 1, 6)
            self.max_cands = max(self.core_cands, self.msize + 1)
            self.short_rows = 5
            if lite:
                self.lite_cap = 8
                self.msize = min(self.msize, self.lite_cap)
                self.max_cands = self.core_cands
        self.cand_per_hit = 6 if spliced else 4      # (:317)
        self.no_fw = no_fw
        self.no_rc = no_rc
        self.spliced = spliced
        self.lane_meta = lane_meta
        # genome scale (pipeline.py:324-350): a ShardedFMIndex runs one
        # device pass per sub-index, merged on the host into global joined
        # coordinates (shard_bases[s] + local); the replay glue reads
        # shards[0]
        if hasattr(index, "shards"):          # a ShardedFMIndex
            self.shards = list(index.shards)
            self.shard_bases = [int(b) for b in index.shard_bases]
            self.ref_codes = (_ref_codes if _ref_codes is not None
                              else index.global_ref_codes())
            if lane_meta and len(self.shards) > 1:
                # the paired give-up replay models ONE interleaved search;
                # per-shard round logs do not merge faithfully
                self.lane_meta = False
        else:
            self.shards = [index]
            self.shard_bases = [0]
            self.ref_codes = (_ref_codes if _ref_codes is not None
                              else bitops.unpack_2bit(
                                  np.asarray(index.ref_words), index.meta.n))
        # a two-tier twin shares its parent's device bundles and tables;
        # shard_devices (pipeline.py:346-350) puts shard i on
        # shard_devices[i % len], and everything its step reads goes with
        # it (the graph tables here, the score and intron-length tables
        # in _params_on, the site-table window in _step_site_args, the
        # batch in _dispatch_packed)
        nsh = len(self.shards)
        if _devs is not None:
            self.devs = _devs
        else:
            sdev = [torch.device(shard_devices[i % len(shard_devices)])
                    if shard_devices else self.device for i in range(nsh)]
            self.devs = [to_device(sh, d)
                         for sh, d in zip(self.shards, sdev)]
        self.dev = self.devs[0]
        self.frag_joined = np.asarray(index.frag_joined)
        self.frag_ref = np.asarray(index.frag_ref)
        self.frag_off = np.asarray(index.frag_off)
        self.params = score_tables(self.scoring, self.device)
        # variant (ALT) database (pipeline.py:363-411): per-shard device
        # tables with the shard's variants in local coordinates, and a
        # host-only global view (Zs, routing) on a sharded index;
        # shard_row_db maps a shard's indel-table rows to VariantDB rows
        self.variants = variants
        self.has_indels = False
        if _graph_bundle is not None:
            (self.graph, self.has_indels, self.shard_graph_dev,
             self.shard_row_db) = _graph_bundle
        elif variants is not None and variants.n_snps:
            from ..index.graph import build_graph_arrays, shard_graph_arrays
            if nsh == 1:
                shard_graphs = [build_graph_arrays(index, variants)]
                self.graph = shard_graphs[0]
            else:
                self.graph = build_graph_arrays(
                    index, variants, ref_codes=self.ref_codes,
                    with_planes=False)
                shard_graphs = [
                    shard_graph_arrays(sh, variants, b)
                    for sh, b in zip(self.shards, self.shard_bases)]
            self.has_indels = any(len(g.indel_pos) for g in shard_graphs)
            self.shard_graph_dev, self.shard_row_db = (list(t) for t in zip(
                *(graph_to_device(g, self.has_indels, d.device)
                  for g, d in zip(shard_graphs, self.devs))))
        else:
            self.graph = None
            self.shard_graph_dev = [{} for _ in range(nsh)]
            self.shard_row_db = [None] * nsh
        self.graph_dev = self.shard_graph_dev[0]   # rescue_mates (1 shard)
        self._graph_bundle = (self.graph, self.has_indels,
                              self.shard_graph_dev, self.shard_row_db)
        sc = self.scoring
        self.splice_params = splice_ops.SpliceParams(
            min_intron=sc.min_intron_len, max_intron=sc.max_intron_len,
            pen_can=sc.pen_can_splice, pen_noncan=sc.pen_noncan_splice,
            lenpen_const=sc.pen_can_intron_len.const,
            lenpen_coef=sc.pen_can_intron_len.coef,
            lenpen_nc_const=sc.pen_noncan_intron_len.const,
            lenpen_nc_coef=sc.pen_noncan_intron_len.coef,
            min_anchor=sc.min_anchor, min_anchor_noncan=sc.min_anchor_noncan,
            rd_gap_open=sc.rd_gap_open, rd_gap_ext=sc.rd_gap_ext,
            rf_gap_open=sc.rf_gap_open, rf_gap_ext=sc.rf_gap_ext,
            allow_spliced=spliced)
        # the splice-site DB (pipeline.py:440-452): the lite twin shares
        # its parent's, so pass-1 injection sees the same table
        if spliced:
            from .splice_db import SpliceSiteDB
            self.splice_db = (splice_db if splice_db is not None
                              else SpliceSiteDB(index, device=self.device))
            # the index's baked --ss sites (pipeline.py:444-445)
            if variants is not None and len(variants.ss_ref):
                self.splice_db.add_from_variants(variants)
        else:
            self.splice_db = splice_db if inject_ss else None
        self._lenpen = (splice_ops.lenpen_device(self.splice_params,
                                                 self.device)
                        if spliced else None)
        # per-device copies of the small tables, for shards elsewhere
        self._dev_params = {str(self.device): (self.params, self._lenpen)}
        # packed-buffer layouts, keyed by width (spill and full_out coexist)
        self._out_specs = {}
        self._spill_meta = {}
        # DNA mode on a graph index: a lite tier-A pass finishes perfect /
        # near-perfect reads, the full machinery runs only on the routed
        # subset (pipeline.py:481-494)
        self._fast = None
        if spliced:
            # the spliced aligner's lite twin with known-site injection
            # (pipeline.py:470-480)
            self._fast = TorchAligner(
                index, scoring=self.scoring, k=k, no_fw=no_fw, no_rc=no_rc,
                variants=variants, lane_meta=lane_meta, max_seeds=max_seeds,
                all_hits=all_hits, anchor_stop=anchor_stop,
                device=self.device, lite=not all_hits,
                inject_ss=not all_hits, splice_db=self.splice_db, tmo=tmo,
                require_xs=require_xs, _devs=self.devs,
                _ref_codes=self.ref_codes, _graph_bundle=self._graph_bundle)
        elif (not lite and not all_hits and variants is not None
                and variants.n_snps):
            self._fast = TorchAligner(
                index, scoring=self.scoring, k=k, no_fw=no_fw, no_rc=no_rc,
                variants=variants, lane_meta=lane_meta, max_seeds=max_seeds,
                anchor_stop=anchor_stop, device=self.device, lite=True,
                _devs=self.devs, _ref_codes=self.ref_codes,
                _graph_bundle=self._graph_bundle)
        # host-side routing table: reads overlapping a known ALT indel go
        # to the full pass (pipeline.py:495-505)
        self._indel_bounds = None
        if (self._fast is not None and self.graph is not None
                and len(self.graph.indel_pos)):
            ip = np.asarray(self.graph.indel_pos, np.int64)
            il = np.maximum(np.asarray(self.graph.indel_len, np.int64), 0)
            self._indel_bounds = np.unique(
                np.concatenate([ip - 1, ip + il + 1]))

    def _params_on(self, dev):
        """(score tables, intron-length tables) on `dev`: the aligner's own
        on its device, a copy made once for a shard placed elsewhere."""
        key = str(dev)
        if key not in self._dev_params:
            self._dev_params[key] = (
                score_tables(self.scoring, dev),
                splice_ops.lenpen_device(self.splice_params, dev)
                if self.spliced else None)
        return self._dev_params[key]

    # ------------------------------------------------------------------
    def _align_device(self, d, gd, reads, quals, lens, minsc, uniform: bool,
                      full_out: bool, capture: dict = None, rdids=None,
                      ss=None):
        """Device computation for one batch against one shard: [B, L] ->
        output dict (pipeline.py:725-1446).  d: the shard's TorchFMIndex,
        gd: its graph tables; positions are shard-local.  Lanes 0..B-1
        forward, B..2B-1 reverse complement.  rdids [B] int32 and ss
        (SpliceSiteDB.device_tables of the shard's window) feed the site
        injection of a spliced aligner and its lite twin.  Returns (out,
        spill_meta).

        capture: when a dict, receives the keyword arguments of the first
        call of each hand-kernel wrapper under its name, or under `key`
        where one wrapper has two roles (chip_smoke.py replays them
        through the kernel and its plain twin)."""
        def call(name, fn, key=None, **kw):
            key = key or name
            if capture is not None and key not in capture:
                capture[key] = kw
            return fn(**kw)

        meta = d.meta
        sampled = meta.off_rate > 0
        params, lenpen = self._params_on(reads.device)

        def walk(top, live, key=None):
            # sampled SA: the LF walk over the live rows of top..top+P-1
            # (resolve_consecutive's sampled branch, resolve.py:187-195)
            return call("resolve_walk", resolve_ops.resolve_rows_sparse,
                        key=key, **resolve_ops.walk_args(
                            d.sa, meta.off_rate, top, live.shape[-1], live,
                            d.blocked, d.fchr, meta.zrow)).reshape(
                                live.shape)
        dv = reads.device
        B, L = reads.shape
        if uniform:
            g = reads.flip(1)
            rc = torch.where(g < 4, 3 - g, 4).to(_I32)
            qr = quals.flip(1)
        else:
            col = torch.arange(L, device=dv, dtype=_I32)[None, :]
            idxr = lens[:, None] - 1 - col
            ok = idxr >= 0
            gi = idxr.clamp(min=0).to(torch.int64)
            g = reads.gather(1, gi)
            rc = torch.where(ok & (g < 4), 3 - g, 4).to(_I32)
            qr = torch.where(ok, quals.gather(1, gi), 0).to(_I32)
        ar = torch.cat([reads, rc]).contiguous()
        aq = torch.cat([quals, qr]).contiguous()
        al = torch.cat([lens, lens]).contiguous()
        am = torch.cat([minsc, minsc]).contiguous()
        N = 2 * B

        H = max(self.max_hits, L // (self.min_k + 12) + 2)
        hits = call("fm_search2", search_ops.partial_search2,
                    blocked=d.blocked, fchr=d.fchr, ftab2_top=d.ftab2_top,
                    zrow=meta.zrow, zrow2=meta.zrow2, rows=meta.rows,
                    reads=ar, lens=al, max_hits=H,
                    min_hit_len=self.min_hit_len, min_k=self.min_k,
                    uniform=uniform, anchor_stop=self.anchor_stop)

        # the hit gates and the resolve of their rows (:772-801); a full
        # SA resolves inside kernel 5, a sampled one through the walk
        Pc = max(self.cand_per_hit, self.short_rows, self.msize)
        maxsize = max(self.k, self.max_seeds)
        offs = None
        if sampled:
            hv, cval = compact_ops.resolve_live(
                hits.top, hits.bot, hits.lo, hits.hi, hits.nh, Pc,
                self.min_k, maxsize, self.short_rows,
                self.lite_cap if self.lite else 0)
            offs = walk(torch.where(hv, hits.top, 0), cval)
        research = {}
        if self.spliced:
            # prefix re-search (:810-883): cut = lo of the second-to-last
            # hit, tightened to the clean suffix run of the first
            # align-capable width-1 anchor's diagonal (rc0 through K5)
            nh = hits.nh
            cut = compact_ops.take_cols(
                hits.lo, torch.clamp(nh - 2, min=0)[:, None])[:, 0]
            cut = torch.where(nh >= 2, cut, 0)
            wh = hits.bot - hits.top
            anchor_ok = (wh == 1) & ((hits.hi - hits.lo) > self.min_k + 2)
            first_a = anchor_ok.to(torch.uint8).argmax(1)[:, None]
            have_a = anchor_ok.any(1)
            if sampled:
                # the anchor's first resolved row (:827-836; 0 on a dead
                # slot, as the walk returns it)
                off_a = compact_ops.take_cols(offs[:, :, 0], first_a)[:, 0]
            else:
                top_a = torch.where(have_a, compact_ops.take_cols(
                    hits.top, first_a)[:, 0], 0)
                top_a = torch.clamp(top_a, max=d.sa.shape[0] - 1)
                off_a = d.sa[top_a.to(torch.int64)]
            d0 = off_a - compact_ops.take_cols(hits.lo, first_a)[:, 0]
            rc0 = call("ref_window", splice_ops.diag_chars_multi,
                       key="ref_window/rc0", planes=[d.ref_words],
                       n_text=meta.n,
                       starts=[d0[:, None].to(_I32).contiguous()],
                       margins=[0], L=L)[0][0][:, 0, :]
            colL = torch.arange(L, device=dv, dtype=_I32)[None, :]
            mm0 = (colL < al[:, None]) & ((ar != torch.clamp(rc0, max=3))
                                          | (ar > 3) | (rc0 > 3))
            last0 = (L - 1) - mm0.flip(1).to(torch.uint8).argmax(1)
            cut_ext = torch.where(have_a & mm0.any(1), last0 + 1, 2 ** 30)
            cut = torch.minimum(cut, cut_ext).to(_I32).contiguous()
            hits2 = call("search_lanes_live", search_ops.search_lanes_live,
                         blocked=d.blocked, fchr=d.fchr,
                         ftab2_top=d.ftab2_top, zrow=meta.zrow,
                         zrow2=meta.zrow2, rows=meta.rows, reads=ar, cut=cut,
                         max_hits=2, min_hit_len=self.min_hit_len,
                         min_k=self.min_k)
            # a sampled SA keeps the narrow row cap: each row costs a walk
            P2 = 32 if not sampled else self.short_rows       # (:870)
            research = dict(top2=hits2.top, bot2=hits2.bot, lo2=hits2.lo,
                            nh2=hits2.nh, P2=P2,
                            max_intron=self.scoring.max_intron_len)
            if sampled:
                hv2, cval2 = compact_ops.research_live(
                    hits2.top, hits2.bot, hits2.nh, P2)
                research["offs2"] = walk(torch.where(hv2, hits2.top, 0),
                                         cval2, key="resolve_walk/research")

        # hit gates, resolve, dedup + compaction (:772-998)
        C = self.max_cands
        cands = call("compact_cands", compact_ops.compact_cands,
                     sa=d.sa, top=hits.top, bot=hits.bot, lo=hits.lo,
                     hi=hits.hi, nh=hits.nh, abefore=hits.abefore,
                     post=hits.post, stopped=hits.stopped, P=Pc,
                     C=C, CC=min(self.core_cands, C), min_k=self.min_k,
                     maxsize=maxsize, short_rows=self.short_rows,
                     lite_cap=self.lite_cap if self.lite else 0,
                     lane_meta=self.lane_meta, offs=offs, **research)
        cstart, cvalid, cvalid_long, cab, cpost = cands[:5]
        xstart, xvalid, xab, xpost = cands[5:9]

        sp = self.splice_params
        g_budget = max(1, (-int(self.scoring.min_score(L))
                           - min(sp.rd_gap_open, sp.rf_gap_open))
                       // max(min(sp.rd_gap_ext, sp.rf_gap_ext), 1))
        g_budget = min(g_budget, sp.min_intron - 1)
        margin = max(16, g_budget)
        mstart = torch.where(cvalid, cstart, -1).to(_I32).contiguous()
        # the windows of the core candidates (with the margin) and of the
        # extra slots (none), on the reference and, on a graph index, the
        # SNV planes (:1011-1016): one launch
        planes = [d.ref_words] + ([gd["snv1"], gd["snv2"]]
                                  if self.graph is not None else [])
        sets, margins = [mstart], [margin]
        if xstart.shape[1]:
            sets.append(torch.where(xvalid, xstart, -1).to(_I32)
                        .contiguous())
            margins.append(0)
        wins = call("ref_window", splice_ops.diag_chars_multi, planes=planes,
                    n_text=meta.n, starts=sets, margins=margins, L=L)
        ch, s1w, s2w = (wins[0] + [None, None])[:3]
        ext = call("extend_ungapped", extend_ops.extend_grouped,
                   n_text=meta.n, reads=ar, quals=aq, lens=al,
                   cand_start=mstart, mm_pen=params["mm_pen"],
                   clip_pen=params["clip_pen"],
                   n_pen=self.scoring.n_pen, win_chars=ch,
                   win_margin=margin,
                   allow_softclip=not self.scoring.no_softclip,
                   uniform_len=uniform, minsc=am,
                   mm_min=self.scoring.mm_min, snv1_win=s1w, snv2_win=s2w)
        ext_x = None
        if xstart.shape[1]:
            xs_m = sets[1]
            ch_x, s1x, s2x = (wins[1] + [None, None])[:3]
            ext_x = call("extend_ungapped", extend_ops.extend_grouped,
                         key="extend_ungapped/extra", n_text=meta.n,
                         reads=ar, quals=aq, lens=al, cand_start=xs_m,
                         mm_pen=params["mm_pen"],
                         clip_pen=params["clip_pen"],
                         n_pen=self.scoring.n_pen, win_chars=ch_x,
                         win_margin=0,
                         allow_softclip=not self.scoring.no_softclip,
                         uniform_len=uniform, minsc=am,
                         mm_min=self.scoring.mm_min, snv1_win=s1x,
                         snv2_win=s2x)
        out = {}
        if self.lite:
            out["h_sat"] = cands.h_sat
        if self.lane_meta:
            out.update({"h_rounds": hits.rounds, "h_rn": hits.nrounds,
                        "h_minw": cands.h_minw,
                        "h_alignable": cands.h_alignable,
                        "h_stop": hits.stopped})

        blocks = []
        if sp.allow_spliced:
            # the junction pair sweep and its top pairs (:1080-1099)
            res, sel, bsel = call(
                "pair_sweep", splice_ops.pair_sweep, ch=ch, reads=ar,
                quals=aq, lens=al, starts=cstart, valid=cvalid.contiguous(),
                minsc=am, mm_pen=params["mm_pen"],
                n_pen=self.scoring.n_pen, n_text=meta.n, prm=sp,
                lenpen=lenpen, max_gap=g_budget, margin=margin,
                top=self.max_pairs, snv1_w=s1w, snv2_w=s2w)
            blocks.append(dict(
                sel, ab=torch.maximum(compact_ops.take_cols(cab, sel["i"]),
                                      compact_ops.take_cols(cab, sel["j"])),
                post=(compact_ops.take_cols(cpost, sel["i"])
                      & compact_ops.take_cols(cpost, sel["j"])),
                known=0, selfgap=0))
        rd2 = None
        if self.use_ss:
            # known/temp splice-site injection (:1109-1140)
            rd2 = torch.cat([rdids, rdids]).to(_I32).contiguous()
            inj = call("inject_known", splice_ops.inject_known,
                       ref_words=d.ref_words, n_text=meta.n, reads=ar,
                       quals=aq, lens=al, rdids=rd2, starts=cstart,
                       valid=cvalid.contiguous(), ch=ch, margin=margin,
                       tabs=ss, mm_pen=params["mm_pen"],
                       n_pen=self.scoring.n_pen, minsc=am,
                       slots=self.ss_slots, src_clip_l=ext.clip_l,
                       src_clip_r=ext.clip_r,
                       clip_pen=params["clip_pen"], snv1_w=s1w, snv2_w=s2w,
                       snv_delta1=gd.get("snv1"), snv_delta2=gd.get("snv2"))
            src_i = inj.pop("src")
            blocks.append(dict(inj, ab=compact_ops.take_cols(cab, src_i),
                               post=compact_ops.take_cols(cpost, src_i),
                               known=1, selfgap=0))
        if self.has_indels and not self.lite:
            # known ALT indel injection (:1141-1160)
            injd = call("inject_indels", splice_ops.inject_indels,
                        ref_words=d.ref_words, n_text=meta.n, reads=ar,
                        quals=aq, lens=al, starts=cstart,
                        valid=cvalid.contiguous(), ch=ch, snv1_w=s1w,
                        snv2_w=s2w, margin=margin, ip=gd["ind_ip"],
                        ilen=gd["ind_len"], ins_chars=gd["ind_chars"],
                        rkey=gd["ind_rkey"], r_ilen=gd["ind_rlen"],
                        r_row=gd["ind_rrow"], mm_pen=params["mm_pen"],
                        n_pen=self.scoring.n_pen, minsc=am,
                        snv_delta1=gd["snv1"], snv_delta2=gd["snv2"],
                        slots=self.ss_slots)
            src_i = injd.pop("src")
            blocks.append(dict(injd, ab=compact_ops.take_cols(cab, src_i),
                               post=compact_ops.take_cols(cpost, src_i),
                               known=1, selfgap=0))
        if not self.lite:
            # single-anchor small-gap sweep, strict + wide rows (:1161-1209)
            selfw = call("indel_sweep", splice_ops.self_indel_sweep,
                         ch=ch, reads=ar, quals=aq, lens=al, starts=cstart,
                         valid=cvalid.contiguous(), minsc=am,
                         mm_pen=params["mm_pen"],
                         n_pen=self.scoring.n_pen, prm=sp, max_gap=g_budget,
                         snv1_w=s1w, snv2_w=s2w)
            src_i = selfw.pop("src")
            sab = compact_ops.take_cols(cab, src_i)
            spost = compact_ops.take_cols(cpost, src_i)
            blocks.append(dict({k2: selfw[k2] for k2 in
                                ("score", "d1", "d2", "x", "kind", "spldir")},
                               ab=sab, post=spost, known=0, selfgap=1))
        if not self.lite and not sp.allow_spliced:
            # wide rows (:1181-1209): DNA mode only
            other_d = selfw["w_d1"] + selfw["w_d2"] - cstart
            eqm = (other_d[:, :, None]
                   == torch.where(cvalid, cstart, -1)[:, None, :])
            pair_eq = torch.any(eqm, dim=2)
            oidx = eqm.to(torch.uint8).argmax(dim=2).to(_I32)
            wab = torch.maximum(sab, torch.where(
                pair_eq, compact_ops.take_cols(cab, oidx), 0))
            wpost = spost & torch.where(
                pair_eq, compact_ops.take_cols(cpost, oidx), True)
            blocks.append(dict(
                score=torch.where(pair_eq, selfw["w_score"],
                                  -splice_ops._BIG),
                d1=selfw["w_d1"], d2=selfw["w_d2"], x=selfw["w_x"],
                kind=torch.where(pair_eq, selfw["w_kind"], 0),
                spldir=selfw["w_spldir"], ab=wab, post=wpost, known=0,
                selfgap=0))
        if ext_x is not None:
            blocks.append(dict(
                score=torch.where(xvalid & ext_x.ok, ext_x.score,
                                  -splice_ops._BIG),
                d1=xstart, d2=xstart, x=0, kind=0, spldir=0,
                known=0, ab=xab, post=xpost, selfgap=0,
                n_mm=ext_x.n_mm, n_n=ext_x.n_n,
                clip_l=ext_x.clip_l, clip_r=ext_x.clip_r,
                alt=ext_x.alt_score))

        # the unified slot schema (:1211-1277): the ungapped slots, then
        # every block, read in place by kernel 6; the event row only on an
        # index with known ALT indels (-1 outside the injected block)
        base = dict(score=ext.score, d1=cstart, d2=cstart, x=0, kind=0,
                    spldir=0, known=0, ab=cab, post=cpost, selfgap=0,
                    n_mm=ext.n_mm, n_n=ext.n_n, clip_l=ext.clip_l,
                    clip_r=ext.clip_r, alt=ext.alt_score,
                    valid=cvalid_long & ext.ok)
        blocks = [base] + blocks
        Ktot = sum(b["score"].shape[1] for b in blocks)
        Mdev = min(Ktot, max(10, self.msize + 2))
        use_spill = (not full_out) and Mdev > 2
        wide_d2 = bool(sp.allow_spliced or self.use_ss)
        out.update(call("pack_slots", compact_ops.pack_slots, blocks=blocks,
                        Mdev=Mdev, use_spill=use_spill, spliced=wide_d2,
                        has_event=self.has_indels))
        if self.spliced:
            out.update(self._second_junctions(
                call, res, bsel, ch, ar, aq, al, am, cstart, cvalid, margin,
                ss, rd2, meta.n))
        return out, ((Mdev, wide_d2) if use_spill else None)

    def _second_junctions(self, call, res, bsel, ch, ar, aq, al, am, cstart,
                          cvalid, margin, ss, rd2, n_text):
        """The second-junction composites off the top-2 raw base pairs
        (pipeline.py:1376-1445): one K15 launch for both base pairs, then
        the 3-junction composite of each pair's ungated sides."""
        N, Cc = cstart.shape
        params, lenpen = self._params_on(ar.device)
        bflat = bsel.to(torch.int64).t()                 # [2, N]: q2, r2
        b_i = (bflat // Cc).to(_I32)
        b_j = (bflat % Cc).to(_I32)

        def gpair(a):
            return a.reshape(N, Cc * Cc).gather(1, bflat.t()).t()

        b_score = gpair(res["raw"])
        b_x = gpair(res["x"])
        b_kind = gpair(res["kind"])
        b_dir = gpair(res["spldir"])
        b_ok = (b_score > -(2 ** 29)) & (b_kind != splice_ops.KIND_NONE)
        sides = call("second_sweep", splice_ops.second_sweep, ch=ch,
                     reads=ar, quals=aq, lens=al, starts=cstart,
                     valid=cvalid.contiguous(), minsc=am,
                     mm_pen=params["mm_pen"], n_pen=self.scoring.n_pen,
                     n_text=n_text, prm=self.splice_params, lenpen=lenpen,
                     margin=margin, b_i=b_i.contiguous(),
                     b_j=b_j.contiguous(), b_x=b_x.contiguous(),
                     b_score=b_score.contiguous(), b_valid=b_ok.contiguous(),
                     ss=ss, rdids=rd2)
        out = {}
        for t, (pfx2, pfx3) in enumerate((("q2_", "q3_"), ("r2_", "r3_"))):
            lu, ru = sides[t]["left"], sides[t]["right"]
            q3_sc = wrap_i32(lu["uscore"].to(torch.int64) + ru["uscore"]
                             - b_score[t])
            q3_ok = ((lu["uscore"] > -(2 ** 29)) & (ru["uscore"] > -(2 ** 29))
                     & b_ok[t] & (q3_sc >= am))
            q3_sc = torch.where(q3_ok, q3_sc, -(2 ** 30)).to(_I32)
            st = lambda k: torch.stack([ru[k], lu[k]], 1).to(_I32)  # noqa
            out.update({
                pfx2 + "score": st("score"), pfx2 + "d": st("d"),
                pfx2 + "x": st("x"), pfx2 + "dir": st("dir"),
                pfx2 + "bd1": cstart.gather(1, b_i[t][:, None].long())[:, 0],
                pfx2 + "bd2": cstart.gather(1, b_j[t][:, None].long())[:, 0],
                pfx2 + "bx": b_x[t], pfx2 + "bkind": b_kind[t],
                pfx2 + "bdir": b_dir[t],
                pfx2 + "bknown": torch.zeros_like(b_x[t]),
                pfx3 + "score": q3_sc,
                pfx3 + "ld": lu["ud"], pfx3 + "lx": lu["ux"],
                pfx3 + "ldir": lu["udir"],
                pfx3 + "rd": ru["ud"], pfx3 + "rx": ru["ux"],
                pfx3 + "rdir": ru["udir"]})
        return out

    @staticmethod
    def _pack_out(out: dict, L: int):
        """One int32 buffer per batch (pipeline.py:536-600): int32
        columns, then int16 pairs, then int8 quads.  Returns (buf,
        specs).  This interleaving of columns with shifts and masks is
        torch glue (a few elementwise launches), not a ported kernel."""
        I32 = {"u_d1", "u_d2", "u_event", "h_rounds",
               "q2_d", "q2_bd1", "q2_bd2", "sp_src", "sp_w", "sp_ev",
               "q3_ld", "q3_rd", "r2_d", "r2_bd1", "r2_bd2",
               "r3_ld", "r3_rd"}
        I8 = {"u_flags", "u_dd", "u_ab", "h_alignable", "h_stop", "h_sat",
              "q2_bkind", "q2_bdir", "q2_dir", "q2_bknown",
              "q3_ldir", "q3_rdir", "r2_bkind", "r2_bdir", "r2_dir",
              "r2_bknown", "r3_ldir", "r3_rdir"}
        if L <= 127:
            I8 |= {"u_n_mm", "u_n_n", "u_clip_l", "u_clip_r", "u_x",
                   "q2_x", "q2_bx", "q3_lx", "q3_rx",
                   "r2_x", "r2_bx", "r3_lx", "r3_rx"}
        cols, specs, half, quart = [], [], [], []
        for k in sorted(out):
            v = out[k]
            dt = _DT_NAME[v.dtype]
            if v.dtype == torch.float32:
                v = v.view(_I32)
            v2 = v.reshape(v.shape[0], -1).to(_I32)
            shape = tuple(v.shape[1:])
            if k in I32 or dt == "float32":
                specs.append((k, dt, shape, v2.shape[1], "i32"))
                cols.append(v2)
            elif k in I8:
                specs.append((k, dt, shape, v2.shape[1], "i8"))
                quart.append(v2.clamp(-128, 127))
            else:
                specs.append((k, dt, shape, v2.shape[1], "i16"))
                half.append(v2.clamp(-32768, 32767))
        if half:
            hcat = torch.cat(half, dim=1).to(torch.int64)
            if hcat.shape[1] % 2:
                hcat = torch.cat([hcat, torch.zeros_like(hcat[:, :1])], 1)
            cols.append(wrap_i32((hcat[:, 0::2] & 0xFFFF)
                                 | (hcat[:, 1::2] << 16)))
        if quart:
            qcat = torch.cat(quart, dim=1).to(torch.int64)
            pad = (-qcat.shape[1]) % 4
            if pad:
                qcat = torch.cat(
                    [qcat, qcat.new_zeros((qcat.shape[0], pad))], 1)
            cols.append(wrap_i32((qcat[:, 0::4] & 0xFF)
                                 | ((qcat[:, 1::4] & 0xFF) << 8)
                                 | ((qcat[:, 2::4] & 0xFF) << 16)
                                 | (qcat[:, 3::4] << 24)))
        return torch.cat(cols, dim=1).contiguous(), specs

    def step(self, reads, quals, lens, minsc, uniform: bool,
             full_out: bool = False, capture: dict = None, rdids=None,
             ss=None, shard: int = 0):
        """The whole device step of one shard on device tensors (int32
        [B, L] reads and quals, int32 [B] lens, minsc and rdids; ss the
        shard's site tables for a spliced aligner): the packed buffer,
        with its layout recorded in _out_specs / _spill_meta under its
        width."""
        out, spill_meta = self._align_device(
            self.devs[shard], self.shard_graph_dev[shard], reads, quals,
            lens, minsc, uniform, full_out, capture, rdids, ss)
        buf, specs = self._pack_out(out, reads.shape[1])
        self._out_specs[buf.shape[1]] = specs
        self._spill_meta[buf.shape[1]] = spill_meta
        return buf

    # ------------------------------------------------------------------
    def upload(self, codes, quals, lens, minsc, device=None):
        """Batch arrays -> int32 tensors on `device` (the aligner's by
        default)."""
        dev = self.device if device is None else device

        def up(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(dev).to(_I32)
        return (up(codes), up(quals), up(np.asarray(lens)),
                up(np.asarray(minsc, np.int64).astype(np.int32)))

    def _minsc(self, lens):
        return np.array([self.scoring.min_score(int(x)) for x in lens],
                        np.int64)

    def _step_site_args(self, rdids, shard: int = 0):
        """(rdids tensor, the shard's window of the site tables) for the
        step of a site-injecting aligner (pipeline.py:1684-1686), else
        (None, None)."""
        if not self.use_ss:
            return None, None
        dev = self.devs[shard].device
        rd = torch.from_numpy(np.asarray(rdids, np.int64).astype(np.int32))
        tabs = self.splice_db.device_tables(self.shard_bases[shard],
                                            self.devs[shard].meta.n)
        return rd.to(dev), {k: v.to(dev) if torch.is_tensor(v) else v
                            for k, v in tabs.items()}

    def _dispatch_packed(self, codes, quals, lens, minsc, uniform,
                         full_out=False, rdids=None):
        """One step per shard (pipeline.py:1679-1689), each on its shard's
        device (the batch uploaded once per device): a list of packed
        handles, each with its D2H copy already enqueued."""
        if rdids is None:
            rdids = np.arange(codes.shape[0], dtype=np.int64)
        ups = {}
        packed = []
        for i, d in enumerate(self.devs):
            key = str(d.device)
            if key not in ups:
                ups[key] = self.upload(codes, quals, lens, minsc, d.device)
            rd, ss = self._step_site_args(rdids, i)
            buf = self.step(*ups[key], uniform, full_out, rdids=rd, ss=ss,
                            shard=i)
            if buf.is_cuda:
                # enqueue the D2H copy now, behind the step on the same
                # stream; _fetch_out waits on the event (the counterpart
                # of JAX's copy_to_host_async, pipeline.py:1672-1676)
                host = torch.empty(buf.shape, dtype=_I32, pin_memory=True)
                host.copy_(buf, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(buf.device))
                packed.append((host, ev))
            else:
                packed.append((buf, None))
        return packed

    def _fetch_out(self, packed) -> dict:
        host, ev = packed
        if ev is not None:
            ev.synchronize()
        return HostPhase._fetch_out(self, host.numpy())

    # position-valued output keys (rebased by shard_base at merge)
    _POS_KEYS = ("u_d1", "u_d2", "q2_d", "q2_bd1", "q2_bd2")

    def _merge_shards(self, packed_list) -> dict:
        """Fetch the per-shard outputs and merge them into one candidate
        dict in GLOBAL joined coordinates (pipeline.py:1944-2000): the
        position keys rebased to int64, indel-table rows mapped through
        each shard's row_db, the per-lane q2_* set of the shard with the
        best composite, the h_* reductions, and the candidate rows
        concatenated.  One shard at base 0 only maps its u_event rows."""
        outs = [self._fetch_out(pk) for pk in packed_list]
        if len(outs) == 1 and self.shard_bases[0] == 0:
            out0 = outs[0]
            rdb = self.shard_row_db[0]
            if rdb is not None and "u_event" in out0:
                v = out0["u_event"]
                ev = v >= 0
                v = v.copy()
                v[ev] = rdb[v[ev]]
                out0["u_event"] = v
            return out0
        merged = {}
        best_q2 = None
        if "q2_score" in outs[0]:
            best_q2 = np.argmax(np.stack(
                [o["q2_score"].max(axis=1) for o in outs]), axis=0)
        for k in outs[0]:
            vs = []
            for si, (o, base) in enumerate(zip(outs, self.shard_bases)):
                v = o[k]
                if k in self._POS_KEYS:
                    v = v.astype(np.int64) + base
                elif k == "u_event":
                    rdb = self.shard_row_db[si]
                    if rdb is not None:
                        ev = v >= 0
                        v = v.copy()
                        v[ev] = rdb[v[ev]]
                vs.append(v)
            if k.startswith("q2_"):
                stk = np.stack(vs)                      # [S, 2B, ...]
                idx = best_q2.reshape((1, -1) + (1,) * (stk.ndim - 2))
                merged[k] = np.take_along_axis(stk, idx, axis=0)[0]
            elif k == "h_minw":
                merged[k] = np.minimum.reduce(vs)
            elif k in ("h_alignable", "h_stop"):
                merged[k] = np.logical_or.reduce(vs)
            elif k in ("h_rn", "h_sat"):
                merged[k] = np.add.reduce(vs)
            elif k == "h_rounds":
                merged[k] = vs[0]
            elif vs[0].ndim >= 2:
                merged[k] = np.concatenate(vs, axis=1)
            else:
                merged[k] = vs[0]
        return merged

    def dispatch(self, codes: np.ndarray, quals: np.ndarray,
                 lens: np.ndarray, rdids: np.ndarray = None):
        """Enqueue one batch (returns before the device finishes); pair
        with collect().  A two-tier aligner dispatches its lite pass here
        and returns a two-pass handle (pipeline.py:1660-1662)."""
        if self._fast is not None:
            h1 = self._fast.dispatch(codes, quals, lens, rdids)
            return ("2pass", h1, codes, quals, lens, rdids)
        if rdids is None:
            rdids = np.arange(codes.shape[0], dtype=np.int64)
        minsc = self._minsc(lens)
        uniform = bool(np.all(np.asarray(lens) == codes.shape[1]))
        ver = self.splice_db.n_sites if self.splice_db is not None else 0
        packed = self._dispatch_packed(codes, quals, lens, minsc, uniform,
                                       rdids=rdids)
        return (packed, codes, quals, lens, rdids, minsc, ver)

    def _merge_or_respill(self, packed, codes, quals, lens, rdids):
        """_merge_shards, re-dispatching with the full_out layout when the
        spill layout overflowed its S = 2B rows (pipeline.py:1691-1707)."""
        try:
            return self._merge_shards(packed)
        except SpillOverflow:
            uniform = bool(np.all(np.asarray(lens) == codes.shape[1]))
            return self._merge_shards(self._dispatch_packed(
                codes, quals, lens, self._minsc(lens), uniform,
                full_out=True, rdids=rdids))

    def collect(self, handle, paired: bool = False) -> BatchResult:
        """Finish a dispatched batch: fetch and run the host phase; a
        two-pass handle runs its remaining stages (pipeline.py:1709-1734).
        A spliced aligner then iterates the temp splice-site fixed point:
        while the batch's alignments add sites, the batch re-runs through
        the full pass with the grown table (readid-gated on the device).
        paired: the batch is a fused pair batch (mate 1 reads, then mate 2
        reads), whose host phase skips the unpaired interleave replay."""
        if handle[0] == "2pass":
            return self._finish_two_pass(
                self._advance_two_pass(handle, paired), paired)
        if handle[0] == "2pass2":
            return self._finish_two_pass(handle, paired)
        packed, codes, quals, lens, rdids, minsc, ver = handle
        res = self._host_phase(
            self._merge_or_respill(packed, codes, quals, lens, rdids),
            codes, quals, lens, minsc, paired=paired)
        if not self.spliced or self.splice_db is None:
            return res
        for _ in range(4):
            if self.tmo:
                break           # --tmo: no temp splice sites
            added = self.splice_db.collect_from_alignments(
                res.alignments, rdids, lens, codes, self.ref_codes)
            if not added and self.splice_db.n_sites == ver:
                break
            ver = self.splice_db.n_sites
            t0 = time.perf_counter()
            h = self._dispatch_full(codes, quals, lens, rdids)
            res = self._host_phase(self._merge_shards(h[0]), codes, quals,
                                   lens, minsc, paired=paired)
            self.fixed_point_runs += 1
            self.fixed_point_s += time.perf_counter() - t0
        return res

    # the temp-site re-runs of the full pass: count and host seconds
    fixed_point_runs = 0
    fixed_point_s = 0.0

    # -- two tiers (pipeline.py:1736-1943) --
    def _dispatch_full(self, codes, quals, lens, rdids=None):
        """The full device pass on exactly these arrays (:1736-1742)."""
        saved, self._fast = self._fast, None
        try:
            return self.dispatch(codes, quals, lens, rdids)
        finally:
            self._fast = saved

    def advance(self, handle, paired: bool = False):
        """Move a dispatched batch one stage forward (:1744-1755): for a
        two-pass handle, collect pass 1, route, and dispatch the pass-2
        bucket, so that pass 2 overlaps later batches' pass 1.  Other
        handles return unchanged."""
        if handle[0] == "2pass":
            return self._advance_two_pass(handle, paired)
        return handle

    def _route_two_pass(self, st) -> np.ndarray:
        """Read indices whose pass-1 answer is not final (:1761-1807):
        unaligned, imperfect and clipped, slot-saturated, overlapping a
        known ALT indel, or covering a splice-site boundary added since
        the pass-1 dispatch."""
        (has, best, bdirty, r_rd, r_lo, r_hi, sat, ver1, processed) = st
        sp = self.splice_params
        gapmin = min(sp.rd_gap_open + sp.rd_gap_ext,
                     sp.rf_gap_open + sp.rf_gap_ext)
        final = has & ((best >= 0)
                       | ((best > -gapmin) & ~bdirty))
        needs = ~final
        if sat is not None:
            needs |= sat
        if self._indel_bounds is not None and r_rd is not None:
            bnd = self._indel_bounds
            near = (np.searchsorted(bnd, r_hi + 1)
                    - np.searchsorted(bnd, r_lo - 1)) > 0
            needs[r_rd[near]] = True
        if self.splice_db is not None and r_rd is not None:
            since = ver1 if getattr(self._fast, "inject_ss", False) else 0
            bnd = self.splice_db.joined_boundaries(since=since)
            if bnd.size:
                near = (np.searchsorted(bnd, r_hi + 1)
                        - np.searchsorted(bnd, r_lo - 1)) > 0
                needs[r_rd[near]] = True
        needs &= ~processed
        return np.flatnonzero(needs)

    def _dispatch_sub(self, codes, quals, lens, rdids, sub):
        """Dispatch the routed subset through the full pass, padded to a
        power-of-two bucket (:1809-1828)."""
        B = codes.shape[0]
        L = codes.shape[1]
        Bs = max(256, B // 8)
        while Bs < sub.size:
            Bs *= 2
        Bs = min(Bs, B)
        n = sub.size
        sc_ = np.zeros((Bs, L), np.asarray(codes).dtype)
        sq_ = np.zeros((Bs, L), np.asarray(quals).dtype)
        sl_ = np.zeros(Bs, np.asarray(lens).dtype)
        sr_ = np.zeros(Bs, np.int64)
        sc_[:n] = np.asarray(codes)[sub]
        sq_[:n] = np.asarray(quals)[sub]
        sl_[:n] = np.asarray(lens)[sub]
        sr_[:n] = np.asarray(rdids)[sub]
        return self._dispatch_full(sc_, sq_, sl_, sr_)

    def _advance_two_pass(self, handle, paired: bool):
        """Collect pass 1, route, dispatch pass 2 (:1830-1870)."""
        _, h1, codes, quals, lens, rdids = handle
        ver1 = h1[6] if isinstance(h1, tuple) and len(h1) >= 7 else 0
        res1 = self._fast.collect(h1, paired=paired)
        B = res1.n_reads
        if rdids is None:
            rdids = np.arange(B, dtype=np.int64)
        # pass-1 summary per read: any alignment / best score / spans
        has = np.zeros(B, bool)
        best = np.full(B, -2 ** 40, np.int64)
        bdirty = np.zeros(B, bool)      # a best row is clipped/junctioned
        r_rd = r_lo = r_hi = None
        if res1.raw is not None and len(res1.raw["cols"][0]):
            c = res1.raw["cols"]
            r_rd = np.asarray(c[0])
            sc = np.asarray(c[8])
            has[r_rd] = True
            np.maximum.at(best, r_rd, sc)
            dirty = (np.asarray(c[5]) > 0) | (np.asarray(c[6]) > 0) \
                | (np.asarray(c[16]) != 0)
            isb = sc == best[r_rd]
            np.logical_or.at(bdirty, r_rd[isb & dirty], True)
            r_lo = np.asarray(c[4]) + np.asarray(c[5])      # aln_start
            r_hi = r_lo + np.asarray(c[7])                  # + aln_span
        # slot saturation (lite tier): reads whose placement pool exceeded
        # the lite caps re-run through the full pass
        sat = None
        if res1.lanes is not None and "h_sat" in res1.lanes:
            v = np.asarray(res1.lanes["h_sat"])
            cap = self._fast.lite_cap
            sat = (v[:B] > cap) | (v[B:2 * B] > cap)
        processed = np.zeros(B, bool)
        st = (has, best, bdirty, r_rd, r_lo, r_hi, sat, ver1, processed)
        sub = self._route_two_pass(st)
        h2 = None
        ver0 = self.splice_db.n_sites if self.splice_db else 0
        if sub.size:
            processed[sub] = True
            h2 = self._dispatch_sub(codes, quals, lens, rdids, sub)
        return ("2pass2", res1, h2, sub, st, ver0, codes, quals, lens,
                rdids)

    def _finish_two_pass(self, stage2, paired: bool) -> BatchResult:
        """Collect pass 2 and merge it into pass 1 (:1872-1891): with a
        splice-site DB that grew, re-route and re-run the new subset (at
        most three rounds)."""
        _, merged, h2, sub, st, ver0, codes, quals, lens, rdids = stage2
        B = merged.n_reads
        processed = st[-1]
        for _ in range(3):
            if h2 is None:
                break
            res2 = self.collect(h2, paired=paired)
            merged = self._merge_two_pass(merged, res2, sub, B)
            if self.splice_db is None or self.splice_db.n_sites == ver0:
                break   # no new sites -> the needs-set cannot grow
            ver0 = self.splice_db.n_sites
            sub = self._route_two_pass(st)
            h2 = None
            if sub.size:
                processed[sub] = True
                h2 = self._dispatch_sub(codes, quals, lens, rdids, sub)
        return merged

    def _merge_two_pass(self, res1, res2, sub, B):
        """Replace subset reads' rows/metadata in res1 with res2's
        (:1893-1939)."""
        subset = np.zeros(B, bool)
        subset[sub] = True
        cols1 = (res1.raw["cols"] if res1.raw is not None else None)
        cols2 = (res2.raw["cols"] if res2.raw is not None else None)
        parts = []
        if cols1 is not None and len(cols1[0]):
            rd1 = np.asarray(cols1[0])
            keep = ~subset[rd1]
            parts.append([np.asarray(c)[keep] for c in cols1])
        if cols2 is not None and len(cols2[0]):
            rd2 = np.asarray(cols2[0])
            live = rd2 < len(sub)          # padded lanes have no rows
            remap = sub[rd2[live]]
            p2 = [np.asarray(c)[live] for c in cols2]
            p2[0] = remap
            parts.append(p2)
        if parts:
            ncol = len(parts[0])
            cols = [np.concatenate([p[j] for p in parts])
                    for j in range(ncol)]
            order = np.argsort(cols[0], kind="stable")
            cols = [c[order] for c in cols]
            raw = {"cols": cols}
        else:
            raw = None
        orient = res1.orient_ranks
        if orient is not None and res2.orient_ranks is not None:
            orient = np.array(orient)
            orient[sub] = np.array(res2.orient_ranks)[:sub.size]
        lanes = res1.lanes
        if lanes is not None and res2.lanes is not None:
            lanes = {k: (np.array(v) if hasattr(v, "shape") else v)
                     for k, v in lanes.items()}
            Bs = res2.n_reads
            for k, v2 in res2.lanes.items():
                v1 = lanes.get(k)
                if v1 is None or not hasattr(v2, "shape"):
                    continue
                v2 = np.asarray(v2)
                if v2.shape[0] == 2 * Bs and v1.shape[0] == 2 * B:
                    v1[sub] = v2[:sub.size]
                    v1[B + sub] = v2[Bs:Bs + sub.size]
                    lanes[k] = v1
        return BatchResult(n_reads=B, lanes=lanes, orient_ranks=orient,
                           raw=raw)

    # ------------------------------------------------------------------
    def rescue_mates(self, codes, quals, lens, anchors, rc_flags,
                     maxins: int):
        """Anchored mate rescue (alignMate equivalent; pipeline.py:
        1449-1565): align each mate in the 57,344 bp local-index window
        holding its partner's position.  codes/quals [R, L] in the
        ORIGINAL read orientation; rc_flags marks mates whose expected
        strand is reverse-complement.  Returns list[list[Alignment]] with
        read_idx = job index.  The device work is ops/rescue.py:
        rescue_candidates on chunks of at most 128 jobs, padded to a power
        of two as in the JAX package.

        On a sharded index, as in the JAX package (:1472-1480): the
        windows start at global joined positions and are read from shard
        0's words (self.dev) up to the global n, so a window on shard 1
        or later reads past those words (ops/rank.py:clamp_words).  A
        sharded graph index is refused: JAX fails there."""
        R, L = codes.shape
        if R == 0:
            return []
        if self.graph is not None and len(self.shards) > 1:
            raise NotImplementedError(SHARDED_GRAPH_RESCUE)
        WIN_IVAL, WIN_LEN = 56320, 57344
        CHUNK = 128
        Rp = min(CHUNK, 1 << (max(R - 1, 1)).bit_length())
        # orient reads to the expected strand on host
        oc = codes.astype(np.int32).copy()
        oq = quals.astype(np.int32).copy()
        for i in np.flatnonzero(rc_flags):
            Lr = int(lens[i])
            seq = oc[i, :Lr]
            oc[i, :Lr] = np.where(seq < 4, 3 - seq, 4)[::-1]
            oq[i, :Lr] = oq[i, :Lr][::-1]
        ws_all = (np.asarray(anchors, np.int64) // WIN_IVAL) * WIN_IVAL
        snv = self.graph is not None
        fields = ("score", "clip_l", "clip_r", "n_mm", "n_n", "ok")
        starts_l, parts = [], {f: [] for f in fields}
        for c0 in range(0, R, Rp):
            c1 = min(c0 + Rp, R)
            ocp = np.full((Rp, L), 4, np.int32)
            oqp = np.zeros((Rp, L), np.int32)
            olp = np.ones(Rp, np.int32)
            owp = np.zeros(Rp, np.int32)
            ocp[:c1 - c0] = oc[c0:c1]
            oqp[:c1 - c0] = oq[c0:c1]
            olp[:c1 - c0] = lens[c0:c1]
            owp[:c1 - c0] = ws_all[c0:c1]
            rd, qd, ld, wd = (torch.from_numpy(a).to(self.dev.device)
                              for a in (ocp, oqp, olp, owp))
            params = self._params_on(self.dev.device)[0]
            kw = dict(ref_words=self.dev.ref_words, n_text=self.meta.n,
                      reads=rd, quals=qd, lens=ld, win_start=wd, W=WIN_LEN,
                      mm_pen=params["mm_pen"],
                      clip_pen=params["clip_pen"],
                      n_pen=self.scoring.n_pen,
                      allow_softclip=not self.scoring.no_softclip,
                      snv_delta1=self.graph_dev["snv1"] if snv else None,
                      snv_delta2=self.graph_dev["snv2"] if snv else None)
            starts_d, ext = rescue_ops.rescue_candidates(**kw)
            m = c1 - c0
            starts_l.append(starts_d.cpu().numpy()[:m])
            for f in fields:
                parts[f].append(getattr(ext, f).cpu().numpy()[:m])
        starts = np.concatenate(starts_l)
        sc, clip_l, clip_r, n_mm, n_n, okm = (np.concatenate(parts[f])
                                              for f in fields)
        out = []
        nfr = len(self.frag_ref)
        for i in range(R):
            Lr = int(lens[i])
            minsc = self.scoring.min_score(Lr)
            recs = []
            seen = set()
            order = np.argsort(-sc[i], kind="stable")
            for t in order:
                if not okm[i, t] or sc[i, t] < minsc:
                    continue
                s = int(starts[i, t])
                if s in seen:
                    continue
                seen.add(s)
                astart = s + int(clip_l[i, t])
                span = Lr - int(clip_l[i, t]) - int(clip_r[i, t])
                f = min(max(int(np.searchsorted(
                    self.frag_joined, astart, "right")) - 1, 0), nfr - 1)
                if not (astart >= self.frag_joined[f]
                        and astart + span <= self.frag_joined[f + 1]):
                    continue
                recs.append(Alignment(
                    read_idx=i, rc=bool(rc_flags[i]),
                    ref_id=int(self.frag_ref[f]),
                    ref_pos=int(self.frag_off[f] + astart
                                - self.frag_joined[f]),
                    joined_pos=s, clip_l=int(clip_l[i, t]),
                    clip_r=int(clip_r[i, t]), aln_span=span,
                    score=int(sc[i, t]), n_mm=int(n_mm[i, t]),
                    n_n=int(n_n[i, t]), mapq=0, nh=1, secondary=False))
            if len(recs) >= 2:
                # other in-window placements surface as ZS (secbest)
                recs[0] = dataclasses.replace(recs[0], zs=recs[1].score)
                for t2 in range(1, len(recs)):
                    recs[t2] = dataclasses.replace(recs[t2],
                                                   zs=recs[0].score)
            # alignMate resolves a local segment only when nelt <= 5
            # (hi_aligner.h:4760): a mate matching the window more than
            # 5 times equally well is never rescued
            if recs:
                nbest = sum(1 for a in recs if a.score == recs[0].score)
                if nbest > 5:
                    recs = []
            out.append(recs)
        return out

    # ------------------------------------------------------------------
    def annotate_snps(self, a, rd_aligned):
        """(Zs:Z string, aligned-read offsets of SNV-matched columns)
        for one alignment on a graph index (pipeline.py:1568-1609)."""
        if self.graph is None:
            return None, ()
        g = self.graph
        entries = []
        snv_offs = []
        cl = a.clip_l
        L_al = len(rd_aligned)
        rd_len = L_al + cl + a.clip_r
        segs = [(diag + lo, lo - cl, hi - lo)
                for (lo, hi, diag) in a.segments(rd_len)[0]]
        for (jstart, off0, slen) in segs:
            if slen <= 0:
                continue
            lo = int(np.searchsorted(g.snv_joined, jstart))
            hi = int(np.searchsorted(g.snv_joined, jstart + slen))
            for t in range(lo, hi):
                off = off0 + int(g.snv_joined[t]) - jstart
                if 0 <= off < L_al and rd_aligned[off] == g.snv_alt[t]:
                    entries.append(
                        (off, "S",
                         self.variants.snp_names[int(g.snv_id[t])]))
                    snv_offs.append(off)
        if a.junc_kind in (2, 3) and a.junc_known and a.junc_snp >= 0:
            ch = "D" if a.junc_kind == 2 else "I"
            entries.append((a.junc_x - cl, ch,
                            self.variants.snp_names[a.junc_snp]))
        if not entries:
            return None, tuple(snv_offs)
        entries.sort()
        parts, prev = [], -1
        for o, ch, nm in entries:
            parts.append(f"{o - prev - 1}|{ch}|{nm}")
            prev = o
        return ",".join(parts), tuple(snv_offs)

    def align_batch(self, codes: np.ndarray, quals: np.ndarray,
                    lens: np.ndarray, rdids: np.ndarray = None,
                    paired: bool = False) -> BatchResult:
        """Align one padded batch.  On device OOM the batch is halved and
        the halves' rows merged (pipeline.py:1625-1649)."""
        try:
            return self.collect(self.dispatch(codes, quals, lens, rdids),
                                paired=paired)
        except torch.cuda.OutOfMemoryError:
            if codes.shape[0] < 2 or paired:
                raise
            B = codes.shape[0]
            h = B // 2
            print(f"warning: device OOM on a {B}-read batch; retrying "
                  f"as two halves", file=sys.stderr)
            torch.cuda.empty_cache()
            if rdids is None:
                rdids = np.arange(B, dtype=np.int64)
            r1 = self.align_batch(codes[:h], quals[:h], lens[:h], rdids[:h])
            r2 = self.align_batch(codes[h:], quals[h:], lens[h:], rdids[h:])
            cols = []
            for c1, c2 in zip(r1.raw["cols"], r2.raw["cols"]):
                cols.append(np.concatenate([np.asarray(c1),
                                            np.asarray(c2).copy()]))
            cols[0][len(r1.raw["cols"][0]):] += h
            return BatchResult(n_reads=B, raw={"cols": cols})
