"""GBWT (graph FM / GCSA) construction for graph `.ht2` export.

Build-time, host-side component: constructs the prefix-sorted path
automaton (Siren et al. 2014) of a reference genome + small variants,
producing the edge-BWT streams (`gbwt chars`, F/M bitvectors, node
positions) that `ht2_write.export_ht2` serializes byte-compatibly with
`hisat2-build-s --snp/--ss`.

Behavioral contract (all citations into the hisat2 sources):
  - automaton shape: RefGraph ctor + buildGraph_worker
    (gbwt_graph.h:362-814, 866-1270): Y head, per-joined-position
    backbone, Z tail, one sub-path per haplotype (SGL/DEL/INS walks),
    exon-skip edges per non-excluded splice site.
  - reverse determinization: subset construction from Z over reversed
    edges, composite value = max of member values
    (gbwt_graph.h:191, impl ~1290-1480).
  - prefix sorting: doubling generations with pruning/merging
    (gbwt_graph.h makeFromRef/generationOne/earlyGeneration/
    firstPruneGeneration/lateGeneration/mergeUpdateRank).
  - final streams: generateEdges + nextRow/nextFLocation
    (gbwt_graph.h:1605-1753, 2339-2620).

The implementation below is an original numpy derivation of that
contract: the final structure is canonical given the automaton (every
sort key is intrinsic — path-label ranks, genome positions, labels), so
none of the reference's threading/chunking machinery is replicated.
Node ids here are arbitrary; only labels, values and the edge relation
matter.

Copied verbatim from hisat2_tpu/index/gbwt.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np

INDEX_MAX = np.uint32(0xFFFFFFFF)
# label codes: 0-3 = ACGT, 4 = Y (head), 5 = Z (tail)
LAB_Y = 4
LAB_Z = 5


class Automaton:
    """labels: int8 [N]; values: int64 [N] (-1 == INDEX_MAX);
    edges: int64 [E, 2] (from, to); last: index of the Z node."""

    def __init__(self, labels, values, edges, last):
        self.labels = np.asarray(labels, np.int8)
        self.values = np.asarray(values, np.int64)
        self.edges = np.asarray(edges, np.int64).reshape(-1, 2)
        self.last = int(last)


def default_haplotypes(alts):
    """One haplotype per SNP when no .haplotype file is given
    (gfm.h:1546-1560)."""
    haps = []
    for a, alt in enumerate(alts):
        t = alt["type"]
        if t not in ("single", "deletion", "insertion"):
            continue
        pos = alt["pos"]
        right = pos + alt["len"] - 1 if t == "deletion" else pos
        haps.append({"left": pos, "right": right, "alts": [a]})
    return haps


def build_automaton(joined: np.ndarray, alts, haplotypes) -> Automaton:
    """The variation automaton over the joined (N-free) genome.

    alts: list of dicts {type: single|deletion|insertion|splicesite,
    pos, len, seq (int codes for single/insertion), left, right,
    excluded} with positions in joined space, SORTED by the reference's
    ALT ordering.  haplotypes: [{left, right, alts: [alt idx]}] sorted.
    Semantics follow buildGraph_worker (gbwt_graph.h:920-1140) with a
    single chunk — chunking exists there for memory locality only and
    does not change the (isomorphism class of the) automaton.
    """
    jlen = len(joined)
    n_backbone = jlen + 2                     # Y + jlen + Z
    labels = [np.empty(n_backbone, np.int8)]
    values = [np.empty(n_backbone, np.int64)]
    labels[0][0] = LAB_Y
    values[0][0] = 0
    labels[0][1:jlen + 1] = joined
    values[0][1:jlen + 1] = np.arange(jlen)
    labels[0][jlen + 1] = LAB_Z
    values[0][jlen + 1] = jlen
    last = jlen + 1
    e_from = [np.arange(0, jlen + 1, dtype=np.int64)]
    e_to = [np.arange(1, jlen + 2, dtype=np.int64)]
    nn = n_backbone

    ex_labels, ex_values = [], []

    def new_node(lab, val):
        nonlocal nn
        ex_labels.append(lab)
        ex_values.append(val)
        nn += 1
        return nn - 1

    ef, et = [], []
    # haplotype walks (gbwt_graph.h:949-1097).  backbone node for joined
    # position j is j + 1.
    for hap in haplotypes:
        snp_ids = hap["alts"]
        # consistency filter (gbwt_graph.h:956-991)
        ok = True
        for s in range(len(snp_ids) - 1):
            a1, a2 = alts[snp_ids[s]], alts[snp_ids[s + 1]]
            if a1["type"] == "insertion":
                if a1["pos"] > a2["pos"]:
                    ok = False
            elif a1["type"] == "deletion":
                if a2["type"] == "deletion":
                    if a1["pos"] + a1["len"] >= a2["pos"]:
                        ok = False
                elif a1["pos"] + a1["len"] - 1 >= a2["pos"]:
                    ok = False
            elif a1["pos"] >= a2["pos"]:
                ok = False
            if not ok:
                break
        if not ok:
            continue
        prev_type = None          # None | "single" | "deletion" | "ins"
        id_i = 0
        j = hap["left"]
        pend_del_from = None      # open deletion edge waiting for target
        while j <= hap["right"]:
            alt = alts[snp_ids[id_i]] if id_i < len(snp_ids) else None
            if alt is not None and alt["pos"] == j \
                    and not (prev_type == "ins" and False):
                t = alt["type"]
                if t == "single":
                    nid = new_node(int(alt["seq"][0]), alt["pos"])
                    if prev_type != "deletion":
                        ef.append(alt["pos"] if j == hap["left"]
                                  else nid - 1)
                        et.append(nid)
                    else:
                        et[pend_del_from] = nid
                        pend_del_from = None
                    if j == hap["right"]:
                        ef.append(nid)
                        et.append(alt["pos"] + 2)
                    id_i += 1
                    prev_type = "single"
                    j += 1
                elif t == "deletion":
                    ef.append(alt["pos"] if j == hap["left"]
                              else nn - 1)
                    et.append(-1)             # patched below
                    pend_del_from = len(et) - 1
                    j += alt["len"]
                    if j - 1 == hap["right"]:
                        et[pend_del_from] = alt["pos"] + alt["len"] + 1
                        pend_del_from = None
                    id_i += 1
                    prev_type = "deletion"
                    j += 0 if j <= hap["right"] else 0
                    if prev_type == "deletion" and pend_del_from is None \
                            and j > hap["right"]:
                        pass
                    if j <= hap["right"]:
                        continue
                    else:
                        break
                else:                          # insertion
                    seq = alt["seq"]
                    first_new = None
                    for k, bp in enumerate(seq):
                        nid = new_node(int(bp), -1)
                        if first_new is None:
                            first_new = nid
                        if prev_type == "deletion" and k == 0:
                            et[pend_del_from] = nid
                            pend_del_from = None
                            continue
                        ef.append(alt["pos"] if (k == 0
                                                 and j == hap["left"])
                                  else nid - 1)
                        et.append(nid)
                    if j == hap["right"]:
                        ef.append(nn - 1)
                        et.append(alt["pos"] + 1)
                    id_i += 1
                    prev_type = "ins"
                    # insertion does not consume a reference position
                    # (the worker decrements j next loop — net zero);
                    # but it must not loop forever: the reference's
                    # `if(prev_ALT_type == ALT_SNP_INS) j--` pairs with
                    # the outer j++ — an insertion at hap.right==pos
                    # ends the walk via the edge above
                    if j == hap["right"] and id_i >= len(snp_ids):
                        break
            else:
                nid = new_node(int(joined[j]), j)
                if prev_type != "deletion":
                    ef.append(j if (j == hap["left"]
                                    and prev_type is None) else nid - 1)
                    et.append(nid)
                else:
                    et[pend_del_from] = nid
                    pend_del_from = None
                if j == hap["right"]:
                    ef.append(nid)
                    et.append(j + 2)
                prev_type = "single"
                j += 1

    # splice-site skip edges (gbwt_graph.h:1100-1115): from the last
    # exonic node (left-1 backbone = node `left`) to the first exonic
    # node (right+1 backbone = node `right+2`)
    for alt in alts:
        if alt["type"] != "splicesite" or alt.get("excluded"):
            continue
        ef.append(alt["left"])
        et.append(alt["right"] + 2)

    if ex_labels:
        labels.append(np.asarray(ex_labels, np.int8))
        values.append(np.asarray(ex_values, np.int64))
    if ef:
        e_from.append(np.asarray(ef, np.int64))
        e_to.append(np.asarray(et, np.int64))
    lab = np.concatenate(labels)
    val = np.concatenate(values)
    edges = np.stack([np.concatenate(e_from), np.concatenate(e_to)], 1)
    assert (edges[:, 1] >= 0).all(), "unpatched deletion edge"
    return Automaton(lab, val, edges, last)


def is_reverse_deterministic(auto: Automaton) -> bool:
    """No node has two in-edges from equal-labeled sources
    (gbwt_graph.h:1272-1310)."""
    key = auto.edges[:, 1] * 8 + auto.labels[auto.edges[:, 0]]
    return len(np.unique(key)) == len(key) or \
        len(np.unique(key)) == len(np.unique(
            auto.edges[:, 1] * 8 + auto.labels[auto.edges[:, 0]]))


def _rev_det_needed(auto: Automaton) -> bool:
    key = (auto.edges[:, 1].astype(np.int64) * 8
           + auto.labels[auto.edges[:, 0]])
    return len(np.unique(key)) != len(key)


def reverse_determinize(auto: Automaton) -> Automaton:
    """Reverse subset construction from Z (gbwt_graph.h:1290-1480):
    composite node = the set of same-labeled predecessors of an
    existing composite; value = max member value (ignoring -1);
    dedup by exact member set."""
    lab, val, edges = auto.labels, auto.values, auto.edges
    # in-edge CSR by target
    order = np.argsort(edges[:, 1], kind="stable")
    e_by_to = edges[order]
    starts = np.searchsorted(e_by_to[:, 1], np.arange(len(lab)))
    ends = np.searchsorted(e_by_to[:, 1], np.arange(len(lab)) + 1)

    cn_label = [int(lab[auto.last])]
    cn_value = [int(val[auto.last])]
    cn_members = [(auto.last,)]
    cmap = {(auto.last,): 0}
    cedges = []                   # (pred_cnode, cnode)
    first_node = -1
    from collections import deque
    q = deque([0])
    while q:
        ci = q.popleft()
        preds = []
        for m in cn_members[ci]:
            preds.extend(e_by_to[starts[m]:ends[m], 0].tolist())
        if not preds:
            continue
        preds = sorted(set(preds))
        # group by label, stable in id order
        preds.sort(key=lambda n: lab[n])
        i = 0
        while i < len(preds):
            j = i + 1
            while j < len(preds) and lab[preds[j]] == lab[preds[i]]:
                j += 1
            mem = tuple(preds[i:j])
            vs = [int(val[m]) for m in mem if val[m] != -1]
            cv = max(vs) if vs else -1
            ex = cmap.get(mem)
            if ex is None:
                cmap[mem] = ex = len(cn_members)
                cn_members.append(mem)
                cn_label.append(int(lab[mem[0]]))
                cn_value.append(cv)
                q.append(ex)
                if lab[mem[0]] == LAB_Y and first_node < 0:
                    first_node = ex
            cedges.append((ex, ci))
            i = j
    cedges = np.asarray(sorted(set(cedges)), np.int64)
    n = len(cn_members)
    labels = np.asarray(cn_label, np.int8)
    values = np.asarray(cn_value, np.int64)
    zi = int(np.flatnonzero(labels == LAB_Z)[0])
    return Automaton(labels, values, cedges, zi), first_node


def prefix_sort(auto: Automaton):
    """Prefix-doubling sort of the path automaton.

    Returns (node_from, node_rank_order_count) where node_from[i] is the
    automaton node of the i-th path node in final (unique) rank order.
    Implements makeFromRef + generations 1..n + the pruning/merging
    rules (gbwt_graph.h:1806-2100, 2226-2330)."""
    lab, edges, last = auto.labels, auto.edges, auto.last
    # initial path nodes: one per edge, key = label class of FROM node
    # (A..T -> 0..3, Y -> 4); plus the Z self node with key 5
    pfrom = np.concatenate([edges[:, 0], [last]])
    pto = np.concatenate([edges[:, 1], [last]])
    key1 = np.concatenate([lab[edges[:, 0]].astype(np.int64), [LAB_Z]])
    # sorted flag: none yet
    srt = np.zeros(len(pfrom), bool)
    kf, ks = key1, np.zeros_like(key1)

    max_from = len(lab)

    def join(pf, pt, pkf, psrt, pks):
        """One doubling step: unsorted node (f, t, k) x node (t, t2, k2)
        -> (f, t2, (k, k2)).  Sorted nodes pass through."""
        o = np.argsort(pf, kind="stable")
        sf, st_, skf = pf[o], pt[o], pkf[o]
        cstart = np.searchsorted(sf, np.arange(max_from))
        cend = np.searchsorted(sf, np.arange(max_from) + 1)
        keep = psrt
        exp = ~psrt
        ei = np.flatnonzero(exp)
        tgt = pt[ei]
        cnt = cend[tgt] - cstart[tgt]
        rep = np.repeat(ei, cnt)
        # successor slots: CSR expansion
        offs = np.concatenate([[0], np.cumsum(cnt)])[:-1]
        pos = np.arange(int(cnt.sum())) - np.repeat(offs, cnt)
        succ = np.repeat(cstart[tgt], cnt) + pos
        nf = np.concatenate([pf[keep], pf[rep]])
        nt = np.concatenate([pt[keep], st_[succ]])
        nkf = np.concatenate([pkf[keep], pkf[rep]])
        nks = np.concatenate([pks[keep], skf[succ]])
        nsrt = np.concatenate([np.ones(int(keep.sum()), bool),
                               np.zeros(len(rep), bool)])
        return nf, nt, nkf, nks, nsrt

    # generations 1-3: pack key pairs into key.first, no pruning
    for gen in (1, 2, 3):
        shift = 3 * (1 << (gen - 1))
        pf, pt, nkf, nks, _ = join(pfrom, pto, kf, srt, ks)
        kf = (nkf << shift) + nks
        ks = np.zeros_like(kf)
        pfrom, pto = pf, pt
        srt = np.zeros(len(pfrom), bool)

    # generation 4: pair keys, sort, nextMaximalSet merge, mark sorted,
    # re-rank (firstPruneGeneration + mergeUpdateRank gen==4)
    pf, pt, nkf, nks, _ = join(pfrom, pto, kf, srt, ks)
    o = np.lexsort((nks, nkf))
    pf, pt, kf, ks = pf[o], pt[o], nkf[o], nks[o]
    pf, pt, kf, ks, srt, ranks = _gen4_merge(pf, pt, kf, ks)

    # generations 5+: join unsorted, merge, until all ranks unique
    gen = 4
    while ranks != len(pf):
        gen += 1
        if gen > 64:
            raise RuntimeError("prefix sort failed to converge")
        pf, pt, nkf, nks, nsrt = join(pf, pt, kf, srt, ks)
        # output is sorted by key.first except within expansions: the
        # reference relies on input rank order; restore with a stable
        # lexsort on key.first only (ties keep creation order)
        o = np.argsort(nkf, kind="stable")
        pf, pt, kf, ks, srt = pf[o], pt[o], nkf[o], nks[o], nsrt[o]
        pf, pt, kf, ks, srt, ranks = _late_merge(pf, pt, kf, ks, srt)
    # final: nodes in rank order (kf holds unique ranks 0..n-1 already
    # in sorted order)
    o = np.argsort(kf, kind="stable")
    return pf[o], pt[o]


def _gen4_merge(pf, pt, kf, ks):
    """mergeUpdateRank, generation == 4 (gbwt_graph.h:2226-2268) +
    nextMaximalSet (gbwt_graph.h:2300-2330)."""
    n = len(pf)
    keep = np.ones(n, bool)
    # nextMaximalSet walk
    i = 0
    kfs = kf
    while i < n:
        # if previous node shares the key -> single, not merged
        if i > 0 and kf[i - 1] == kf[i] and ks[i - 1] == ks[i]:
            i += 1
            continue
        second = i + 1
        j = i + 1
        while j < n:
            if kf[j - 1] != kf[j] or ks[j - 1] != ks[j]:
                second = j
            if pf[j] != pf[i]:
                break
            j += 1
        else:
            second = n
            j = n
        if j >= n:
            second = n
        # keep nodes[i], drop (i, second)
        keep[i + 1:second] = False
        i = second if second > i else i + 1
    pf, pt, kf, ks = pf[keep], pt[keep], kf[keep], ks[keep]
    n = len(pf)
    # sorted flags: unique (kf, ks) among neighbors
    same_prev = np.zeros(n, bool)
    same_prev[1:] = (kf[1:] == kf[:-1]) & (ks[1:] == ks[:-1])
    same_next = np.zeros(n, bool)
    same_next[:-1] = same_prev[1:]
    srt = ~(same_prev | same_next)
    # re-rank by distinct (kf, ks)
    newkey = np.zeros(n, np.int64)
    newkey[1:] = np.cumsum(~same_prev[1:])
    ranks = int(newkey[-1]) + 1 if n else 0
    # sorted flag is carried in `to` in the reference; keep a bool here
    return pf, pt, newkey, np.zeros(n, np.int64), srt, ranks


def _late_merge(pf, pt, kf, ks, srt):
    """mergeUpdateRank, generation > 4 (gbwt_graph.h:2268-2299).

    Nodes enter sorted by kf (stable).  Per maximal same-kf block:
      - single node: keep, assign next rank (sorted flag unchanged)
      - multi: sort by ks; per (kf, ks) group: if all share `from`
        merge to one node marked sorted (dropped entirely if the
        previously kept node is sorted with the same from); else keep
        all with one shared rank (unsorted).
      After a multi block, a following single-node block whose from
      matches a sorted previously-kept node is absorbed (dropped).
    """
    n = len(pf)
    out_f, out_t, out_k, out_s = [], [], [], []
    ranks = 0
    bounds = np.flatnonzero(np.diff(kf, prepend=np.int64(-2 ** 62)))
    bounds = np.append(bounds, n)
    bi = 0
    absorb_check = False          # single right after unsorted cluster
    while bi < len(bounds) - 1:
        s, e = int(bounds[bi]), int(bounds[bi + 1])
        if e - s == 1:
            if absorb_check and out_s and out_s[-1] \
                    and out_f[-1] == pf[s]:
                bi += 1
                absorb_check = False
                continue
            out_f.append(pf[s])
            out_t.append(pt[s])
            out_k.append(ranks)
            out_s.append(bool(srt[s]))
            ranks += 1
            absorb_check = False
            bi += 1
            continue
        # multi block
        o = s + np.argsort(ks[s:e], kind="stable")
        bf, bt, bks, bsr = pf[o], pt[o], ks[o], srt[o]
        i = 0
        while i < e - s:
            j = i + 1
            while j < e - s and bks[j] == bks[i]:
                j += 1
            mergeable = (bf[i:j] == bf[i]).all()
            if not mergeable:
                for t in range(i, j):
                    out_f.append(bf[t])
                    out_t.append(bt[t])
                    out_k.append(ranks)
                    out_s.append(False)
                ranks += 1
            else:
                if out_s and out_s[-1] and out_f[-1] == bf[i]:
                    pass          # absorbed into previous sorted node
                else:
                    out_f.append(bf[i])
                    out_t.append(bt[i])
                    out_k.append(ranks)
                    out_s.append(True)
                    ranks += 1
            i = j
        # the node immediately following ANY multi block is absorbed
        # when it is a single-key node and the block's last kept node
        # is sorted with the same from (gbwt_graph.h:2278-2296)
        absorb_check = True
        bi += 1
    pf2 = np.asarray(out_f, np.int64)
    pt2 = np.asarray(out_t, np.int64)
    kf2 = np.asarray(out_k, np.int64)
    srt2 = np.asarray(out_s, bool)
    return pf2, pt2, kf2, np.zeros(len(pf2), np.int64), srt2, ranks


def gbwt_streams(auto: Automaton, node_from: np.ndarray):
    """Final GBWT row streams from the sorted path nodes.

    node_from: automaton node id of each path node, in rank order.
    Returns dict with:
      bwt:   int8 [rows]  char codes 0-3, 5 for Z rows
      F:     uint8 [rows] first-in-edge marks
      M:     uint8 [rows] unary out-degree stream (per node)
      pos:   int64 [num_nodes] genome position per node (M-domain)
      outdeg:int64 [num_nodes]
    following generateEdges + nextRow (gbwt_graph.h:2339-2620,
    1605-1635), including the Y/Z merge."""
    lab, val, edges = auto.labels, auto.values, auto.edges
    nn = len(node_from)
    # path nodes of each automaton node, in rank order
    order_by_from = np.argsort(node_from, kind="stable")
    nf_sorted = node_from[order_by_from]
    cstart = np.searchsorted(nf_sorted, np.arange(len(lab)))
    cend = np.searchsorted(nf_sorted, np.arange(len(lab)) + 1)
    # path edges: ref edge (u, v) x path node p (from == v):
    #   (label(u), rank(p), u)
    u, v = edges[:, 0], edges[:, 1]
    cnt = cend[v] - cstart[v]
    rep_u = np.repeat(u, cnt)
    offs = np.concatenate([[0], np.cumsum(cnt)])[:-1]
    pos_in = np.arange(int(cnt.sum())) - np.repeat(offs, cnt)
    p_idx = order_by_from[np.repeat(cstart[v], cnt) + pos_in]
    e_label = lab[rep_u].astype(np.int64)
    e_rank = p_idx.astype(np.int64)

    # out-degree per path node: match same-from edge runs to same-from
    # path nodes by occurrence order (PROCESS EDGES two-pointer,
    # gbwt_graph.h:2484-2496).  Edges sorted by (label, rank) == source
    # path node rank order; runs of equal `from` in that order pair
    # with the node list in rank order.
    eo = np.lexsort((e_rank, e_label))
    ef_s = rep_u[eo]
    # run boundaries
    if len(ef_s):
        newrun = np.ones(len(ef_s), bool)
        newrun[1:] = ef_s[1:] != ef_s[:-1]
        run_id = np.cumsum(newrun) - 1
        run_from = ef_s[newrun]
        run_len = np.bincount(run_id)
        # occurrence index of each run among runs with same from
        ro = np.argsort(run_from, kind="stable")
        rocc = np.zeros(len(run_from), np.int64)
        rf_s = run_from[ro]
        first = np.ones(len(rf_s), bool)
        first[1:] = rf_s[1:] != rf_s[:-1]
        grp = np.cumsum(first) - 1
        startpos = np.zeros(len(rf_s), np.int64)
        startpos[first] = np.arange(len(rf_s))[first]
        startpos = startpos[np.maximum.accumulate(
            np.where(first, np.arange(len(rf_s)), 0))]
        rocc[ro] = np.arange(len(rf_s)) - startpos
    else:
        run_from = np.zeros(0, np.int64)
        run_len = np.zeros(0, np.int64)
        rocc = np.zeros(0, np.int64)
    # occurrence index of each path node among same-from (rank order)
    nocc = np.zeros(nn, np.int64)
    nf2 = node_from[order_by_from]
    firstn = np.ones(nn, bool)
    firstn[1:] = nf2[1:] != nf2[:-1]
    startn = np.zeros(nn, np.int64)
    startn[firstn] = np.arange(nn)[firstn]
    startn = np.maximum.accumulate(np.where(firstn, startn, 0))
    occ_sorted = np.arange(nn) - startn
    nocc[order_by_from] = occ_sorted
    outdeg = np.zeros(nn, np.int64)
    # map (from, occ) -> node rank
    key_node = node_from * (nn + 1) + nocc
    key_run = run_from * (nn + 1) + rocc
    ksort = np.argsort(key_node, kind="stable")
    pos_run = np.searchsorted(key_node[ksort], key_run)
    tgt_node = ksort[np.minimum(pos_run, nn - 1)]
    okm = key_node[tgt_node] == key_run
    outdeg[tgt_node[okm]] = run_len[okm]

    node_pos = val[node_from].copy()

    # ---- Remove-Y merge (gbwt_graph.h:2500-2520) ----
    # rank order ends ...,[Y-node],[Z-node]; Z takes Y's outdeg and
    # slot; 'Y'-labeled rows become 'Z'; ranks above Y's slot shift -1.
    assert lab[node_from[-1]] == LAB_Z and lab[node_from[-2]] == LAB_Y
    outdeg[nn - 2] = outdeg[nn - 2]  # Y slot keeps its outdeg
    # Z node's pos/from move into Y's slot
    node_pos[nn - 2] = node_pos[nn - 1]
    zrank_old = nn - 1
    keep_nodes = np.arange(nn - 1)
    outdeg2 = outdeg[keep_nodes]
    node_pos2 = node_pos[keep_nodes]
    e_label2 = np.where(e_label == LAB_Y, np.int64(LAB_Z), e_label)
    e_rank2 = np.where(e_rank >= zrank_old, e_rank - 1, e_rank)
    nn2 = nn - 1

    # final in-edge order: sort by (target rank, source path-node rank).
    # PathEdgeToCmp sorts by (to=ranking, from); from at that point is
    # the source path-node index in rank order, which equals the
    # (label, ranking) sort position — reuse it as tiebreaker.
    src_order = np.lexsort((e_rank, e_label2))
    src_rank_of_edge = np.empty(len(e_rank2), np.int64)
    src_rank_of_edge[src_order] = np.arange(len(e_rank2))
    fo = np.lexsort((src_rank_of_edge, e_rank2))
    bwt = e_label2[fo].astype(np.int8)
    tgt = e_rank2[fo]
    F = np.zeros(len(bwt), np.uint8)
    if len(bwt):
        F[0] = 1
        F[1:] = (tgt[1:] != tgt[:-1]).astype(np.uint8)
    # M stream: per node, 1 followed by outdeg-1 zeros; nodes with
    # outdeg 0 contribute nothing (cannot happen after the Y/Z merge:
    # every node has at least one out-edge)
    assert (outdeg2 > 0).all(), "zero out-degree node after Y/Z merge"
    M = np.zeros(int(outdeg2.sum()), np.uint8)
    M[np.concatenate([[0], np.cumsum(outdeg2)[:-1]])] = 1
    assert len(M) == len(bwt)
    in_deg = np.bincount(tgt, minlength=nn2)
    assert (in_deg > 0).all()
    return {"bwt": bwt, "F": F, "M": M, "pos": node_pos2,
            "outdeg": outdeg2, "num_nodes": nn2}


def build_gbwt(joined: np.ndarray, alts, haplotypes=None):
    """Full pipeline: automaton -> (determinize) -> prefix sort ->
    streams.  Returns the gbwt_streams dict."""
    if haplotypes is None:
        haplotypes = default_haplotypes(alts)
    auto = build_automaton(joined, alts, haplotypes)
    if _rev_det_needed(auto):
        auto, _ = reverse_determinize(auto)
    node_from, _ = prefix_sort(auto)
    return gbwt_streams(auto, node_from)
