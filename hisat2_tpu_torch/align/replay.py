"""Interleaved-search give-up replay (reference: HI_Aligner::go /
nextBWT, hi_aligner.h:3874-4078).

The reference searches the four (mate, orientation) lanes of a pair round
by round, always picking the lane with the best `searchScore` (sum of
squared hit lengths minus heavy penalties per non-unique round,
hi_aligner.h:318-330).  A lane's `align()` runs once, when the lane
completes (anchor stop or read exhausted).  Three couplings make paired
give-up behavior differ from running each mate alone:

  * go() breaks when BOTH mates' most recent align() calls returned
    false (`if(!found[0] && !found[1]) break;`) — a junk mate's failures
    can abort the other mate's remaining orientations;
  * the budget gate (numActualPartialSearch > maxmm + spliced + 1 once
    the mate has an alignment) marks a lane done WITHOUT aligning it, and
    ends the whole search when the other mate is aligned and a concordant
    pair exists (hi_aligner.h:3993-4027);
  * the sibling gate: once a mate's opposite orientation finished
    without producing an alignment, a lane whose non-unique round count
    exceeds the sibling's total + 1 aborts the WHOLE search
    (hi_aligner.h:4030-4036).

The device search runs all lanes to completion and logs every round
(length, uniqueness); this module replays the reference's interleaving
over those logs and reports which lanes the reference would actually
have completed — alignments from other lanes are discarded.

Copied verbatim from hisat2_tpu/align/replay.py; only the imports are
rewritten, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations


def decode_rounds(words, n):
    """Unpack the byte-packed per-round log: [(len, uniq)] * n."""
    out = []
    for t in range(int(n)):
        b = (int(words[t >> 2]) >> ((t & 3) << 3)) & 0xFF
        out.append((b >> 1, b & 1))
    return out


class _Lane:
    __slots__ = ("rounds", "k", "na", "done", "verdict", "best", "nofw")

    def __init__(self, rounds, verdict, best):
        self.rounds = rounds       # [(len, uniq)]
        self.k = 0                 # rounds consumed
        self.na = 0                # non-unique rounds consumed
        self.done = not rounds     # empty lane: nothing to search
        self.verdict = verdict     # align() would return True
        self.best = best           # best reported score of this lane

    def search_score(self, min_k):
        s = 0
        for i in range(self.k):
            s += self.rounds[i][0] ** 2
        s -= self.na * min_k * min_k
        s -= 1 << min(2 * self.na, 62)
        return s


def replay_pair(lanes, minsc, mm_max: int, min_k: int, has_concord,
                paired: bool = True, spliced=(0, 0)):
    """lanes: [(rounds, verdict, best)] in the reference's iteration
    order (m1fw, m1rc, m2fw, m2rc) — or two entries for unpaired;
    minsc: per-mate minimum scores; has_concord(completed): callback.
    Returns the list of completed lane indices (alignments of other
    lanes must be dropped)."""
    L = [_Lane(*x) for x in lanes]
    n = len(L)
    mate_of = [0, 0, 1, 1][:n]
    sib = [1, 0, 3, 2][:n]
    best_unp = [-(1 << 40), -(1 << 40)]
    found = [True, paired]
    completed = []

    def pick():
        bi, bs = -1, None
        for i in range(n):
            if L[i].done:
                continue
            cs = (1 << 62) if L[i].k == 0 else L[i].search_score(min_k)
            if bs is None or cs > bs:
                bi, bs = i, cs
        return bi

    while True:
        i = pick()
        if i < 0:
            break                       # all lanes done: normal end
        ln = L[i]
        m = mate_of[i]
        # budget gate (hi_aligner.h:3993-4027)
        if best_unp[m] >= minsc[m]:
            maxmm = (-best_unp[m] + mm_max - 1) // mm_max
            if ln.na > maxmm + spliced[m] + 1:
                ln.done = True
                if paired:
                    om = 1 - m
                    if best_unp[om] >= minsc[om] and has_concord(completed):
                        return completed        # search over
                    continue
                return completed                # unpaired: search over
        # sibling gate (hi_aligner.h:4030-4036)
        so = L[sib[i]]
        if so.done and best_unp[m] < minsc[m] \
                and ln.na > so.na + 1:
            ln.done = True
            return completed                    # nextBWT false: search over
        # one partialSearch round
        rl, uq = ln.rounds[ln.k]
        ln.k += 1
        if not uq:
            ln.na += 1
        if ln.k == len(ln.rounds):
            ln.done = True
            # a lane completing with a FALSE align() verdict (minWidth >
            # kseeds*2 or no usable anchors) exits before hybridSearch:
            # it reports NOTHING, so it does not join the completed set
            if ln.verdict:
                completed.append(i)
            found[m] = ln.verdict
            if ln.verdict and ln.best >= minsc[m]:
                best_unp[m] = max(best_unp[m], ln.best)
            if not found[0] and not found[1]:
                return completed                # go() break
    return completed
