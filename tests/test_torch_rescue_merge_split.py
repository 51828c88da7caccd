"""K12's and K18's decompositions (hisat2_tpu_torch/csrc/rescue_window.cu,
merge_sites.cu), emulated in torch on the CPU and held against hisat2_tpu.

K12 runs a job's window as a Toeplitz product on the tensor cores: with
d = 16 i + j (j in [0, 16)) and u = j + t,
  matches[16 i + j] = sum_{u, c} A[j, (u, c)] B[(u, c), i],
A[j, (u, c)] = [read[u - j] == c] and B[(u, c), i] = [ref[ws + 16 i + u]
== c] (0 outside the text).  A unit is 896 diagonals (56 columns i, 7
tiles of 8); the read is cut into chunks of 104 chars, each an int8
product over 15 k-steps of 8 chars (the chunk and the 15 columns of its
band) whose int32 sums add across chunks.  Each count's key is a 16-bit
code of its bfloat16 rounding (the count below 256, else its bfloat16
bits less 0x4280) << 16 | (0xFFFF - its diagonal in the unit).  A block
(one warp) walks UPB consecutive units: the first unit's candidates are
its keys at or above the 8th largest of its 32 lanes' largest keys (tile
k holds the unit's columns 7 c + k, c < 8, and a lane rows j, j + 8 of
its columns 2 tq, 2 tq + 1), a later
unit's the keys whose code beats the block's 8th; the block keeps the top
8 of its list and the candidates, and the job's top 8 are among the
blocks' keys at or above the largest of their 8th keys.  A job whose read
has no ACGT column writes ws + 0..7.  `split_rescue` does exactly that and must
give hisat2_tpu.ops.rescue.rescue_candidates's starts bit for bit: windows
before the text's start and past its end, 150 and 300 bp reads (two and
three chunks; a count of 300, which bfloat16 rounds), the tie window of
a 120 bp unit planted 15 times, a padding job, and a window of 90 units
(the last one partial).

K18 folds the new rows into each sorted table set in one launch of
independent blocks.  Each table block ranks the new rows by (key, row
index) (the kernel sorts them; the rank is the all-pairs count
#{(key', idx') < (key, idx)}), sends each old row i of its range to i +
#{new keys < its key}, and each new row whose count #{old keys <= its
key} falls in its range (read with the key before the range) to that
count + its rank; rows at or past the capacity are dropped.  Each lob
block adds onto its range of lob the weights of the new bins below the
range (a sum) and inside it (a histogram and its exclusive scan); the
block ending at NB writes lob[NB].  `split_merge` does exactly that, at
the kernel's 2,048 rows and 4,096 bins a block and at smaller ranges (so
that the ownership of new rows crosses blocks), checks that every output
row is written once, and must give
hisat2_tpu.align.splice_db._merge_sorted_tabs's arrays bit for bit, with
and without the bucket index.

Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align import splice_db as j_sdb
from hisat2_tpu.ops import rescue as j_rescue
from hisat2_tpu_torch.ops import rank as rk
from hisat2_tpu_torch.utils.intops import u32_to_tensor

# K12's constants (csrc/rescue_window.cu)
J, UNIT, LC, KS, TOP = 16, 896, 104, 15, 8
# K18's (csrc/merge_sites.cu)
ROWS, BINS = 2048, 4096
SENT = 2 ** 31 - 2
N_TEXT = 130_000
SPOTS = [20000 + 18000 * i for i in range(6)]


def _pack(codes):
    n = len(codes)
    words = np.zeros((n + 15) // 16, np.uint32)
    np.bitwise_or.at(words, np.arange(n) // 16,
                     codes.astype(np.uint32) << (2 * (np.arange(n) % 16)))
    return np.concatenate([words, np.zeros((-len(words)) % 128, np.uint32)])


def _onehot(c):
    """int [..] codes -> int32 [.., 4]; code 4 (N, outside) is all 0."""
    return (c[..., None] == torch.arange(4)).to(torch.int32)


def _top8(keys):
    """The top 8 of int64 keys (0 = empty), padded with 0."""
    keys = keys[keys != 0]
    top = torch.topk(keys, min(TOP, keys.numel())).values
    return torch.cat([top, torch.zeros(TOP - top.numel(), dtype=torch.int64)])


def _unit_keys(acc, W):
    """Every unit's keys from the job's counts acc [J, U * 56]: the rounded
    count's code << 16 | (0xFFFF - the diagonal in the unit), 0 past W,
    [U, 896]; their lanes [896]; and their job keys (the code << 32 |
    ~d)."""
    cols = acc.shape[1]
    U = cols // (UNIT // J)
    j = torch.arange(J)[:, None]
    col = torch.arange(cols)[None, :]
    d = 16 * col + j
    dl = 16 * (col % (UNIT // J)) + j
    bits = acc.to(torch.float32).to(torch.bfloat16).view(torch.int16)
    code = torch.where(acc < 256, acc.to(torch.int64),
                       (bits.to(torch.int64) & 0xFFFF) - 0x4280)
    key = torch.where(d < W, code * 2 ** 16 + (0xFFFF - dl), 0)
    job = torch.where(d < W, code * 2 ** 32 + (2 ** 32 - 1 - d), 0)
    # tile k = i mod 7 holds the unit's column i as its column i // 7
    lane = (4 * (j % 8) + (col % (UNIT // J)) // 7 // 2).expand(J, cols)
    per = lambda x: x.T.reshape(U, -1)  # noqa: E731
    return per(key), per(lane)[0], per(job)


def _block_list(key, lane, job):
    """A block's walk over its units' keys [n, 896] in diagonal order: the
    first unit's candidates are its keys >= the 8th largest lane maximum,
    a later unit's those whose code beats the list's 8th; the list is the
    top 8 of itself and the candidates (which hold the true top 8)."""
    best = torch.zeros(TOP, dtype=torch.int64)
    for i in range(key.shape[0]):
        if i == 0:
            lmax = torch.zeros(32, dtype=torch.int64).scatter_reduce(
                0, lane, key[i], "amax")
            thr = int(lmax.sort(descending=True).values[TOP - 1])
        else:
            thr = 1 if best[-1] == 0 else (int(best[-1] >> 32) + 1) << 16
        cand = (key[i] != 0) & (key[i] >= thr)
        new = _top8(torch.cat([best, job[i][cand]]))
        assert torch.equal(new, _top8(torch.cat([best, job[i]])))
        best = new
    return best


UPB = 4


def split_rescue(ref_words, n_text, reads, win_start, W):
    """K12's units, read chunks, int8 products, keys, thresholded walks and
    merges: int32 [R, TOP] starts."""
    R, L = reads.shape
    U = -(-W // UNIT)
    cols = U * (UNIT // J)
    Ux = torch.arange(8 * KS)
    col = torch.arange(cols)
    j = torch.arange(J)
    out = torch.empty((R, TOP), dtype=torch.int64)
    for r in range(R):
        ws = int(win_start[r])
        rd = reads[r].long()
        if not bool(((rd >= 0) & (rd < 4)).any()):
            out[r] = ws + torch.arange(TOP)
            continue
        acc = torch.zeros((J, cols), dtype=torch.int32)
        for t0 in range(0, L, LC):
            lc = min(LC, L - t0)
            win = rk.ref_chars_block(ref_words, n_text, torch.tensor(
                [ws + t0]), 16 * cols + 8 * KS)[0]
            # B[(u, c), i]: the window's one-hot char at 16 i + u
            b = _onehot(win[16 * col[None, :] + Ux[:, None]])
            b = b.permute(0, 2, 1).reshape(8 * KS * 4, cols)
            # A[j, (u, c)]: the read's one-hot char u - j of the chunk
            t = Ux[None, :] - j[:, None]
            ok = (t >= 0) & (t < lc)
            a = _onehot(torch.where(ok, rd[(t0 + t).clamp(0, L - 1)], 4))
            # the int32 sum of 0/1 products, exact in float32 below 2^24
            acc += (a.reshape(J, 8 * KS * 4).float() @ b.float()).to(
                torch.int32)
        key, lane, job = _unit_keys(acc, W)
        # block b walks units UPB b, ..., UPB b + UPB - 1; the job's top 8
        # are among the blocks' keys >= the largest of their 8th keys
        keys = torch.stack([_block_list(key[u:u + UPB], lane, job[u:u + UPB])
                            for u in range(0, U, UPB)])
        tj = int(keys[:, TOP - 1].max())
        best = _top8(keys[keys >= tj])
        assert torch.equal(best, _top8(job.reshape(-1)))
        out[r] = ws + (2 ** 32 - 1 - (best & (2 ** 32 - 1)))
    return out.to(torch.int32)


def _jobs(rng, g, unit_at, R, L, W):
    n = len(g)
    reads = np.full((R, L), 4, np.int32)
    ws = np.zeros(R, np.int64)
    for i in range(R):
        s = int(rng.integers(0, n - L))
        reads[i] = g[s:s + L]
        ws[i] = (s - int(rng.integers(0, max(W - L, 1)))) // 56320 * 56320
    # the tie window: 100 chars of the unit, the rest N
    reads[0] = 4
    reads[0, :min(L, 100)] = g[unit_at + 10:unit_at + 10 + min(L, 100)]
    ws[0] = 0
    ws[1], reads[1] = -56320, g[:L]                 # before the start
    ws[2], reads[2] = n - 1000, g[n - L:]           # past the end
    if R > 3:
        reads[3] = 4                                # a padding job
        reads[4, ::13] = 4
    return reads, ws.astype(np.int32)


@pytest.mark.parametrize("R,L,W", [(6, 150, 57344), (5, 300, 80000)])
def test_rescue_split_matches_jax(R, L, W):
    rng = np.random.default_rng(L)
    g = rng.integers(0, 4, N_TEXT).astype(np.uint8)
    unit = rng.integers(0, 4, 120).astype(np.uint8)
    for s in SPOTS:
        g[s:s + 120] = unit
    words = _pack(g)
    reads, ws = _jobs(rng, g, SPOTS[0], R, L, W)
    if L > 256:     # a count past 256, which bfloat16 rounds
        reads[4], ws[4] = g[30_000:30_000 + L], 29_000
    n_pen = 1
    mm = np.full(64, 6, np.int32)
    cp = np.zeros(64, np.int32)

    def starts(rw, rd, wst):
        return j_rescue.rescue_candidates(
            rw, N_TEXT, rd, jnp.full(rd.shape, 30, jnp.int32),
            jnp.full(rd.shape[:1], L, jnp.int32), wst, W, jnp.asarray(mm),
            jnp.asarray(cp), n_pen)[0]

    want = np.asarray(jax.jit(starts)(jnp.asarray(words), jnp.asarray(reads),
                                      jnp.asarray(ws)))
    got = split_rescue(u32_to_tensor(words, "cpu"), N_TEXT,
                       torch.from_numpy(reads), torch.from_numpy(ws), W)
    np.testing.assert_array_equal(got.numpy(), want)
    if W > SPOTS[1]:
        assert got[0, :2].tolist() == [SPOTS[0] + 10, SPOTS[1] + 10]
    if R > 3:
        assert got[3].tolist() == [int(ws[3]) + i for i in range(TOP)]


def _key(mj, mn):
    """(major, minor) int32 as an int64 in signed lexicographic order."""
    return mj.long() * 2 ** 32 + (mn.long() + 2 ** 31)


def _split_set(mj, mn, rd, nmj, nmn, nrd, rows):
    cap, m = mj.shape[0], nmj.shape[0]
    old, new = _key(mj, mn), _key(nmj, nmn)
    idx = torch.arange(m)
    rank = ((new[None, :] < new[:, None])
            | ((new[None, :] == new[:, None]) & (idx[None, :] < idx[:, None]))
            ).sum(1)
    srt = torch.empty_like(new)
    srt[rank] = new
    sidx = torch.empty_like(idx)
    sidx[rank] = idx
    out = torch.zeros((3, cap), dtype=torch.int32)
    hits = torch.zeros(cap, dtype=torch.int64)
    src_old = torch.stack([mj, mn, rd])
    src_new = torch.stack([nmj, nmn, nrd])[:, sidx]
    for i0 in range(0, cap, rows):
        n = min(rows, cap - i0)
        blk = old[i0:i0 + n]
        # old rows: i + #{new keys < key}
        pos = i0 + torch.arange(n) + torch.searchsorted(srt, blk)
        keep = pos < cap
        out[:, pos[keep]] = src_old[:, i0:i0 + n][:, keep]
        hits[pos[keep]] += 1
        # new rows whose #{old keys <= key} falls in this range
        c = torch.searchsorted(blk, srt, right=True)
        prev = torch.ones(m, dtype=torch.bool) if i0 == 0 else \
            old[i0 - 1] <= srt
        pos = i0 + c + torch.arange(m)
        own = prev & (c < n) & (pos < cap)
        out[:, pos[own]] = src_new[:, own]
        hits[pos[own]] += 1
    assert bool((hits == 1).all())
    return list(out.unbind(0))


def _split_lob(lob, bins, w, nbins):
    NB = lob.shape[0] - 1
    out = torch.empty_like(lob)
    b, w = bins.long(), w.long()
    for b0 in range(0, max(NB, 1), nbins):
        n = max(0, min(nbins, NB - b0))
        below = int(w[b < b0].sum())
        ins = (b >= b0) & (b < b0 + n)
        h = torch.zeros(n, dtype=torch.int64)
        h.index_add_(0, b[ins] - b0, w[ins])
        excl = torch.cumsum(h, 0) - h
        out[b0:b0 + n] = (lob[b0:b0 + n].long() + below + excl).to(torch.int32)
        if b0 + n == NB:
            out[NB] = int(lob[NB]) + below + int(h.sum())
    return out


def split_merge(kd, ka, rd, ka_s, kd_s, rd_a, nkd, nka, nrd, lob_kd=None,
                lob_ka=None, bins_kd=None, bins_ka=None, wts=None,
                rows=ROWS, nbins=BINS):
    res = _split_set(kd, ka, rd, nkd, nka, nrd, rows)
    res += _split_set(ka_s, kd_s, rd_a, nka, nkd, nrd, rows)
    if lob_kd is not None:
        res += [_split_lob(lob_kd, bins_kd, wts, nbins),
                _split_lob(lob_ka, bins_ka, wts, nbins)]
    return res


def _tables(rng, cap, nn, m, case):
    """Sorted old table sets of nn real rows (sentinel-padded to cap) and
    a 512-row chunk of m real new rows: random keys with ties to old
    keys, all-equal new keys equal to an old key, or (m = 0) padding."""
    kd = np.sort(rng.integers(0, 2_000_000, nn)).astype(np.int32)
    kd[5:9] = kd[5]
    ka = (kd + rng.integers(30, 5000, nn)).astype(np.int32)
    o = np.lexsort((ka, kd))
    kd, ka = kd[o], ka[o]
    rd = rng.integers(-1, 100, nn).astype(np.int32)
    o2 = np.lexsort((kd, ka))
    pad = lambda a, f: np.concatenate(  # noqa: E731
        [a, np.full(cap - nn, f, np.int32)])
    nkd = np.full(512, SENT, np.int32)
    nka, nrd = nkd.copy(), np.full(512, -1, np.int32)
    if case == "equal":
        nkd[:m], nka[:m] = kd[5], ka[5]
    else:
        nkd[:m] = rng.integers(0, 2_000_000, m)
        nkd[:3] = kd[5]
        nka[:m] = nkd[:m] + 100
        nka[:3] = ka[5]
    nrd[:m] = 7 + np.arange(m) % 50
    return (pad(kd, SENT), pad(ka, SENT), pad(rd, -1), pad(ka[o2], SENT),
            pad(kd[o2], SENT), pad(rd[o2], -1), nkd, nka, nrd), kd, ka[o2]


def _lob(kd, ka_s, nkd, nka, m):
    shift, NB = 5, 1 << 19
    edges = np.arange(NB + 1, dtype=np.int64) << shift
    bkd, bka, w = (np.zeros(512, np.int32) for _ in range(3))
    bkd[:m] = np.clip(nkd[:m] >> shift, 0, NB - 1)
    bka[:m] = np.clip(nka[:m] >> shift, 0, NB - 1)
    if m:
        bkd[0], bka[m - 1] = 0, NB - 1         # the first and last bins
    w[:m] = 1
    return (np.searchsorted(kd, edges).astype(np.int32),
            np.searchsorted(ka_s, edges).astype(np.int32), bkd, bka, w)


@pytest.mark.parametrize("cap,nn,m,case,lob", [
    (4096, 3000, 300, "random", True),     # ties with old keys
    (64, 40, 512, "equal", False),         # all-equal new rows, cut by cap
    (16384, 15000, 512, "random", True),   # several blocks, each row real
    (1024, 559, 0, "random", True),        # no real new row
    (1024, 900, 1, "random", False)])
def test_merge_split_matches_jax(cap, nn, m, case, lob):
    rng = np.random.default_rng(cap + m)
    args, kd, ka_s = _tables(rng, cap, nn, m, case)
    if lob:
        args += _lob(kd, ka_s, args[6], args[7], m)
    want = [np.asarray(a) for a in
            j_sdb._merge_sorted_tabs(*(jnp.asarray(a) for a in args))]
    t = [torch.from_numpy(a) for a in args]
    for rows, nbins in ((ROWS, BINS), (max(48, cap // 12), 1000)):
        got = split_merge(*t, rows=rows, nbins=nbins)
        assert len(got) == len(want) == (8 if lob else 6)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), y,
                                          err_msg=f"rows {rows}")
