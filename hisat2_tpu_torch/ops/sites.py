"""The incremental merge of new splice sites into the sorted device site
tables (K18; counterpart of hisat2_tpu/align/splice_db.py:40
_merge_sorted_tabs with lob_add :72).

`merge_sorted_tabs` launches csrc/merge_sites.cu on CUDA tensors and runs
`merge_sorted_tabs_plain` on CPU tensors.  The plain version is the JAX
function line by line: concatenation, two stable argsort passes (minor,
then major), truncation to capacity, and the bucket index's per-bin count
of the new rows added as an exclusive cumsum onto lob.
"""

from __future__ import annotations

import torch

from .. import kernels

MERGE_CHUNK = 512        # new rows per merge (align/splice_db.py:36)
_I32 = torch.int32


def _merge3_plain(a_major, a_minor, a_rd, n_major, n_minor, n_rd):
    cap = a_major.shape[0]
    mj = torch.cat([a_major, n_major])
    mn = torch.cat([a_minor, n_minor])
    r2 = torch.cat([a_rd, n_rd])
    o1 = torch.sort(mn, stable=True).indices
    o2 = torch.sort(mj[o1], stable=True).indices
    o = o1[o2]
    return mj[o][:cap], mn[o][:cap], r2[o][:cap]


def _lob_add_plain(lob, bins, w):
    cnt = torch.zeros(lob.shape[0] - 1, dtype=torch.int64, device=lob.device)
    cnt.index_add_(0, bins.to(torch.int64), w.to(torch.int64))
    return lob + torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=lob.device),
                            torch.cumsum(cnt, 0)]).to(_I32)


def merge_sorted_tabs_plain(kd, ka, rd, ka_s, kd_s, rd_a, nkd, nka, nrd,
                            lob_kd=None, lob_ka=None, bins_kd=None,
                            bins_ka=None, wts=None):
    """Plain twin of K18: fold the MERGE_CHUNK new rows (nkd, nka, nrd,
    sentinel-padded) into both sorted table sets; with a bucket index,
    also the lob arrays (bins_* the new rows' bins, wts 1 for real
    rows).  Returns the 6 (or 8) new arrays."""
    kd1, ka1, rd1 = _merge3_plain(kd, ka, rd, nkd, nka, nrd)
    ka2, kd2, rd2 = _merge3_plain(ka_s, kd_s, rd_a, nka, nkd, nrd)
    out = (kd1, ka1, rd1, ka2, kd2, rd2)
    if lob_kd is not None:
        out += (_lob_add_plain(lob_kd, bins_kd, wts),
                _lob_add_plain(lob_ka, bins_ka, wts))
    return out


def merge_sorted_tabs(kd, ka, rd, ka_s, kd_s, rd_a, nkd, nka, nrd,
                      lob_kd=None, lob_ka=None, bins_kd=None, bins_ka=None,
                      wts=None):
    """K18 on CUDA tensors, merge_sorted_tabs_plain on CPU tensors.  The
    kernel takes the real new rows as those with wts = 1 (a prefix of the
    chunk, as device_tables builds it) and finds each lob bin's count of
    them by binary search over their sorted bins."""
    if not kd.is_cuda:
        return merge_sorted_tabs_plain(kd, ka, rd, ka_s, kd_s, rd_a, nkd, nka,
                                       nrd, lob_kd, lob_ka, bins_kd, bins_ka,
                                       wts)
    cap = kd.shape[0]
    m = nkd.shape[0]
    for nm, t, shp in (("kd", kd, (cap,)), ("ka", ka, (cap,)),
                       ("rd", rd, (cap,)), ("ka_s", ka_s, (cap,)),
                       ("kd_s", kd_s, (cap,)), ("rd_a", rd_a, (cap,)),
                       ("nkd", nkd, (m,)), ("nka", nka, (m,)),
                       ("nrd", nrd, (m,))):
        kernels.check_cuda(nm, t, _I32, shp)
    if m > MERGE_CHUNK:
        raise ValueError(f"merge_sites: at most {MERGE_CHUNK} new rows")
    have_lob = lob_kd is not None
    out = torch.empty((6, cap), dtype=_I32, device=kd.device)
    NB = 0
    if have_lob:
        NB = lob_kd.shape[0] - 1
        for nm, t, shp in (("lob_kd", lob_kd, (NB + 1,)),
                           ("lob_ka", lob_ka, (NB + 1,)),
                           ("bins_kd", bins_kd, (m,)),
                           ("bins_ka", bins_ka, (m,)), ("wts", wts, (m,))):
            kernels.check_cuda(nm, t, _I32, shp)
        lob_out = torch.empty((2, NB + 1), dtype=_I32, device=kd.device)
    scratch = torch.empty((4, MERGE_CHUNK), dtype=torch.int64,
                          device=kd.device)
    ptr = lambda t: t.data_ptr() if t is not None else kd.data_ptr()  # noqa
    kernels.KERNELS["merge_sites"].launch(
        kd.data_ptr(), ka.data_ptr(), rd.data_ptr(), ka_s.data_ptr(),
        kd_s.data_ptr(), rd_a.data_ptr(), nkd.data_ptr(), nka.data_ptr(),
        nrd.data_ptr(), ptr(lob_kd), ptr(lob_ka), ptr(bins_kd), ptr(bins_ka),
        ptr(wts), cap, m, NB, out.data_ptr(),
        lob_out.data_ptr() if have_lob else out.data_ptr(),
        scratch.data_ptr(), stream=kernels.stream_of(kd))
    res = tuple(out.unbind(0))
    if have_lob:
        res += tuple(lob_out.unbind(0))
    return res
