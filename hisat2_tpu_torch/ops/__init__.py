"""hisat2_tpu_torch.ops"""


def kernel_twins() -> dict:
    """{kernel name: (wrapper, plain twin)} for every hand kernel in
    kernels.KERNELS.  The wrapper launches the kernel on CUDA tensors; the
    twin takes the same keyword arguments, so a caller can replay a
    captured call (TorchAligner.step(capture=...)) through both."""
    from . import compact, extend, rescue, resolve, search, sites, splice
    return {
        "fm_search2": (search.partial_search2, search.partial_search2_plain),
        "ref_window": (splice.diag_chars_multi,
                       splice.diag_chars_multi_plain),
        "extend_ungapped": (extend.extend_grouped,
                            extend.extend_grouped_plain),
        "indel_sweep": (splice.self_indel_sweep,
                        splice.self_indel_sweep_plain),
        "compact_cands": (compact.compact_cands,
                          compact.compact_candidates_plain),
        "pack_slots": (compact.pack_slots, compact.pack_slots_plain),
        "inject_indels": (splice.inject_indels, splice.inject_indels_plain),
        "rescue_window": (rescue.rescue_window, rescue.rescue_window_plain),
        "search_lanes_live": (search.search_lanes_live,
                              search.search_lanes_live_ref),
        "pair_sweep": (splice.pair_sweep, splice.pair_sweep_ref),
        "second_sweep": (splice.second_sweep, splice.second_sweep_ref),
        "inject_known": (splice.inject_known, splice.inject_known_ref),
        "merge_sites": (sites.merge_sorted_tabs,
                        sites.merge_sorted_tabs_plain),
        "resolve_walk": (resolve.resolve_rows_sparse,
                         resolve.resolve_rows_sparse_plain),
    }
