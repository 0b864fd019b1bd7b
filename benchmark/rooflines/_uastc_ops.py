"""Instructions per 4x4 block of the UASTC trials, frozen copies of
`chip_smoke._line_fit_ops`, `_mode_trial_ops`, `_subset_trial_ops` and
`_dualplane_trial_ops` (their docstrings there say what each term counts),
and the mode lists of the effort-2 search (`codecs/uastc/pack.py`
`_effort_mode_set`): (mode, weight bits, endpoint range, components)."""

RGB_MODES = ((0, 4, 19, 3), (1, 2, 20, 3), (5, 3, 20, 3), (18, 5, 11, 3))
RGBA_MODES = ((10, 4, 13, 4), (12, 3, 19, 4), (14, 2, 20, 4), (15, 4, 20, 2))
# (weight bits, endpoint range, components, subsets, patterns, top-k)
SUBSET_RGB = ((3, 8, 3, 2, 30, 4), (2, 12, 3, 2, 30, 4))       # modes 2, 4
SUBSET_RGBA = ((2, 8, 4, 2, 30, 4),)                            # mode 9
# (weight bits, endpoint range, channels)
DUAL_RGB = ((2, 18, 3),)                                        # mode 6
DUAL_RGBA = ((2, 13, 4), (1, 20, 4), (2, 20, 2))                # 11, 13, 17
LS_ITERS = 1                                                    # effort 2


def line_fit_ops(n_ch, n_sub, n_lev, ls_iters, iters=4, per_level=None):
    searches = 1 + ls_iters
    if per_level is None:
        per_level = 3 * n_ch + 1
    per_block = (16 * n_ch * 3 + 16 * n_ch * n_ch + 32
                 + searches * (16 * n_lev * per_level + 16)
                 + ls_iters * (16 * 2 + 16 * 6 + 32 * n_ch))
    per_subset = (n_ch + iters * (n_ch * n_ch + 3 * n_ch + 1) + 3 * n_ch
                  + searches * 5 * n_lev * n_ch
                  + ls_iters * (3 + 10 * n_ch + 2 * n_ch + 2))
    return per_block + n_sub * per_subset


def mode_trial_ops(comps, n_lev, ls_iters):
    ops = line_fit_ops(comps, 1, n_lev, ls_iters, iters=6,
                       per_level=3 * comps + 1 if comps == 2 else 4)
    ops += (1 + ls_iters) * (12 * comps + 2 * n_lev * comps)
    return ops + {2: 16 * 3 + 16 * 25, 3: 16 * 3, 4: 0}[comps]


def subset_trial_ops(comps, n_sub, n_lev, ls_iters, topk, n_pat):
    split = 16 * 3 + 32
    if n_sub == 2:
        split += 4 * 16 * 5 + 3 * 2 * 17
    else:
        split += 17 + 3 * 16 * 8 + 2 * 3 * 17
    scores = n_pat * ((3 if n_sub == 2 else 30) + n_pat)
    per_cand = (line_fit_ops(comps, n_sub, n_lev, ls_iters)
                + n_sub * (12 * comps + 7 * n_lev * comps)
                + 16 * n_lev * (3 * comps + 1) + 16)
    tail = {2: 16 * 19 + 64, 3: 16 * 3, 4: 0}[comps]
    return split + scores + topk * per_cand + tail


def dualplane_trial_ops(n_ch, n_lev, ls_iters):
    fit1 = line_fit_ops(1, 1, n_lev, ls_iters)
    if n_ch == 2:
        return 48 + 2 * fit1 + 24 + 14 * n_lev + 16 * n_lev * 14 + 32
    per_ccs = (line_fit_ops(n_ch - 1, 1, n_lev, ls_iters) + fit1
               + 12 * n_ch + 7 * n_lev * n_ch + 16 * n_lev * (3 * n_ch + 2)
               + 32)
    return n_ch * per_ccs + (48 if n_ch == 3 else 0)
