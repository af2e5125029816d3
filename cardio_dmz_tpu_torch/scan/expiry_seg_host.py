"""Expiry segmentation on the host, in numpy.

The reference-exact oracle for best_expiry_seg (scan/expiry_seg.cpp:
706-902) and its helpers, and the expiry path of session/host.HostScanner:
the device implementation (expiry_device.py) is validated against this
one, so it stays lists and loops on the host, as in the JAX package. Its
one model call, the slash MLP, runs where the scanner's models live.

Pipeline per frame (on the rectified 428x270 luma, below the PAN row):
scharr |dx| -> per-row sums over x in [27, 2W/3) -> top-3 non-overlapping
15-row stripes with dim-sub-stripe rejection -> per stripe: sliding 9x17
rect sums -> threshold -> greedy non-overlap -> gap<9 grouping -> whitespace
strip -> 11..15px regrid -> per-char trim to 11x16 -> keep 5-char windows
whose middle char is a slash (MLP prob > 0.7) => pattern MM/YY.
"""

import numpy as np
import torch

from .expiry_types import (
    CharacterRect,
    ExpiryPattern,
    GroupedRects,
    MIN_EXPIRY_STRIP_CHARS,
    MIN_NAME_STRIP_CHARS,
    SMALL_CHAR_HEIGHT,
    SMALL_CHAR_WIDTH,
    TRIMMED_CHAR_HEIGHT,
    TRIMMED_CHAR_WIDTH,
)

CARD_W = 428
CARD_H = 270
NUMBER_HEIGHT = 27

WHITESPACE_THRESHOLD = 0.8           # expiry_seg.cpp:108
RECT_AVERAGE_THRESHOLD_FACTOR = 5    # expiry_seg.cpp:397
RECT_SUM_THRESHOLD_FACTOR = 0.8      # expiry_seg.cpp:446
MIN_GRID_SPACING = 11                # expiry_seg.cpp:177
MAX_GRID_SPACING = 15
N_STRIPES_TO_TRY = 3                 # expiry_seg.cpp:793
CHAR_RECT_OUTSET = 2                 # expiry_seg.cpp:247


def scharr_dx_abs_below(card_y, starting_y_offset):
    """llcv_scharr3_dx_abs on the below-numbers ROI, zero elsewhere
    (expiry_seg.cpp:714-739). Border clamping happens at the ROI top."""
    y0 = starting_y_offset + NUMBER_HEIGHT
    roi = np.asarray(card_y[y0:], np.int32)
    h = roi.shape[0]
    out = np.zeros((CARD_H, CARD_W), np.int32)
    if h <= 0:
        return out
    left = np.concatenate([roi[:, :1], roi[:, :-1]], axis=1)
    right = np.concatenate([roi[:, 1:], roi[:, -1:]], axis=1)
    d = np.abs(right - left)
    up = np.concatenate([d[:1], d[:-1]], axis=0)
    dn = np.concatenate([d[1:], d[-1:]], axis=0)
    out[y0:] = 3 * (up + dn) + 10 * d
    return out


def select_stripes(sobel, starting_y_offset):
    """Stripe scoring + top-3 non-overlap selection
    (expiry_seg.cpp:741-871). Returns list of (base_row, stripe_sum)."""
    y0 = starting_y_offset + NUMBER_HEIGHT
    first_base = y0 + 1
    last_base = CARD_H - (SMALL_CHAR_HEIGHT + 1)
    left_edge = SMALL_CHAR_WIDTH * 3
    right_edge = (CARD_W * 2) // 3

    line_sum = np.zeros(CARD_H, np.int64)
    for row in range(first_base - 1, CARD_H):
        line_sum[row] = sobel[row, left_edge:right_edge].sum()

    candidates = []
    for base in range(first_base, last_base):
        rows = line_sum[base:base + SMALL_CHAR_HEIGHT]
        total = int(rows.sum())
        threshold = int(rows.max()) // 2
        if line_sum[base] + line_sum[base + 1] < threshold:
            continue
        if (line_sum[base + SMALL_CHAR_HEIGHT - 2] +
                line_sum[base + SMALL_CHAR_HEIGHT - 1]) < threshold:
            continue
        good = True
        for row in range(base, base + SMALL_CHAR_HEIGHT - 3):
            if line_sum[row + 1] < threshold and line_sum[row + 2] < threshold:
                good = False
                break
        if good:
            candidates.append((base, total))

    candidates.sort(key=lambda bs: -bs[1])
    chosen = []
    for base, total in candidates:
        if any(pb - SMALL_CHAR_HEIGHT < base < pb + SMALL_CHAR_HEIGHT
               for pb, _ in chosen):
            continue
        chosen.append((base, total))
        if len(chosen) >= N_STRIPES_TO_TRY:
            break
    return chosen


def strip_group_white_space(group: GroupedRects):
    """expiry_seg.cpp:107-133: recursively drop dim leading/trailing chars
    (vs 0.8x the average of the central 4)."""
    while len(group.character_rects) > 5:
        rects = group.character_rects
        index = (len(rects) - 4) // 2
        threshold = int(((rects[index].sum + rects[index + 1].sum +
                          rects[index + 2].sum + rects[index + 3].sum) // 4)
                        * WHITESPACE_THRESHOLD)
        if rects[0].sum < threshold:
            rects.pop(0)
            group.left = rects[0].left
        elif rects[-1].sum < threshold:
            rects.pop()
        else:
            break
        group.width = rects[-1].left + group.character_width - group.left


def gather_into_groups(items, horizontal_tolerance):
    """expiry_seg.cpp:135-172: merge left-sorted rects into groups while the
    gap to the group's right edge is < tolerance."""
    items = sorted(items, key=lambda g: g.left)
    grouped = [False] * len(items)
    groups = []
    for i, base in enumerate(items):
        if grouped[i]:
            continue
        group = GroupedRects(top=base.top, left=base.left, width=base.width,
                             height=base.height, sum=0,
                             character_width=base.character_width)
        group.character_rects = []
        _gather_chars(group, base)
        grouped[i] = True
        for j in range(i + 1, len(items)):
            item = items[j]
            if item.left - (group.left + group.width) >= horizontal_tolerance:
                break
            if not grouped[j]:
                grouped[j] = True
                former_bottom = group.top + group.height
                group.top = min(group.top, item.top)
                group.width = item.left + item.width - base.left
                group.height = max(former_bottom,
                                   item.top + item.height) - group.top
                _gather_chars(group, item)
        groups.append(group)
    for g in groups:
        strip_group_white_space(g)
    return groups


def _gather_chars(group, sub):
    group.sum += sub.sum
    if not sub.character_rects:
        group.character_rects.append(
            CharacterRect(sub.top, sub.left, sub.sum))
    else:
        group.character_rects.extend(sub.character_rects)


def regrid_group(sobel, group: GroupedRects):
    """expiry_seg.cpp:174-241: re-space characters on an optimal 11-15 px
    grid minimizing on-gridline energy."""
    bounds_left = max(group.left - 2 * SMALL_CHAR_WIDTH, 0)
    bounds_right = min(group.left + group.width + 2 * SMALL_CHAR_WIDTH, CARD_W)
    bounds_width = bounds_right - bounds_left
    min_lines = int(np.floor(bounds_width / MIN_GRID_SPACING))

    col_sums = sobel[group.top:group.top + group.height,
                     bounds_left:bounds_right].sum(axis=0).astype(np.int64)
    group_sum = int(col_sums.sum())

    best = (np.inf, 0, 0)
    for spacing in range(MIN_GRID_SPACING, MAX_GRID_SPACING + 1):
        for start in range(spacing):
            line_cols = np.arange(start, bounds_width, spacing)
            line_sum = float(col_sums[line_cols].sum())
            avg = line_sum / len(line_cols)
            line_sum = avg * min_lines
            ratio = line_sum / (group_sum - line_sum)
            if ratio < best[0]:
                best = (ratio, spacing, start)
    _, spacing, start = best

    rects = []
    off = start
    while off + 1 < bounds_width:
        s = int(col_sums[off + 1:min(off + spacing, bounds_width)].sum())
        rects.append(CharacterRect(group.top, bounds_left + off + 1, s))
        off += spacing

    group.character_rects = rects
    group.character_width = spacing - 1
    group.left = rects[0].left
    group.width = rects[-1].left + group.character_width - group.left
    strip_group_white_space(group)


def optimize_character_rects(sobel, group: GroupedRects):
    """expiry_seg.cpp:243-343: expand each char by 2px, normalize+threshold,
    then shave lowest-energy cols/rows to 11x16."""
    img_h, img_w = sobel.shape
    cw = group.character_width + 2 * CHAR_RECT_OUTSET
    ch = group.height + 2 * CHAR_RECT_OUTSET

    kept = []
    for rect in group.character_rects:
        left = rect.left - CHAR_RECT_OUTSET
        top = group.top - CHAR_RECT_OUTSET
        if left < 0 or left + cw > img_w or top + ch > img_h:
            continue
        char = sobel[top:top + ch, left:left + cw].astype(np.float64)
        m = np.abs(char).max()
        if m > 0:
            # cvNormalize(..., 255, 0, CV_C) on a 16S image: Linf scaling
            # with round-to-int storage
            char = np.rint(char * (255.0 / m))
        char = np.where(char > 100, char, 0)

        col_sums = char.sum(axis=0)
        lc, rc = 0, cw - 1
        w = cw
        while w > TRIMMED_CHAR_WIDTH:
            if col_sums[lc] <= col_sums[rc]:
                lc += 1
            else:
                rc -= 1
            w -= 1
        row_sums = char[:, lc:rc + 1].sum(axis=1)
        tr, br = 0, ch - 1
        h = ch
        while h > TRIMMED_CHAR_HEIGHT:
            if row_sums[tr] <= row_sums[br]:
                tr += 1
            else:
                br -= 1
            h -= 1
        kept.append(CharacterRect(top + tr, left + lc, rect.sum))

    group.character_rects = kept
    if kept:
        tops = [r.top for r in kept]
        group.character_width = TRIMMED_CHAR_WIDTH
        group.left = kept[0].left
        group.width = kept[-1].left + TRIMMED_CHAR_WIDTH - group.left
        group.top = min(tops)
        group.height = max(tops) + TRIMMED_CHAR_HEIGHT - group.top


def _slash_probs(slash_mlp, sobel, rects):
    """is_slash (expiry_seg.cpp:50-54) for a list of CharacterRects: each
    11x16 sobel crop scaled by 1/255 (scharr values reach 4080, so inputs
    exceed 1: the reference's behaviour, kept) -> the slash MLP ->
    P(slash), one batch on the module's device.

    The device path (expiry_device.slash_probs_conv) computes the same
    function on its gathered crops."""
    if not rects:
        return []
    crops = np.stack([
        sobel[r.top:r.top + TRIMMED_CHAR_HEIGHT,
              r.left:r.left + TRIMMED_CHAR_WIDTH] for r in rects])
    x = (crops.astype(np.float32) / 255.0).reshape(len(rects), -1)
    probs = slash_mlp(torch.from_numpy(x).to(
        slash_mlp.hidden_w.device))
    return probs[:, 0].cpu().tolist()


def _slash_prob(slash_mlp, sobel, rect: CharacterRect):
    """P(slash) of one character rect."""
    return _slash_probs(slash_mlp, sobel, [rect])[0]


def local_groups_for_stripe(sobel, base_row, stripe_sum):
    """Steps [1]-[4] of find_character_groups_for_stripe
    (expiry_seg.cpp:395-537): candidate 9x17 rects -> greedy non-overlap
    -> gap<9 local groups, BEFORE any width filtering."""
    h = SMALL_CHAR_HEIGHT + 2  # always 17 (see best_expiry_seg bounds)
    expanded_top = base_row - 1

    # [1] sliding 9-wide rect sums; NOTE the reference sums rows
    # [base_row, base_row+17) while labeling rects with top = base_row-1
    band = sobel[base_row:base_row + h].astype(np.int64)
    col_sums = band.sum(axis=0)
    c = np.concatenate([[0], np.cumsum(col_sums)])
    rect_sums = c[SMALL_CHAR_WIDTH:] - c[:-SMALL_CHAR_WIDTH]  # (W-8,)

    rect_avg = (int(stripe_sum) * SMALL_CHAR_WIDTH) // CARD_W
    dim_threshold = rect_avg // RECT_AVERAGE_THRESHOLD_FACTOR

    lefts = np.nonzero(rect_sums > dim_threshold)[0]
    if lefts.size == 0:
        return []
    sums = rect_sums[lefts]
    sum_threshold = RECT_SUM_THRESHOLD_FACTOR * sums.mean()

    # [2]+[3] sort desc, greedy non-overlap
    order = np.argsort(-sums, kind="stable")
    mask = np.zeros(CARD_W, bool)
    non_overlapping = []
    for oi in order:
        if sums[oi] <= sum_threshold:
            break
        left = int(lefts[oi])
        if not mask[left] and not mask[left + SMALL_CHAR_WIDTH - 1]:
            non_overlapping.append(GroupedRects(
                top=expanded_top, left=left, width=SMALL_CHAR_WIDTH,
                height=h, sum=int(sums[oi]),
                character_width=SMALL_CHAR_WIDTH))
            mask[left:left + SMALL_CHAR_WIDTH] = True

    # [4] local groups (gap < 9)
    return gather_into_groups(non_overlapping, SMALL_CHAR_WIDTH)


def find_character_groups_for_stripe(sobel, base_row, stripe_sum,
                                     slash_mlp,
                                     collect_name_groups=False):
    """expiry_seg.cpp:386-704 for one stripe. Returns (expiry_groups,
    name_groups): expiry groups are 5-char MM/YY GroupedRects; name
    groups are super-groups (local groups merged at a 2x gap tolerance,
    expiry_seg.cpp:530-548) - the reference carries this path but keeps
    the gather call commented out (expiry_seg.cpp:548), so
    collect_name_groups defaults off and serving matches the reference's
    runtime behavior exactly."""
    local_groups = local_groups_for_stripe(sobel, base_row, stripe_sum)

    # [5] super-groups: local groups merged while the gap is < 2x char
    # width (expiry_seg.cpp:546-548: the gather is commented out there;
    # this is that line, enabled). Gathered BEFORE the width filters,
    # exactly where the reference's call sits.
    super_groups = []
    if collect_name_groups:
        super_groups = gather_into_groups(local_groups,
                                          2 * SMALL_CHAR_WIDTH)
        super_groups = [g for g in super_groups
                        if len(g.character_rects)
                        >= MIN_NAME_STRIP_CHARS - 1]

    local_groups = [g for g in local_groups
                    if len(g.character_rects) >= MIN_EXPIRY_STRIP_CHARS - 1]

    # [6] regrid + per-char optimize (both kinds, expiry_seg.cpp:591-645)
    for g in local_groups:
        regrid_group(sobel, g)
    for g in super_groups:
        regrid_group(sobel, g)
    out = []
    for g in local_groups:
        optimize_character_rects(sobel, g)
        if len(g.character_rects) >= MIN_EXPIRY_STRIP_CHARS:
            out.append(g)
    name_groups = []
    for g in super_groups:
        optimize_character_rects(sobel, g)
        if len(g.character_rects) >= MIN_NAME_STRIP_CHARS:
            name_groups.append(g)

    # slash check anchors MM/YY windows (expiry_seg.cpp:659-687); every
    # candidate middle char of the stripe goes through the MLP in one batch
    middles = [g.character_rects[first + 2] for g in out
               for first in range(len(g.character_rects) - 4)]
    probs = iter(_slash_probs(slash_mlp, sobel, middles))
    expiry_groups = []
    for g in out:
        rects = g.character_rects
        for first in range(len(rects) - 4):
            if next(probs) > 0.7:
                win = rects[first:first + 5]
                top = min(r.top for r in win)
                bottom = max(r.top + SMALL_CHAR_HEIGHT for r in win)
                eg = GroupedRects(
                    top=top, left=win[0].left,
                    width=win[-1].left + SMALL_CHAR_WIDTH - win[0].left,
                    height=bottom - top, sum=0,
                    character_width=TRIMMED_CHAR_WIDTH,
                    pattern=ExpiryPattern.MM_S_YY)
                eg.character_rects = list(win)
                expiry_groups.append(eg)
    return expiry_groups, name_groups


def best_expiry_seg(card_y, starting_y_offset, slash_mlp,
                    collect_name_groups=False):
    """best_expiry_seg (expiry_seg.cpp:706-902). Returns (expiry_groups,
    name_groups). Name super-groups are disabled in the reference's
    runtime (expiry_seg.cpp:547-548) so collect_name_groups defaults
    False (name_groups empty, matching shipped behavior); True enables
    the carried-but-disabled gather_into_groups(.., 2*char_width) path.
    card_y: (270, 428) u8 numpy; slash_mlp: the port's slash Mlp module."""
    card_y = np.asarray(card_y)
    sobel = scharr_dx_abs_below(card_y, starting_y_offset)
    stripes = select_stripes(sobel, starting_y_offset)
    expiry_groups = []
    name_groups = []
    for base, total in stripes:
        eg, ng = find_character_groups_for_stripe(
            sobel, base, total, slash_mlp,
            collect_name_groups=collect_name_groups)
        expiry_groups.extend(eg)
        name_groups.extend(ng)
    return expiry_groups, name_groups
