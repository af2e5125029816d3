"""Expiry segmentation, categorization and cross-frame aggregation,
stream-major.

Counterpart of the JAX package's scan/expiry_device.py (the reference's
scan/expiry_seg.cpp and expiry_categorize.cpp). Every function takes
tensors with a leading stream axis S and returns what the JAX function
returns for each stream: the same windows, char rects, scores and dates.
The stages and their fixed caps are the JAX package's; where it selects
with one-hot contractions (a TPU has no cheap gather), this module
indexes and gathers.

* stripe selection      -> candidate scoring + 3x iterated argmax
* greedy non-overlap    -> 8 rounds of parallel local-maxima selection
* grouping              -> run-length labels on the accepted rects
* whitespace stripping  -> the removal step on every (start, count) state,
                           iterated by squaring
* regrid                -> (spacing x phase) grid scoring
* char trimming         -> the edge shaves on gathered crops, the same way
* slash anchoring       -> the slash MLP over all window middles
* cross-frame merge     -> 4-slot group table with masked EWMA

Caps: 3 stripes, 4 groups a stripe, 16 chars a group, 4 MM/YY windows a
frame, 4 aggregated slots.
"""

import functools
import typing

import torch
import torch.nn.functional as F

from ..constants import (
    CARD_HEIGHT,
    CARD_WIDTH,
    EXPIRY_DECAY_FACTOR,
    EXPIRY_MIN_STABILITY,
    NUMBER_HEIGHT,
)
from ..ops import (
    bilateral3x3, equalize_hist, morph_grad3_2d_cross_u8, window_select)

SMALL_W = 9
SMALL_H = 15
TRIM_W = 11
TRIM_H = 16
BAND_H = SMALL_H + 2          # 17
MAX_STRIPES = 3
MAX_GROUPS = 4                # processed local groups per stripe
MAX_CHARS = 16                # chars per group
MAX_WINDOWS = 4               # emitted MM/YY windows per frame
MAX_SLOTS = 4                 # aggregated cross-frame group slots
N_RECT_POS = CARD_WIDTH - SMALL_W + 1   # 420 sliding rect positions
EXPANDED_W = 18               # char trim crop (max char_width 14 + 4)
EXPANDED_H = 21               # height 17 + 4
V_ALLOW = TRIM_H // 2         # coalescing tolerances
H_ALLOW = TRIM_W // 2
MIN_SEEN = 3
NONOVERLAP_ROUNDS = 8
_ABSENT = 9999                # sentinel of an empty compaction slot

# The segmentation works on the card's lower 136 rows, as the JAX package
# does: the expiry runs only on right-side-up frames (vseg_y >= 121), so
# y_start = vseg_y + 27 >= 148 and every band it reads starts at row 140 or
# below. Row coordinates stay absolute; only the band reads are relative,
# and they clip as the JAX package's do, so that a frame outside that
# range (gated off, its windows invalid) still gives the same numbers.
_BAND_ROWS = 136
_SCHARR_BASE = CARD_HEIGHT - _BAND_ROWS


class ExpiryWindows(typing.NamedTuple):
    """Per-frame MM/YY candidate windows (fixed MAX_WINDOWS slots)."""
    valid: torch.Tensor       # (S, W) bool
    top: torch.Tensor         # (S, W) int32 group top (min char top)
    left: torch.Tensor        # (S, W) int32 first char left
    char_tops: torch.Tensor   # (S, W, 5) int32
    char_lefts: torch.Tensor  # (S, W, 5) int32


def _zeros(n_streams, device, *shape, dtype=torch.int32):
    return torch.zeros((n_streams,) + shape, dtype=dtype, device=device)


def no_windows(n_streams, device) -> ExpiryWindows:
    """An all-invalid window set for every stream."""
    return ExpiryWindows(
        valid=_zeros(n_streams, device, MAX_WINDOWS, dtype=torch.bool),
        top=_zeros(n_streams, device, MAX_WINDOWS),
        left=_zeros(n_streams, device, MAX_WINDOWS),
        char_tops=_zeros(n_streams, device, MAX_WINDOWS, 5),
        char_lefts=_zeros(n_streams, device, MAX_WINDOWS, 5))


class ExpiryState(typing.NamedTuple):
    """Cross-frame aggregated group table (the GroupedRectsList role)."""
    active: torch.Tensor         # (S, SLOTS) bool
    top: torch.Tensor            # (S, SLOTS) int32
    left: torch.Tensor           # (S, SLOTS) int32
    scores: torch.Tensor         # (S, SLOTS, 5, 10) f32
    recently_seen: torch.Tensor  # (S, SLOTS) int32
    total_seen: torch.Tensor     # (S, SLOTS) int32


def expiry_state_init(n_streams, device) -> ExpiryState:
    return ExpiryState(
        active=_zeros(n_streams, device, MAX_SLOTS, dtype=torch.bool),
        top=_zeros(n_streams, device, MAX_SLOTS),
        left=_zeros(n_streams, device, MAX_SLOTS),
        scores=_zeros(n_streams, device, MAX_SLOTS, 5, 10,
                      dtype=torch.float32),
        recently_seen=_zeros(n_streams, device, MAX_SLOTS),
        total_seen=_zeros(n_streams, device, MAX_SLOTS),
    )


# ---------------------------------------------------------------------------
# small indexing helpers
# ---------------------------------------------------------------------------

def _arange(n, like):
    return torch.arange(n, device=like.device)


def _take(vec, idx):
    """vec[..., idx] along the last dim, idx clipped into range.
    vec: (..., N); idx: (..., K) -> (..., K)."""
    return torch.gather(vec, -1, idx.to(torch.int64).clamp(
        0, vec.shape[-1] - 1))


def _take_or_zero(vec, idx):
    """vec[..., idx], and 0 where idx lies outside [0, N)."""
    inside = (idx >= 0) & (idx < vec.shape[-1])
    return torch.where(inside, _take(vec, idx), 0)


def _first_true(mask):
    """Index of the first True along the last dim, 0 if there is none."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _compact(mask, values, n_slots, fill):
    """The values at the first n_slots True positions of mask, in order,
    `fill` in the slots left over. mask: (..., N) bool; values: (..., N) or
    (N,) -> (..., n_slots), and how many slots were filled."""
    rank = torch.cumsum(mask, dim=-1) - 1
    slot = torch.where(mask & (rank < n_slots), rank, n_slots)
    out = values.new_full(mask.shape[:-1] + (n_slots + 1,), fill)
    out.scatter_(-1, slot, values.expand(mask.shape).contiguous())
    return out[..., :n_slots], mask.sum(dim=-1).clamp(max=n_slots)


def _band_rows(plane, top, height):
    """Rows [top, top + height) of each stream's (136-row) plane, one band
    per entry of top. plane: (S, 136, C); top: (S, K) band-relative ->
    (S, K, height, C)."""
    rows = top.to(torch.int64)[..., None] + _arange(height, plane)
    streams = _arange(plane.shape[0], plane)[:, None, None]
    return plane[streams, rows]


def _iterate(step, rounds):
    """A map on states applied `rounds` times or more, by squaring.
    step: (..., n_states) int64, the state each state goes to; every state
    reached after `rounds` applications must map to itself."""
    done = 1
    while done < rounds:
        step = torch.gather(step, -1, step)
        done *= 2
    return step


# ---------------------------------------------------------------------------
# stage A: scharr |dx| below the PAN (ROI-clamped like the reference)
# ---------------------------------------------------------------------------

def scharr_dx_abs_below(y_img, y_start):
    """expiry_seg.cpp:714-739, the ROI realized as masking and a border
    clamp at the row y_start (= vseg_y + 27).

    y_img: (S, 270, 428) u8; y_start: (S,) int. Returns the (S, 136, 428)
    int32 lower band (card row r at band index r - 134), values <= 4080."""
    xi = y_img[:, _SCHARR_BASE:].to(torch.int32)
    left = torch.cat([xi[..., :1], xi[..., :-1]], dim=-1)
    right = torch.cat([xi[..., 1:], xi[..., -1:]], dim=-1)
    d = (right - left).abs()
    rows = (_SCHARR_BASE + _arange(_BAND_ROWS, y_img))[None, :, None]
    y_start = y_start[:, None, None]
    d = torch.where(rows >= y_start, d, 0)
    up = torch.cat([d[:, :1], d[:, :-1]], dim=1)
    up = torch.where(rows <= y_start, d, up)      # clamp at the ROI top
    dn = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
    out = 3 * (up + dn) + 10 * d
    return torch.where(rows >= y_start, out, 0)


# ---------------------------------------------------------------------------
# stage B/C: stripe scoring + top-3 selection
# ---------------------------------------------------------------------------

def select_stripes(sobel, y_start):
    """expiry_seg.cpp:745-871. sobel: (S, 136, 428) from
    scharr_dx_abs_below; y_start: (S,). Returns (bases, sums, valid), each
    (S, 3); bases in absolute card rows."""
    left_edge = SMALL_W * 3
    right_edge = (CARD_WIDTH * 2) // 3
    ls = F.pad(sobel[:, :, left_edge:right_edge].sum(dim=2),
               (_SCHARR_BASE, SMALL_H - 1))               # (S, 270 + 14)
    line = ls.unfold(1, SMALL_H, 1)           # line[b, k] = ls[b + k]
    totals = line.sum(dim=2)
    thr = line.amax(dim=2) // 2

    top_ok = (line[:, :, 0] + line[:, :, 1]) >= thr
    bot_ok = (line[:, :, SMALL_H - 2] + line[:, :, SMALL_H - 1]) >= thr
    dim = line < thr[:, :, None]
    # bad iff line[k] and line[k + 1] are both dim for some k in 1..12
    interior_bad = (dim[:, :, 1:SMALL_H - 2] & dim[:, :, 2:SMALL_H - 1]).any(2)

    bases = _arange(CARD_HEIGHT, sobel)
    first_base = (y_start + 1)[:, None]
    last_base = CARD_HEIGHT - (SMALL_H + 1)
    valid = ((bases >= first_base) & (bases < last_base) &
             top_ok & bot_ok & ~interior_bad)
    masked_totals = torch.where(valid, totals, -1)

    sel_base, sel_sum, sel_ok = [], [], []
    for _ in range(MAX_STRIPES):
        best = torch.argmax(masked_totals, dim=1, keepdim=True)
        sel_ok.append(torch.gather(masked_totals, 1, best) > -1)
        sel_base.append(best)
        sel_sum.append(torch.gather(totals, 1, best))
        overlap = (bases - best).abs() < SMALL_H
        masked_totals = torch.where(overlap, -1, masked_totals)
    return (torch.cat(sel_base, 1).to(torch.int32),
            torch.cat(sel_sum, 1).to(torch.int32), torch.cat(sel_ok, 1))


# ---------------------------------------------------------------------------
# stage D: per-stripe character group extraction
# ---------------------------------------------------------------------------

def _nonoverlap_select(rect_sums, cand):
    """Greedy take-best-first over the 9-wide interval graph, as 8 rounds
    of parallel local maxima: each round accepts every candidate that beats
    all others within +-8 positions and removes what overlaps it. The round
    count is the JAX package's; on noise it truncates the greedy chain, so
    the cap is part of the result.

    rect_sums: (..., 420) int; cand: (..., 420) bool -> accepted (..., 420).
    """
    # strict total order: sum desc, then left asc; sums <= 4080*9*17, so
    # the key fits int32 but not float32: the sliding max stays in integers
    key = rect_sums.to(torch.int32) * 1024 + (
        1023 - _arange(N_RECT_POS, rect_sums)).to(torch.int32)
    win = 2 * SMALL_W - 1       # rects within +-8 positions overlap

    def window(x, pad_value):
        return F.pad(x, (SMALL_W - 1, SMALL_W - 1),
                     value=pad_value).unfold(-1, win, 1)

    accepted = torch.zeros_like(cand)
    alive = cand
    for _ in range(NONOVERLAP_ROUNDS):
        k = torch.where(alive, key, -1)
        is_max = alive & (k == window(k, -1).amax(dim=-1)) & (k > -1)
        accepted = accepted | is_max
        alive = alive & ~window(is_max, False).any(dim=-1)
    return accepted


@functools.lru_cache(maxsize=None)
def _strip_states(n, device):
    """Every state (start s < n, count c <= n) of a whitespace strip over n
    sums, flattened s-major: the six positions a step reads (the four
    middle ones, the first and the last of the run, clipped into range),
    whether the first middle read lies inside [0, n) (it is negative when
    c < 4), and whether the run may still shrink (c > 5)."""
    s = torch.arange(n, device=device)[:, None].expand(n, n + 1).flatten()
    c = torch.arange(n + 1, device=device)[None, :].expand(n, n + 1).flatten()
    idx = s + torch.div(c - 4, 2, rounding_mode="floor")
    pos = torch.stack([idx, idx + 1, idx + 2, idx + 3, s, s + c - 1], dim=-1)
    return pos.clamp(0, n - 1), (idx >= 0) & (idx < n), c > 5


def _whitespace_strip(sums, start, count):
    """strip_group_white_space (expiry_seg.cpp:107-133) on the contiguous
    (start, count) run of `sums`: while the run is longer than 5, drop its
    first char if that is dimmer than 0.8 of the middle four's mean, else
    its last if that is; at most n - 5 removals. A middle read outside
    [0, n) gives 0, as the JAX package's one-hot reads do.

    One removal step maps a state (start, count) to a state, and a state
    that removes nothing to itself. So the step is taken for every state at
    once, and the n - 5 bounded rounds of the JAX package are that map
    iterated by squaring: a handful of tensor operations in place of a loop
    of dependent reads.
    sums: (..., n) int; start, count: (...) int. Returns (start, count)."""
    n = sums.shape[-1]
    pos, inside, may_shrink = _strip_states(n, sums.device)
    reads = sums[..., pos]                                # (..., states, 6)
    mid = torch.div(torch.where(inside, reads[..., 0], 0)
                    + reads[..., 1:4].sum(dim=-1), 4, rounding_mode="floor")
    thr = (mid.to(torch.float32) * 0.8).to(torch.int32)
    first_dim = reads[..., 4] < thr
    go = may_shrink & (first_dim | (reads[..., 5] < thr))
    # dropping the first char is (s + 1, c - 1), the last (s, c - 1)
    step = (_arange(n * (n + 1), sums)
            + torch.where(first_dim, n, -1) * go).clamp(0, n * (n + 1) - 1)
    final = torch.gather(
        _iterate(step, n - 5), -1,
        (start * (n + 1) + count).to(torch.int64)[..., None])[..., 0]
    return ((final // (n + 1)).to(start.dtype),
            (final % (n + 1)).to(count.dtype))


def _regrid(col_sums_full, bounds_left, bounds_width, n_min=11, n_max=15):
    """regrid_group's grid search and regridded sums (expiry_seg.cpp:
    174-241).

    col_sums_full: (..., 428) int column sums over the group's rows;
    bounds_left, bounds_width: (...) int. Returns (char_lefts (..., 16),
    char_sums (..., 16), n_chars, spacing)."""
    cols = _arange(CARD_WIDTH, col_sums_full)
    left, width = bounds_left[..., None], bounds_width[..., None]
    in_bounds = (cols >= left) & (cols < left + width)
    cs_abs = torch.where(in_bounds, col_sums_full, 0).to(torch.int32)
    group_sum = cs_abs.sum(dim=-1).to(torch.float32)
    csum_abs = F.pad(torch.cumsum(cs_abs, dim=-1), (1, 0))      # (..., 429)
    min_lines = torch.div(bounds_width, n_min, rounding_mode="floor")

    phases = _arange(n_max, cs_abs)                             # (15,)
    spacings = torch.arange(n_min, n_max + 1, device=cs_abs.device)
    # the gridlines of (spacing s, phase p) are the columns congruent to
    # bounds_left + p mod s inside the bounds
    line_sum = []
    for s in range(n_min, n_max + 1):
        residue_sums = F.pad(cs_abs, (0, (-CARD_WIDTH) % s)).unflatten(
            -1, (-1, s)).sum(dim=-2)
        line_sum.append(_take(residue_sums, (left + phases) % s))
    line_sum = torch.stack(line_sum, dim=-2).to(torch.float32)  # (..., 5, 15)

    width = width[..., None]
    n_lines = torch.where(
        phases < width,
        torch.div(width - phases + spacings[:, None] - 1, spacings[:, None],
                  rounding_mode="floor"), 0)
    avg = line_sum / n_lines.clamp(min=1)
    eff = avg * min_lines[..., None, None]
    ratio = eff / (group_sum[..., None, None] - eff).clamp(min=1e-6)
    ratio = torch.where(phases < spacings[:, None], ratio, torch.inf)
    flat = torch.argmin(ratio.flatten(-2), dim=-1)   # spacing-major order
    phase = (flat % n_max)[..., None]
    spacing = (n_min + flat // n_max)[..., None]

    # regridded rects: off = phase + k*spacing while off + 1 < bounds_width
    offs = phase + _arange(MAX_CHARS, cs_abs) * spacing
    width = width[..., 0]
    char_valid = offs + 1 < width
    seg_end = torch.minimum(offs + spacing, width)
    char_sums = (_take_or_zero(csum_abs, left + seg_end) -
                 _take_or_zero(csum_abs, left + offs + 1))
    char_sums = torch.where(char_valid, char_sums, 0)
    char_lefts = left + offs + 1
    return (char_lefts.to(torch.int32), char_sums.to(torch.int32),
            char_valid.sum(dim=-1), spacing[..., 0].to(torch.int32))


def _shave(low, high, n_shaves):
    """The edge-shave loop of optimize_character_rects: n_shaves times,
    drop the low end if its sum is <= the high end's, else the high end.
    low[a] is the low end's sum after a low drops, high[d] the high end's
    after d high drops. The state (a, d) steps to (a + 1, d) or (a, d + 1)
    until a + d = n_shaves; every state steps at once, iterated by
    squaring, and the walk from (0, 0) is read off.
    low, high: (..., K) int; n_shaves: (...) int tensor or an int, < K.
    Returns the number of low drops, (...)."""
    k = low.shape[-1]
    a, d = _arange(k, low)[:, None], _arange(k, low)[None, :]
    if torch.is_tensor(n_shaves):
        n_shaves = n_shaves[..., None, None]
    go_low = low[..., :, None] <= high[..., None, :]          # (..., K, K)
    step = (a * k + d) + torch.where(go_low, k, 1) * (a + d < n_shaves)
    final = _iterate(step.flatten(-2).clamp(max=k * k - 1), k - 1)[..., 0]
    return final // k


def _trim_char(crop0, char_left, group_top, char_width):
    """optimize_character_rects' inner loop (expiry_seg.cpp:255-331).

    crop0: (..., 21, 18) int, the band's columns from clip(char_left - 2,
    0, 410); char_left, group_top, char_width: (...) int. Returns (top,
    left, valid), each (...)."""
    cw = char_width + 4                  # <= 18
    left0 = char_left - 2
    top0 = group_top - 2
    valid = ((left0 >= 0) & (left0 + cw <= CARD_WIDTH) &
             (top0 + EXPANDED_H <= CARD_HEIGHT) & (top0 >= 0))

    cols = _arange(EXPANDED_W, crop0)
    crop0 = torch.where((cols < cw[..., None])[..., None, :], crop0, 0)
    m = crop0.abs().amax(dim=(-2, -1))
    # a true division: a Python scalar over a tensor would be the
    # reciprocal times 255, rounded twice
    scale = torch.full_like(m, 255, dtype=torch.float32) / m.to(
        torch.float32).clamp(min=1e-6)
    crop = torch.round(crop0.to(torch.float32) * scale[..., None, None]).to(
        crop0.dtype)
    crop = torch.where((m > 0)[..., None, None], crop, crop0)
    crop = torch.where(crop > 100, crop, 0)

    # column shave, down to TRIM_W columns: ties drop the left one
    n_col = EXPANDED_W - TRIM_W + 1                           # 8 ends a side
    col_sums = crop.sum(dim=-2)
    n_shaves = cw - TRIM_W
    lc = _shave(col_sums[..., :n_col],
                _take(col_sums, cw[..., None] - 1 - _arange(n_col, crop0)),
                n_shaves)
    rc = cw - 1 - (n_shaves - lc)

    # row shave: the crop is always 21 rows, so always 5 shaves
    n_row = EXPANDED_H - TRIM_H + 1
    in_cols = (cols >= lc[..., None]) & (cols <= rc[..., None])
    row_sums = torch.where(in_cols[..., None, :], crop, 0).sum(dim=-1)
    tr = _shave(row_sums[..., :n_row],
                row_sums[..., EXPANDED_H - n_row:].flip(-1), n_row - 1)
    return ((top0 + tr).to(torch.int32), (left0 + lc).to(torch.int32), valid)


def slash_probs_conv(slash_mlp, bands, roffs, lefts):
    """P(slash) for every candidate window: the slash MLP (is_slash,
    expiry_seg.cpp:29-54) on the 11x16 scharr crop / 255, in float32, as
    the compiled reference and the host oracle compute it.

    The JAX package folds the crop into its first-layer product and rounds
    both factors to bfloat16 (the band values, up to 4080, and hidden_w /
    255): its TPU's input type. That moves a probability by up to ~0.05,
    and across the 0.7 threshold where the C++ reads no slash (frame 9 of
    session 50 of tools/parity_ab.py's expiry sweep: 0.69296 in the C++,
    0.70704 rounded), so the port does not round.

    slash_mlp: the slash models.Mlp; bands: (S, 3, 21, 428) int; roffs,
    lefts: (S, 3, K) window positions relative to the band (roffs clipped
    to [0, 6), lefts to [0, 417]). Returns (S, 3, K) probabilities."""
    n_r = bands.shape[-2] - TRIM_H + 1                    # 6 row offsets
    cols = window_select(bands, lefts, TRIM_W)            # (S, 3, K, 21, 11)
    rows = (roffs.to(torch.int64).clamp(0, n_r - 1)[..., None]
            + _arange(TRIM_H, bands))                     # (S, 3, K, 16)
    crops = torch.gather(
        cols, -2, rows[..., None].expand(rows.shape + (TRIM_W,)))
    x = crops.flatten(-2).to(torch.float32) / torch.full(
        (), 255.0, dtype=torch.float32, device=crops.device)
    return slash_mlp(x)[..., 0]


def _process_stripe(sobel, base, stripe_sum, stripe_valid):
    """find_character_groups_for_stripe (expiry_seg.cpp:386-704) for the 3
    stripes of every stream. sobel: (S, 136, 428); base, stripe_sum,
    stripe_valid: (S, 3). Returns the regridded char geometry of each
    group: (char_lefts (S, 3, G, 16), group_top (S, 3, G), char_width
    (S, 3, G), alive (S, 3, G, 16))."""
    base = base.clamp(1, CARD_HEIGHT - BAND_H)
    band = _band_rows(sobel, (base - _SCHARR_BASE).clamp(
        0, _BAND_ROWS - BAND_H), BAND_H)                  # (S, 3, 17, 428)
    col_sums = band.sum(dim=-2)
    rect_sums = col_sums.unfold(-1, SMALL_W, 1).sum(dim=-1)   # (S, 3, 420)

    rect_avg = (stripe_sum * SMALL_W) // CARD_WIDTH
    dim_thr = (rect_avg // 5)[..., None]
    cand = rect_sums > dim_thr
    n_cand = cand.sum(dim=-1)
    mean = torch.where(cand, rect_sums, 0).sum(dim=-1).to(
        torch.float32) / n_cand.clamp(min=1)
    sum_thr = (0.8 * mean)[..., None]
    cand = (cand & (rect_sums.to(torch.float32) > sum_thr)
            & stripe_valid[..., None])

    accepted = _nonoverlap_select(rect_sums, cand)

    # every group of a stripe regrids over rows [base - 1, base + 16)
    col_sums_grp = _band_rows(sobel, (base - 1 - _SCHARR_BASE).clamp(
        0, _BAND_ROWS - BAND_H), BAND_H).sum(dim=-2)      # (S, 3, 428)

    # the accepted lefts in ascending order; runs split where two are 18
    # or more apart
    n_slots = MAX_CHARS * MAX_GROUPS
    lefts_sorted, _ = _compact(accepted, _arange(N_RECT_POS, sobel),
                               n_slots, _ABSENT)          # (S, 3, 64)
    present = lefts_sorted != _ABSENT
    breaks = F.pad((lefts_sorted[..., 1:] - lefts_sorted[..., :-1])
                   >= 2 * SMALL_W, (1, 0)) & present
    gid = torch.where(present, torch.cumsum(breaks, dim=-1), -1)

    # the first MAX_GROUPS runs of 4 or more rects, left to right
    gids = _arange(n_slots, sobel)
    sizes = (gid[..., None, :] == gids[:, None]).sum(dim=-1)
    chosen, n_chosen = _compact(sizes >= 4, gids, MAX_GROUPS, _ABSENT)
    group_ok = _arange(MAX_GROUPS, sobel) < n_chosen[..., None]  # (S, 3, G)

    member = (gid[..., None, :] == chosen[..., None]) & present[..., None, :]
    n_m = member.sum(dim=-1).clamp(max=MAX_CHARS)         # (S, 3, G)
    chars = _arange(MAX_CHARS, sobel)
    take_ok = chars < n_m[..., None]
    per_group = lefts_sorted[..., None, :].expand(member.shape)
    raw_lefts = torch.where(
        take_ok, _take(per_group, chars + _first_true(member)[..., None]), 0)
    raw_sums = torch.where(
        take_ok, _take(rect_sums[..., None, :].expand(
            member.shape[:-1] + (N_RECT_POS,)), raw_lefts), 0)

    # whitespace strip on the raw run
    s1, c1 = _whitespace_strip(raw_sums, torch.zeros_like(n_m), n_m)
    first_left = _take(raw_lefts, s1[..., None])[..., 0]
    last_left = _take(raw_lefts, (s1 + c1 - 1)[..., None])[..., 0]
    width = last_left + SMALL_W - first_left

    bounds_left = (first_left - 2 * SMALL_W).clamp(min=0)
    bounds_right = (first_left + width + 2 * SMALL_W).clamp(max=CARD_WIDTH)
    r_lefts, r_sums, r_n, spacing = _regrid(
        col_sums_grp[..., None, :], bounds_left, bounds_right - bounds_left)

    # second whitespace strip, on the regridded run
    s2, c2 = _whitespace_strip(r_sums, torch.zeros_like(r_n),
                               r_n.clamp(max=MAX_CHARS))
    in_run = (chars >= s2[..., None]) & (chars < (s2 + c2)[..., None])
    top = (base - 1)[..., None].expand(spacing.shape)
    return r_lefts, top, spacing - 1, in_run & group_ok[..., None]


def best_expiry_seg_device(slash_mlp, y_img, vseg_y, enabled) -> ExpiryWindows:
    """best_expiry_seg (expiry_seg.cpp:706-902) for every stream.

    slash_mlp: the slash models.Mlp; y_img: (S, 270, 428) u8; vseg_y: (S,)
    int; enabled: (S,) bool gate (frame usable, the number row leaves >= 2
    char heights below). Returns up to MAX_WINDOWS MM/YY windows a
    stream."""
    y_start = (vseg_y + NUMBER_HEIGHT).clamp(0, CARD_HEIGHT - 1)
    sobel = scharr_dx_abs_below(y_img, y_start)
    bases, sums, stripe_ok = select_stripes(sobel, y_start)
    stripe_ok = stripe_ok & enabled[:, None]
    r_lefts, g_top, g_cw, alive0 = _process_stripe(sobel, bases, sums,
                                                   stripe_ok)
    n_streams, n_stripes, n_groups = g_top.shape

    # per-char trimming: all chars of a stripe share its 21-row band
    band_top = (g_top[:, :, 0] - 2).clamp(0, CARD_HEIGHT - EXPANDED_H)
    bands = _band_rows(sobel, (band_top - _SCHARR_BASE).clamp(
        0, _BAND_ROWS - EXPANDED_H), EXPANDED_H)          # (S, 3, 21, 428)
    lefts_flat = r_lefts.flatten(2)                       # (S, 3, G*16)
    crops = window_select(bands, lefts_flat - 2, EXPANDED_W)
    tops, lefts, valid = _trim_char(
        crops, lefts_flat,
        g_top[..., None].expand(r_lefts.shape).flatten(2),
        g_cw[..., None].expand(r_lefts.shape).flatten(2))
    char_alive = alive0 & valid.view(alive0.shape)

    # alive chars left to right within each group
    tops_c, n_alive = _compact(char_alive, tops.view(alive0.shape),
                               MAX_CHARS, 0)
    lefts_c, _ = _compact(char_alive, lefts.view(alive0.shape), MAX_CHARS, 0)

    # a window is 5 chars from `first`; its middle char must be a slash
    firsts = _arange(MAX_CHARS - 4, y_img)
    n_firsts = len(firsts)
    win_ok = ((firsts + 4 < n_alive[..., None]) & (n_alive[..., None] >= 5))
    mid_tops = tops_c[..., 2:2 + n_firsts]
    mid_lefts = lefts_c[..., 2:2 + n_firsts]
    slash_p = slash_probs_conv(
        slash_mlp, bands,
        (mid_tops - band_top[:, :, None, None]).flatten(2),
        mid_lefts.flatten(2))
    win_ok = win_ok & (slash_p.view(win_ok.shape) > 0.7)

    # the first MAX_WINDOWS candidates in (stripe, group, first) order, the
    # reference's append order; an empty slot reads candidate 0
    n_cand = n_stripes * n_groups * n_firsts
    pick, n_picked = _compact(win_ok.flatten(1), _arange(n_cand, y_img),
                              MAX_WINDOWS, 0)
    group, first = pick // n_firsts, pick % n_firsts
    chars = (group * MAX_CHARS + first)[..., None] + _arange(5, y_img)
    char_tops = _take(tops_c.flatten(1)[:, None].expand(-1, MAX_WINDOWS, -1),
                      chars)
    char_lefts = _take(lefts_c.flatten(1)[:, None].expand(-1, MAX_WINDOWS,
                                                          -1), chars)
    return ExpiryWindows(
        valid=_arange(MAX_WINDOWS, y_img) < n_picked[:, None],
        top=char_tops.amin(dim=-1).to(torch.int32),
        left=char_lefts[..., 0].to(torch.int32),
        char_tops=char_tops.to(torch.int32),
        char_lefts=char_lefts.to(torch.int32))


# ---------------------------------------------------------------------------
# categorization + cross-frame aggregation (expiry_categorize.cpp)
# ---------------------------------------------------------------------------

_DIGIT_CHARS = (0, 1, 3, 4)     # MM/YY without the slash


@functools.lru_cache(maxsize=None)
def _digit_chars(device):
    """_DIGIT_CHARS as an index tensor on `device`, made once: a step makes
    no tensor from host data, which a CUDA graph could not capture."""
    return torch.tensor(_DIGIT_CHARS, device=device)


def categorize_windows(expiry_conv, y_img, windows: ExpiryWindows):
    """Per window, classify chars 0, 1, 3, 4 (expiry_categorize.cpp:
    149-252): 16x11 luma crop -> cross morph gradient -> equalize ->
    bilateral -> / 255 -> the expiry conv. Returns (S, W, 5, 10) scores,
    the slash row and invalid windows zero.

    Invalid windows read whatever rows their clipped positions give, inside
    the card's lower 136 rows like the JAX package's, and are zeroed at the
    end."""
    digit_idx = _digit_chars(y_img.device)
    band_tops = (windows.top - 2).clamp(0, CARD_HEIGHT - EXPANDED_H)
    bt_rel = (band_tops - _SCHARR_BASE).clamp(0, _BAND_ROWS - EXPANDED_H)
    ctops = windows.char_tops[..., digit_idx]             # (S, W, 4)
    clefts = windows.char_lefts[..., digit_idx]
    roff = (ctops - band_tops[..., None]).clamp(0, EXPANDED_H - TRIM_H)
    rows = ((_SCHARR_BASE + bt_rel[..., None] + roff).to(torch.int64)[
        ..., None] + _arange(TRIM_H, y_img))              # (S, W, 4, 16)
    cols = (clefts.to(torch.int64).clamp(0, CARD_WIDTH - TRIM_W)[..., None]
            + _arange(TRIM_W, y_img))                     # (S, W, 4, 11)
    streams = _arange(y_img.shape[0], y_img)[:, None, None, None, None]
    cells_u8 = y_img[streams, rows[..., None], cols[..., None, :]]

    sm = bilateral3x3(equalize_hist(morph_grad3_2d_cross_u8(cells_u8)))
    # a 0-d divisor: a CUDA tensor over a Python scalar multiplies by the
    # reciprocal
    cells = sm.to(torch.float32) / torch.full(
        (), 255.0, dtype=torch.float32, device=y_img.device)
    probs = expiry_conv(cells)                            # (S, W, 4, 10)
    scores = probs.new_zeros(probs.shape[:2] + (5, 10))
    scores[:, :, digit_idx] = probs
    return torch.where(windows.valid[..., None, None], scores, 0.0)


def aggregate_windows(state: ExpiryState, windows: ExpiryWindows,
                      scores) -> ExpiryState:
    """expiry_aggregate_grouped_rects (expiry_categorize.cpp:256-331) over
    the fixed slot table: EWMA-merge matches, decay, insert fresh.

    The JAX package's matching, not the reference's in-turn sweep: each new
    window is assigned to its first matching slot, and each slot merges its
    first assigned window; a later window matching the same slot stays
    unconsumed and may open a fresh slot."""
    new_valid = windows.valid
    new_top, new_left = windows.top, windows.left
    new_scores = scores
    win_idx = _arange(MAX_WINDOWS, new_top)

    # coalesce within the frame: window j > i folds into the first
    # equivalent i
    for i in range(MAX_WINDOWS):
        coalesced = torch.ones_like(new_top[:, 0], dtype=torch.float32)
        for j in range(MAX_WINDOWS - 1, i, -1):
            match = (new_valid[:, i] & new_valid[:, j] &
                     ((new_top[:, j] - new_top[:, i]).abs() <= V_ALLOW) &
                     ((new_left[:, j] - new_left[:, i]).abs() <= H_ALLOW))
            c = coalesced[:, None, None]
            merged = (new_scores[:, i] * c + new_scores[:, j]) / (c + 1.0)
            sel = match.to(torch.float32)[:, None, None]
            row = new_scores[:, i] * (1 - sel) + merged * sel
            new_scores = torch.where((win_idx == i)[:, None, None],
                                     row[:, None], new_scores)
            coalesced = coalesced + sel[:, 0, 0]
            new_valid = new_valid & ~((win_idx == j) & match[:, None])

    # slot-window match matrix (S, slots, W)
    near = (((new_top[:, None, :] - state.top[:, :, None]).abs() <= V_ALLOW) &
            ((new_left[:, None, :] - state.left[:, :, None]).abs()
             <= H_ALLOW))
    m = state.active[:, :, None] & new_valid[:, None, :] & near

    # each window -> first matching slot; each slot -> first assigned window
    slot_idx = _arange(MAX_SLOTS, new_top)
    win_slot = _first_true(m.transpose(1, 2))             # (S, W)
    assign = ((slot_idx[:, None] == win_slot[:, None, :]) &
              m.any(dim=1)[:, None, :])                   # (S, slots, W)
    slot_has = assign.any(dim=2)
    assign = assign & (win_idx == _first_true(assign)[..., None])

    def pick(select, values):
        """Per slot, the value of its selected window (0 if none)."""
        extra = (None,) * (values.dim() - 2)
        return torch.where(select[(...,) + extra], values[:, None],
                           0).sum(dim=2)

    picked_scores = pick(assign, new_scores)
    sel = slot_has[..., None, None]
    sc = torch.where(sel,
                     state.scores * EXPIRY_DECAY_FACTOR +
                     picked_scores * (1 - EXPIRY_DECAY_FACTOR),
                     state.scores)
    top = torch.where(slot_has, pick(assign, new_top), state.top)
    left = torch.where(slot_has, pick(assign, new_left), state.left)
    recently = state.recently_seen + slot_has
    total = state.total_seen + slot_has
    active = state.active

    remaining = new_valid & ~assign.any(dim=1)

    # decay + forget
    recently = torch.where(active, recently - 1, recently)
    active = active & (recently > 0)

    # the r-th remaining window goes into the r-th free slot
    free_rank = torch.cumsum(~active, dim=1) - 1          # (S, slots)
    new_rank = torch.cumsum(remaining, dim=1) - 1         # (S, W)
    pair = ((~active)[:, :, None] & remaining[:, None, :] &
            (free_rank[:, :, None] == new_rank[:, None, :]))
    take = pair.any(dim=2)
    sc = torch.where(take[..., None, None], pick(pair, new_scores), sc)
    top = torch.where(take, pick(pair, new_top), top)
    left = torch.where(take, pick(pair, new_left), left)
    recently = torch.where(take, 3, recently)
    total = torch.where(take, 1, total)
    active = active | take

    return ExpiryState(active=active, top=top.to(torch.int32),
                       left=left.to(torch.int32), scores=sc,
                       recently_seen=recently.to(torch.int32),
                       total_seen=total.to(torch.int32))


def extract_expiry(state: ExpiryState, best_month, best_year,
                   now_year, now_month, allow_past_dates=False):
    """Stable digits + date sanity over all trusted slots
    (expiry_categorize.cpp:334-501). best_month, best_year, now_year,
    now_month: (S,) int. Returns (month, full_year), (S,) int32.

    allow_past_dates mirrors the reference's DMZ_DEBUG/CYTHON_DMZ branch
    (expiry_categorize.cpp:382-397): a date that the shipped [now, now+5y)
    window refuses is still taken when < now+5y (years > 60 re-based to
    19xx). Its mixed 1900/2000 bases make the sweep order-dependent, so it
    runs the reference's prefer-later sweep slot by slot."""
    row_sum = state.scores.sum(dim=-1)                    # (S, slots, 5)
    row_max = state.scores.amax(dim=-1)
    stability = row_max / torch.where(row_sum > 0, row_sum, 1.0)
    digits = torch.argmax(state.scores, dim=-1)
    stable = (stability >= EXPIRY_MIN_STABILITY) & (row_sum > 0)

    trusted = state.active & (state.total_seen >= MIN_SEEN)
    all_stable = stable[..., _digit_chars(stable.device)].all(dim=-1)

    month = digits[..., 0] * 10 + digits[..., 1]
    year = digits[..., 3] * 10 + digits[..., 4]
    swap = (month > 12) & (year > 0) & (year <= 12)
    month, year = torch.where(swap, year, month), torch.where(swap, month,
                                                              year)
    full_year = year + 2000

    now_year, now_month = now_year[:, None], now_month[:, None]
    cand_ok = trusted & all_stable & (month > 0) & (month <= 12)
    window_ok = ((full_year < now_year + 5) &
                 ((full_year > now_year) |
                  ((full_year == now_year) & (month >= now_month))))

    if allow_past_dates:
        rebased = torch.where(year > 60, year + 1900, full_year)
        dbg_ok = rebased < now_year + 5
        bm, by = best_month, best_year
        for i in range(MAX_SLOTS):
            later = (full_year[:, i] > by) | ((full_year[:, i] == by) &
                                              (month[:, i] > bm))
            outer = cand_ok[:, i] & later
            acc_shipped = outer & window_ok[:, i]
            acc_dbg = outer & ~window_ok[:, i] & dbg_ok[:, i]
            by = torch.where(acc_shipped, full_year[:, i],
                             torch.where(acc_dbg, rebased[:, i], by))
            bm = torch.where(acc_shipped | acc_dbg, month[:, i], bm)
        return bm.to(torch.int32), by.to(torch.int32)

    # the latest valid date: the key is monotone in (year, month), month < 16
    key = torch.where(cand_ok & window_ok, full_year * 16 + month, -1)
    best_cand = key.amax(dim=1)
    take = best_cand > best_year * 16 + best_month
    return (torch.where(take, best_cand % 16, best_month).to(torch.int32),
            torch.where(take, best_cand // 16, best_year).to(torch.int32))
