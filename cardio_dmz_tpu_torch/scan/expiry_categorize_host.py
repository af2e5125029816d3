"""Expiry categorization and cross-frame aggregation on the host.

Faithful equivalent of scan/expiry_categorize.cpp: per MM/YY group,
classify the 4 digit characters (positions 0, 1, 3, 4) with the expiry
conv net, then aggregate scores across frames with an EWMA, a stability
gate and date sanity checks. The oracle for the device path and the expiry
half of session/host.HostScanner. The groups and the aggregation are
Python lists on the host, as in the JAX package; the character crops go
through the port's image ops and ExpiryConv on the device the model lives
on, all of a frame's crops in one batch.
"""

import numpy as np
import torch

from ..constants import (
    EXPIRY_DECAY_FACTOR,
    EXPIRY_MIN_STABILITY,
)
from ..ops import bilateral3x3, equalize_hist, morph_grad3_2d_cross_u8
from ..parallel.mesh import named_device
from .expiry_types import (
    EXPIRY_MAX_VALID_LENGTH,
    ExpiryPattern,
    GroupedRects,
    TRIMMED_CHAR_HEIGHT,
    TRIMMED_CHAR_WIDTH,
)

# group-coalescing tolerances (expiry_categorize.cpp:23-24)
VERTICAL_ALLOWANCE = TRIMMED_CHAR_HEIGHT // 2     # 8
HORIZONTAL_ALLOWANCE = TRIMMED_CHAR_WIDTH // 2    # 5
MIN_SEEN_COUNT = 3                                 # expiry_categorize.cpp:483
FRESH_RECENTLY_SEEN = 3                            # expiry_categorize.cpp:324


_DIGIT_CHARS = (0, 1, 3, 4)     # MM/YY without the slash


def prepare_chars_for_cat(card_y, positions, device):
    """prepare_image_for_cat (expiry_categorize.cpp:37-73) for a list of
    (top, left) positions: 11x16 luma crop -> cross morph gradient ->
    equalize -> 3x3 bilateral -> [0, 1] f32, as one (N, 16, 11) batch on
    `device`."""
    card_y = np.asarray(card_y)
    crops = np.stack([card_y[top:top + TRIMMED_CHAR_HEIGHT,
                             left:left + TRIMMED_CHAR_WIDTH]
                      for top, left in positions])
    cells = torch.from_numpy(np.ascontiguousarray(crops, np.uint8)).to(device)
    sm = bilateral3x3(equalize_hist(morph_grad3_2d_cross_u8(cells)))
    # a 0-d divisor: a CUDA tensor over a Python scalar multiplies by the
    # reciprocal
    return sm.to(torch.float32) / torch.full(
        (), 255.0, dtype=torch.float32, device=sm.device)


def prepare_char_for_cat(card_y, top, left, device=None):
    """One character's prepared (16, 11) f32 cell, as numpy, computed on
    `device` (the CUDA device when None)."""
    device = named_device(device, "prepare_char_for_cat")
    return prepare_chars_for_cat(card_y, [(top, left)], device)[0].cpu(
        ).numpy()


def categorize_groups(card_y, groups, expiry_conv):
    """expiry_categorize.cpp:149-252 (NUMBER_OF_MODELS == 1) for a list of
    groups: per character 0, 1, 3, 4 run the conv net; row 2 (the slash)
    stays zero. One batch through the prep and the model. Returns one
    (11, 10) f32 score array a group."""
    if not groups:
        return []
    positions = [(g.character_rects[ci].top, g.character_rects[ci].left)
                 for g in groups for ci in _DIGIT_CHARS]
    device = expiry_conv.hidden_w.device
    probs = expiry_conv(prepare_chars_for_cat(card_y, positions, device))
    probs = probs.reshape(len(groups), len(_DIGIT_CHARS), 10).cpu().numpy()
    out = []
    for p in probs:
        scores = np.zeros((EXPIRY_MAX_VALID_LENGTH, 10), np.float32)
        scores[list(_DIGIT_CHARS)] = p
        out.append(scores)
    return out


def categorize_expiry_digits(card_y, group: GroupedRects, expiry_conv):
    """categorize_groups for one group: its (11, 10) scores."""
    return categorize_groups(card_y, [group], expiry_conv)[0]


def aggregate_grouped_rects(aggregated, new_groups):
    """expiry_aggregate_grouped_rects (expiry_categorize.cpp:256-331):
    coalesce within new, EWMA-merge into aggregated, decay unseen, add
    fresh. Mutates and returns `aggregated`."""
    # coalesce equivalent groups within new_groups
    i = 0
    while i < len(new_groups):
        g1 = new_groups[i]
        coalesced = 1.0
        j = len(new_groups) - 1
        while j > i:
            g2 = new_groups[j]
            if (abs(g2.top - g1.top) <= VERTICAL_ALLOWANCE and
                    abs(g2.left - g1.left) <= HORIZONTAL_ALLOWANCE and
                    len(g2.character_rects) == len(g1.character_rects)):
                g1.scores = ((g1.scores * coalesced + g2.scores)
                             / (coalesced + 1))
                coalesced += 1
                new_groups.pop(j)
            j -= 1
        i += 1

    # merge with existing groups
    for old in aggregated:
        j = len(new_groups) - 1
        while j >= 0:
            new = new_groups[j]
            if (abs(new.top - old.top) <= VERTICAL_ALLOWANCE and
                    abs(new.left - old.left) <= HORIZONTAL_ALLOWANCE and
                    len(new.character_rects) == len(old.character_rects)):
                old.recently_seen_count += 1
                old.total_seen_count += 1
                old.scores = (old.scores * EXPIRY_DECAY_FACTOR +
                              new.scores * (1 - EXPIRY_DECAY_FACTOR))
                old.top = new.top
                old.left = new.left
                new_groups.pop(j)
            j -= 1

    # decay and forget
    k = len(aggregated) - 1
    while k >= 0:
        aggregated[k].recently_seen_count -= 1
        if aggregated[k].recently_seen_count <= 0:
            aggregated.pop(k)
        k -= 1

    # add fresh groups
    for new in new_groups:
        new.recently_seen_count = FRESH_RECENTLY_SEEN
        new.total_seen_count = 1
        aggregated.append(new)
    return aggregated


def stable_expiry_digits(group: GroupedRects):
    """Per-char argmax if stability >= 0.7, else None
    (get_stable_expiry_month_and_year, expiry_categorize.cpp:402-445)."""
    digits = []
    for i in range(len(group.character_rects)):
        row = group.scores[i]
        s = row.sum()
        if s <= 0:
            digits.append(None)
            continue
        stability = row.max() / s
        digits.append(int(row.argmax())
                      if stability >= EXPIRY_MIN_STABILITY else None)
    return digits


def expiry_from_digits(digits, pattern, best_month, best_year, now,
                       allow_past_dates=False):
    """expiry_string_to_expiry_month_and_year (expiry_categorize.cpp:334-399).

    now: (year, month). Returns possibly-updated (month, full_year).
    allow_past_dates mirrors the reference's DMZ_DEBUG/CYTHON_DMZ branch
    (expiry_categorize.cpp:382-397): when the shipped [now, now+5y) window
    rejects, any date < now+5y is still accepted (years > 60 re-based to
    19xx). Serving keeps the shipped False."""
    month = year = -1
    if pattern == ExpiryPattern.MM_S_YY:
        if (len(digits) >= 5 and digits[0] is not None and
                digits[1] is not None and digits[3] is not None and
                digits[4] is not None):
            month = digits[0] * 10 + digits[1]
            year = digits[3] * 10 + digits[4]
    if month > 12 and 0 < year <= 12:
        month, year = year, month
    full_year = year + 2000
    if month > 0 and month <= 12 and (
            full_year > best_year or
            (full_year == best_year and month > best_month)):
        current_year, current_month = now
        if (full_year < current_year + 5 and
                (full_year > current_year or
                 (full_year == current_year and month >= current_month))):
            return month, full_year
        if allow_past_dates:
            if year > 60:
                full_year = year + 1900
            if full_year < current_year + 5:
                return month, full_year
    return best_month, best_year


def expiry_extract(card_y, aggregated_groups, new_groups, expiry_conv, now,
                   best_month=0, best_year=0, allow_past_dates=False):
    """expiry_extract (expiry_categorize.cpp:448-501).

    Mutates aggregated_groups; returns (month, full_year) (0, 0 if not yet
    stable). `now` = (year, month): a parameter rather than a wall-clock
    read, so that the logic is pure. expiry_conv: the port's ExpiryConv
    module. allow_past_dates: see expiry_from_digits."""
    if not new_groups:
        return best_month, best_year
    for g, scores in zip(new_groups,
                         categorize_groups(card_y, new_groups, expiry_conv)):
        g.scores = scores
    aggregate_grouped_rects(aggregated_groups, new_groups)
    for g in aggregated_groups:
        if g.total_seen_count < MIN_SEEN_COUNT:
            continue
        digits = stable_expiry_digits(g)
        best_month, best_year = expiry_from_digits(
            digits, g.pattern, best_month, best_year, now,
            allow_past_dates=allow_past_dates)
    return best_month, best_year
