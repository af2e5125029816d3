"""Pure utilities: Luhn, card type from prefix, guide frame, rects/points
(the reference's dmz_olm.h / dmz_olm.cpp). Two forms where it matters:

* plain-Python versions mirroring the C++ exactly, for host-side use
  (passes_luhn_checksum, card_info_for_prefix_and_length; dmz_olm.cpp:
  40-130);
* tensor versions, per stream on the device (luhn_checksum,
  card_type_valid: the JAX package's luhn_checksum_jax and
  card_type_valid_jax), which run the acceptance gate of
  scan/scan.cpp:149-160 without a host round trip.
"""

import functools
from dataclasses import dataclass
from enum import IntEnum

import torch

from ..constants import (
    LANDSCAPE_HORIZONTAL_PERCENT_INSET,
    LANDSCAPE_VERTICAL_PERCENT_INSET,
    ORIENTATION_LANDSCAPE_LEFT,
    ORIENTATION_LANDSCAPE_RIGHT,
    ORIENTATION_PORTRAIT,
    ORIENTATION_PORTRAIT_UPSIDE_DOWN,
    PORTRAIT_HORIZONTAL_PERCENT_INSET,
    PORTRAIT_VERTICAL_PERCENT_INSET,
)


class CardType(IntEnum):
    # values match dmz_olm.h's CardType enum semantics
    UNRECOGNIZED = 0
    AMBIGUOUS = 1
    AMEX = 2
    JCB = 3
    VISA = 4
    MASTERCARD = 5
    DISCOVER = 6
    MAESTRO = 7


@dataclass(frozen=True)
class CardInfo:
    card_type: CardType
    number_length: int
    prefix_length: int
    min_prefix: int
    max_prefix: int


# BIN table (dmz_olm.cpp:59-81)
CARD_TABLE = (
    CardInfo(CardType.MASTERCARD, 16, 4, 2221, 2720),
    CardInfo(CardType.DISCOVER,   14, 3, 300, 305),
    CardInfo(CardType.DISCOVER,   14, 3, 309, 309),
    CardInfo(CardType.AMEX,       15, 2, 34, 34),
    CardInfo(CardType.JCB,        16, 4, 3528, 3589),
    CardInfo(CardType.DISCOVER,   14, 2, 36, 36),
    CardInfo(CardType.DISCOVER,   14, 2, 38, 39),
    CardInfo(CardType.AMEX,       15, 2, 37, 37),
    CardInfo(CardType.VISA,       16, 1, 4, 4),
    CardInfo(CardType.MAESTRO,    16, 2, 50, 50),
    CardInfo(CardType.MASTERCARD, 16, 2, 51, 55),
    CardInfo(CardType.MAESTRO,    16, 2, 56, 59),
    CardInfo(CardType.DISCOVER,   16, 4, 6011, 6011),
    CardInfo(CardType.MAESTRO,    16, 2, 61, 61),
    CardInfo(CardType.DISCOVER,   16, 2, 62, 62),
    CardInfo(CardType.MAESTRO,    16, 2, 63, 63),
    CardInfo(CardType.DISCOVER,   16, 3, 644, 649),
    CardInfo(CardType.DISCOVER,   16, 2, 65, 65),
    CardInfo(CardType.MAESTRO,    16, 2, 66, 69),
    CardInfo(CardType.DISCOVER,   16, 2, 88, 88),
)


def passes_luhn_checksum(digits) -> bool:
    """Exact mirror of dmz_passes_luhn_checksum (dmz_olm.cpp:40-49)."""
    even = 0
    total = 0
    for d in reversed(list(digits)):
        addend = int(d) * (1 << (even & 1))
        even += 1
        total += addend % 10 + addend // 10
    return total % 10 == 0


def card_info_for_prefix_and_length(digits,
                                    allow_incomplete=False) -> CardInfo:
    """Exact mirror of dmz_card_info_for_prefix_and_length
    (dmz_olm.cpp:51-130)."""
    digits = list(int(d) for d in digits)
    n = len(digits)
    unrecognized = CardInfo(CardType.UNRECOGNIZED, -1, 1, 9, 9)
    ambiguous = CardInfo(CardType.AMBIGUOUS, -1, 1, 9, 9)
    if n == 0:
        return unrecognized
    found = unrecognized
    n_compatible = 0
    for info in CARD_TABLE:
        if allow_incomplete:
            if n > info.number_length:
                continue
        elif n != info.number_length:
            continue
        relevant = info.prefix_length
        factor = 1
        while relevant > n:
            factor *= 10
            relevant -= 1
        prefix = 0
        for j in range(relevant):
            prefix = prefix * 10 + digits[j]
        if info.min_prefix // factor <= prefix <= info.max_prefix // factor:
            n_compatible += 1
            found = info
    if n_compatible == 1:
        return found
    if n_compatible > 1:
        return ambiguous
    return unrecognized


# ---------------------------------------------------------------------------
# tensor versions for the scanner's acceptance gate
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _table_columns(device):
    """CARD_TABLE's numeric columns as int32 tensors on `device`, built
    once: a per-call upload from the host would stall the stream."""
    return {field: torch.tensor([getattr(i, field) for i in CARD_TABLE],
                                dtype=torch.int32, device=device)
            for field in ("number_length", "prefix_length", "min_prefix",
                          "max_prefix")}


def luhn_checksum(digits, n_digits):
    """Luhn validity of digits[:, :n_digits] (dmz_olm.cpp:40-49): doubling
    starts from the second-to-last active digit.
    digits: (S, 16) int; n_digits: (S,) int -> (S,) bool."""
    digits = digits.to(torch.int32)
    idx = torch.arange(16, dtype=torch.int32, device=digits.device)
    from_end = n_digits.to(torch.int32)[:, None] - 1 - idx     # (S, 16)
    active = from_end >= 0
    addend = digits * torch.where(from_end % 2 == 1, 2, 1)
    contrib = addend % 10 + addend // 10
    return torch.where(active, contrib, 0).sum(dim=1) % 10 == 0


def card_type_valid(digits, n_digits):
    """The prefix gate of scan.cpp:150-153: True iff exactly one BIN-table
    entry of length n_digits matches the leading digits.
    digits: (S, 16) int; n_digits: (S,) int -> (S,) bool."""
    digits = digits.to(torch.int32)
    # prefixes of lengths 1..4
    p = [digits[:, 0]]
    for j in range(1, 4):
        p.append(p[-1] * 10 + digits[:, j])
    prefixes = torch.stack(p, dim=1)                             # (S, 4)

    col = _table_columns(digits.device)
    vals = prefixes[:, col["prefix_length"].long() - 1]         # (S, 20)
    match = ((col["number_length"] == n_digits.to(torch.int32)[:, None])
             & (vals >= col["min_prefix"]) & (vals <= col["max_prefix"]))
    return match.sum(dim=1) == 1


# ---------------------------------------------------------------------------
# rects / points / guide frame
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Point:
    x: float
    y: float


@dataclass(frozen=True)
class Rect:
    x: float
    y: float
    w: float
    h: float


def rect_points(rect: Rect):
    """dmz_rect_get_points (dmz_olm.cpp:31-36): tl, tr, bl, br."""
    return (
        Point(rect.x, rect.y),
        Point(rect.x + rect.w, rect.y),
        Point(rect.x, rect.y + rect.h),
        Point(rect.x + rect.w, rect.y + rect.h),
    )


def scale_point(p: Point, src: Rect, dst: Rect) -> Point:
    """dmz_scale_point (dmz_olm.cpp:20-23)."""
    return Point(
        dst.x + (p.x - src.x) * dst.w / src.w,
        dst.y + (p.y - src.y) * dst.h / src.h,
    )


def guide_frame(orientation, preview_width, preview_height) -> Rect:
    """dmz_guide_frame (dmz_olm.cpp:134-164)."""
    if orientation in (ORIENTATION_PORTRAIT,
                       ORIENTATION_PORTRAIT_UPSIDE_DOWN):
        inset_w = PORTRAIT_HORIZONTAL_PERCENT_INSET * preview_width
        inset_h = PORTRAIT_VERTICAL_PERCENT_INSET * preview_height
    elif orientation in (ORIENTATION_LANDSCAPE_LEFT,
                         ORIENTATION_LANDSCAPE_RIGHT):
        inset_w = LANDSCAPE_VERTICAL_PERCENT_INSET * preview_width
        inset_h = LANDSCAPE_HORIZONTAL_PERCENT_INSET * preview_height
    else:
        inset_w = 0.0
        inset_h = 0.0
    return Rect(inset_w, inset_h,
                preview_width - 2.0 * inset_w, preview_height - 2.0 * inset_h)


def opposite_orientation(orientation):
    """dmz_opposite_orientation (dmz_olm.cpp:166-179)."""
    return {
        ORIENTATION_PORTRAIT: ORIENTATION_PORTRAIT_UPSIDE_DOWN,
        ORIENTATION_PORTRAIT_UPSIDE_DOWN: ORIENTATION_PORTRAIT,
        ORIENTATION_LANDSCAPE_RIGHT: ORIENTATION_LANDSCAPE_LEFT,
        ORIENTATION_LANDSCAPE_LEFT: ORIENTATION_LANDSCAPE_RIGHT,
    }.get(orientation, ORIENTATION_PORTRAIT)
