"""Luhn and BIN-table checks on the device, per stream.

Counterparts of the JAX package's utils/olm.py luhn_checksum_jax and
card_type_valid_jax (the reference's dmz_olm.cpp:40-130), which run the
acceptance gate of scan/scan.cpp:149-160 without a host round trip.
"""

import functools
from dataclasses import dataclass
from enum import IntEnum

import torch


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
