"""Expiry segmentation/categorization types (scan/expiry_types.h).

CharacterRect / GroupedRects as light Python dataclasses for the host
pipeline (scan/expiry_seg_host.py, scan/expiry_categorize_host.py); the
device pipeline uses fixed-shape tensors instead (scan/expiry_device.py).
The port's own copy of the JAX package's scan/expiry_types.py.
"""

import dataclasses
import enum
import typing

import numpy as np

SMALL_CHAR_WIDTH = 9       # kSmallCharacterWidth
SMALL_CHAR_HEIGHT = 15     # kSmallCharacterHeight
TRIMMED_CHAR_WIDTH = 11    # kTrimmedCharacterImageWidth
TRIMMED_CHAR_HEIGHT = 16   # kTrimmedCharacterImageHeight
MIN_EXPIRY_STRIP_CHARS = 5  # kMinimumExpiryStripCharacters
MIN_NAME_STRIP_CHARS = 5
EXPIRY_MAX_VALID_LENGTH = 11


class ExpiryPattern(enum.IntEnum):
    MM_S_YY = 0          # ExpiryPatternMMsYY, the only pattern emitted today
    MM_S_20YY = 1
    XX_S_XX_S_YY = 2
    XX_S_XX_S_20YY = 3
    MM_D_MM_S_YY = 4
    MM_D_MM_S_20YY = 5
    MM_S_YY_D_MM_S_YY = 6


@dataclasses.dataclass
class CharacterRect:
    top: int
    left: int
    sum: int = 0


@dataclasses.dataclass
class GroupedRects:
    top: int
    left: int
    width: int
    height: int
    sum: int = 0
    character_width: int = SMALL_CHAR_WIDTH
    character_rects: typing.List[CharacterRect] = dataclasses.field(
        default_factory=list)
    pattern: ExpiryPattern = ExpiryPattern.MM_S_YY
    scores: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((EXPIRY_MAX_VALID_LENGTH, 10),
                                         np.float32))
    recently_seen_count: int = 0
    total_seen_count: int = 0
    grouped_yet: bool = False
