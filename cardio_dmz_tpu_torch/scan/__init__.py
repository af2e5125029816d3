from .vseg import VSeg, best_n_vseg  # noqa: F401
from .hseg import HSeg, best_n_hseg  # noqa: F401
from .categorize import number_scores  # noqa: F401
from .frame import FrameResult, scan_card_image  # noqa: F401
from .expiry_types import (  # noqa: F401
    CharacterRect, ExpiryPattern, GroupedRects)
from .expiry_seg_host import best_expiry_seg  # noqa: F401
from .expiry_categorize_host import expiry_extract  # noqa: F401
