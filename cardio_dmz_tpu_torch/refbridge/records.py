"""The port's results in the oracle's record form, and back.

Tests, tools and fixtures compare the port with the compiled C++ through
these adapters, not each in its own way:

* FrameRecord: the fields of a frame scan both sides report (usable, the
  vseg row and pattern, the hseg offsets and width, the digits and their
  scores), from a port FrameResult (frame_records, one a stream) or a
  RefFrameResult (ref_frame_record);
* group_to_ref / group_from_ref: an expiry GroupedRects <-> RefGroupResult;
* corner_array / corner_points: the camera CornerPoints <-> the oracle's
  (4, 2) corner arrays, in its order tl, tr, bl, br.
"""

import typing

import numpy as np
import torch

from ..api import CornerPoints
from ..scan.expiry_types import CharacterRect, ExpiryPattern, GroupedRects
from .oracle import RefGroupResult

CORNER_ORDER = ("top_left", "top_right", "bottom_left", "bottom_right")


class FrameRecord(typing.NamedTuple):
    usable: bool
    vseg_y_offset: int
    vseg_pattern_type: int
    hseg_n_offsets: int
    hseg_offsets: tuple      # the first hseg_n_offsets offsets
    hseg_number_width: float
    digits: tuple            # argmax of each of the first n score rows
    scores: np.ndarray       # (16, 10) f32

    def same_segmentation(self, other):
        """usable, vseg and hseg (offsets) equal."""
        return (self.usable == other.usable
                and self.vseg_y_offset == other.vseg_y_offset
                and self.vseg_pattern_type == other.vseg_pattern_type
                and self.hseg_n_offsets == other.hseg_n_offsets
                and self.hseg_offsets == other.hseg_offsets)


def make_record(usable, y_offset, pattern, n, offsets, width, scores):
    """A FrameRecord from its fields: offsets (>= n,), scores (16, 10)."""
    scores = np.asarray(scores, np.float32).reshape(16, 10)
    n = int(n)
    return FrameRecord(
        usable=bool(usable), vseg_y_offset=int(y_offset),
        vseg_pattern_type=int(pattern), hseg_n_offsets=n,
        hseg_offsets=tuple(int(o) for o in np.asarray(offsets)[:n]),
        hseg_number_width=float(width),
        digits=tuple(int(d) for d in scores.argmax(1)[:n]), scores=scores)


def frame_records(frame):
    """A stream-major port FrameResult -> [FrameRecord], one a stream."""
    def host(x):
        return x.detach().cpu().numpy()

    cols = [host(frame.usable), host(frame.vseg.y_offset),
            host(frame.vseg.pattern_type), host(frame.hseg.n_offsets),
            host(frame.hseg.offsets), host(frame.hseg.number_width),
            host(frame.scores)]
    return [make_record(*(c[i] for c in cols)) for i in range(len(cols[0]))]


def ref_frame_record(ref):
    """A RefFrameResult -> FrameRecord."""
    offsets = np.zeros(16, np.int64)
    offsets[:ref.hseg_n_offsets] = ref.hseg_offsets
    return make_record(ref.usable, ref.vseg_y_offset, ref.vseg_pattern_type,
                   ref.hseg_n_offsets, offsets, ref.hseg_number_width,
                   ref.scores)


def group_to_ref(group: GroupedRects) -> RefGroupResult:
    """A host expiry group as the oracle's RefGroupResult."""
    return RefGroupResult(
        top=group.top, left=group.left, width=group.width,
        height=group.height, character_width=group.character_width,
        pattern=int(group.pattern),
        recently_seen_count=group.recently_seen_count,
        total_seen_count=group.total_seen_count,
        char_tops=[r.top for r in group.character_rects],
        char_lefts=[r.left for r in group.character_rects],
        char_sums=[r.sum for r in group.character_rects],
        scores=np.asarray(group.scores, np.float32).reshape(11, 10).copy())


def group_from_ref(ref: RefGroupResult) -> GroupedRects:
    """An oracle RefGroupResult as a host expiry group."""
    sums = list(ref.char_sums) + [0] * (len(ref.char_tops)
                                        - len(ref.char_sums))
    scores = np.zeros((11, 10), np.float32) if ref.scores is None else \
        np.asarray(ref.scores, np.float32).reshape(11, 10).copy()
    return GroupedRects(
        top=ref.top, left=ref.left, width=ref.width, height=ref.height,
        character_width=ref.character_width,
        character_rects=[CharacterRect(t, l, s) for t, l, s in
                         zip(ref.char_tops, ref.char_lefts, sums)],
        pattern=ExpiryPattern(ref.pattern), scores=scores,
        recently_seen_count=ref.recently_seen_count,
        total_seen_count=ref.total_seen_count)


def corner_array(corners: CornerPoints):
    """Stream-major CornerPoints -> (found (S,) bool, (S, 4, 2) f32
    corners in the oracle's order tl, tr, bl, br), as numpy."""
    pts = torch.stack([getattr(corners, k) for k in CORNER_ORDER], dim=1)
    return (corners.found_all.detach().cpu().numpy(),
            pts.detach().cpu().numpy().astype(np.float32))


def corner_points(corners, found=None, device="cpu") -> CornerPoints:
    """(S, 4, 2) corners in the oracle's order (tl, tr, bl, br) ->
    CornerPoints on `device`; found (S,) bool, all True when None."""
    pts = torch.as_tensor(np.asarray(corners, np.float32), device=device)
    if found is None:
        found = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    return CornerPoints(
        torch.as_tensor(found, device=device),
        *(pts[:, k] for k in range(len(CORNER_ORDER))))
