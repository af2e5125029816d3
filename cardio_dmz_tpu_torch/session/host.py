"""The single-stream scanner an app drives frame by frame: the PAN on the
device, the expiry on the host.

Counterpart of the JAX package's session/host.py: the complete
scanner_add_frame_with_expiry surface (scan/scan.cpp:41-86) for offline and
single-stream use. The PAN path is the port's scanner_step at one stream,
on the device the models live on; the expiry path is the faithful host
implementation (scan/expiry_seg_host.py, scan/expiry_categorize_host.py),
whose model calls run on that device too. The batched in-graph expiry read
(scan/expiry_device.py) is what multi-stream serving uses.

The PAN step is graphed (parallel/graphed.graph_step), as the JAX
HostScanner jits it: captured at the first frame, replayed at every frame
after, the frame copied into the graph's static input. Each frame reads a
few scalars back from the device (the completion flag, the vseg row and
score): that is the shape of this API, one camera and one caller that
wants each frame's answer before the next.
"""

import time

import numpy as np
import torch

from ..constants import CARD_HEIGHT, MIN_VSEG_SCORE, SMALL_CHARACTER_HEIGHT
from ..parallel.graphed import graph_step
from ..scan.expiry_categorize_host import expiry_extract
from ..scan.expiry_seg_host import best_expiry_seg
from .state import (
    EXPIRY_GRACE_FRAMES,
    ScannerResult,
    scanner_reset,
    scanner_step,
)


def _one_stream(tree):
    """A stream-major (nested) NamedTuple of one stream, without its stream
    axis."""
    if isinstance(tree, tuple):
        return type(tree)(*(_one_stream(x) for x in tree))
    return tree[0]


class HostScanner:
    """Stateful convenience wrapper (the dmz_context + ScannerState role).

    params: load_all_params(device); the scanner runs on that device.
    now: (year, month) for the date sanity window, the wall clock's when
    None. collect_name_groups enables the name super-groups that the
    reference carries disabled (expiry_seg.cpp:544-548); allow_past_dates
    is its DMZ_DEBUG/CYTHON_DMZ date branch."""

    def __init__(self, params, scan_expiry=True, now=None,
                 collect_name_groups=False, allow_past_dates=False):
        self.params = params
        self.device = next(params["vseg_mlp"].buffers()).device
        self.scan_expiry = scan_expiry
        self.collect_name_groups = collect_name_groups
        self.allow_past_dates = allow_past_dates
        self.now = tuple(now or time.localtime()[:2])  # (year, month)
        self.reset()
        self._step = graph_step(
            lambda state, y: scanner_step(params, state, y, scan_expiry=False),
            self.device)

    def reset(self):
        self.state = scanner_reset(self.now, 1, self.device)
        self.expiry_groups = []
        self.name_groups = []
        self.expiry_month = 0
        self.expiry_year = 0

    def add_frame(self, y):
        """One 270x428 u8 frame (numpy). Returns (FrameResult,
        ScannerResult), the frame's fields without a stream axis."""
        y = np.ascontiguousarray(y, np.uint8)
        pre_complete = bool(self.state.number_complete[0])
        self.state, (frame, _result) = self._step(
            self.state, torch.from_numpy(y)[None])
        frame = _one_stream(frame)

        # scan.cpp:57 drops !usable frames, where `usable` is computed with
        # collect_card_number = still collecting (frame.cpp:49-69): the
        # number-score check gates the expiry only until the number
        # completes; afterwards the vseg-only gate applies.
        upside_down = bool(frame.upside_down)
        if pre_complete:
            session_usable = (float(frame.vseg.score) > MIN_VSEG_SCORE
                              and not upside_down)
        else:
            session_usable = bool(frame.usable)
        need_expiry = self.scan_expiry and (
            self.expiry_month == 0 or self.expiry_year == 0)
        if need_expiry and not upside_down and session_usable:
            y_off = int(frame.vseg.y_offset)
            if y_off < CARD_HEIGHT - 2 * SMALL_CHARACTER_HEIGHT:
                new_groups, name_groups = best_expiry_seg(
                    y, y_off, self.params["slash_mlp"],
                    collect_name_groups=self.collect_name_groups)
                self.name_groups = name_groups
                self.expiry_month, self.expiry_year = expiry_extract(
                    y, self.expiry_groups, new_groups,
                    self.params["expiry_conv"], now=self.now,
                    best_month=self.expiry_month,
                    best_year=self.expiry_year,
                    allow_past_dates=self.allow_past_dates)
        return frame, self.result()

    def result(self) -> ScannerResult:
        """scanner_result with the host expiry merged (scan.cpp:88-194):
        Python values and a (16,) numpy digit array."""
        st = self.state
        if not bool(st.number_complete[0]):
            return ScannerResult(
                complete=False, n_numbers=0,
                predictions=np.zeros(16, np.int32),
                expiry_month=0, expiry_year=0)
        expiry_found = self.expiry_month > 0 and self.expiry_year > 0
        grace_over = int(st.frames_since_complete[0]) > EXPIRY_GRACE_FRAMES
        complete = not self.scan_expiry or expiry_found or grace_over
        return ScannerResult(
            complete=complete,
            n_numbers=int(st.completed_n[0]),
            predictions=st.completed_digits[0].cpu().numpy(),
            expiry_month=self.expiry_month if complete else 0,
            expiry_year=self.expiry_year if complete else 0,
        )

    @property
    def card_number(self):
        if not bool(self.state.number_complete[0]):
            return None
        n = int(self.state.completed_n[0])
        return "".join(map(str, self.state.completed_digits[0, :n].tolist()))
