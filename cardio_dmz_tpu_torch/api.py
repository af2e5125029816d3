"""The dmz.h surface of the camera path, stream-major.

Counterpart of the JAX package's api.py for what the camera step runs:

* focus_score / brightness_score              (dmz.cpp:183-195)
* detect_edges -> edges + corner points       (dmz.cpp:371-439)
* transform_card -> rectified 428x270 card    (dmz.cpp:443-497)
* preprocess_frame: both, as one step
* blur_card: median-blur the leading digits   (dmz.cpp:499-515), host numpy

Every function takes a leading stream axis S; orientation and the image
geometry are Python values, so the detection bands are static slices.
"""

import typing

import numpy as np
import torch

from .constants import (
    CARD_HEIGHT,
    CARD_WIDTH,
    HORIZONTAL_ANGLE,
    HORIZONTAL_PERCENT_SLOP,
    HOUGH_GRADIENT_ANGLE_THRESHOLD,
    HOUGH_THRESHOLD_LENGTH_DIVISOR,
    HOUGH_THETA_RES,
    LANDSCAPE_HORIZONTAL_PERCENT_INSET,
    LANDSCAPE_SAMPLE_HEIGHT,
    LANDSCAPE_SAMPLE_WIDTH,
    LANDSCAPE_VERTICAL_PERCENT_INSET,
    MAX_ANGLE_DEVIATION,
    NUMBER_HEIGHT,
    ORIENTATION_LANDSCAPE_LEFT,
    ORIENTATION_LANDSCAPE_RIGHT,
    ORIENTATION_PORTRAIT,
    ORIENTATION_PORTRAIT_UPSIDE_DOWN,
    PORTRAIT_HORIZONTAL_PERCENT_INSET,
    PORTRAIT_VERTICAL_PERCENT_INSET,
    VERTICAL_ANGLE,
    VERTICAL_PERCENT_SLOP,
)
from .ops import (
    adaptive_canny7,
    brightness_mean,
    hough_best_line,
    median_blur,
    sobel3_dx_dy,
    stddev_of_abs,
    unwarp_card,
)
from .utils.geometry import (
    line_by_shifting_origin_torch, parametric_intersect_torch)


# ---------------------------------------------------------------------------
# focus / brightness scoring
# ---------------------------------------------------------------------------

def card_rect_for_screen(card_w, card_h, std_w, std_h, actual_w, actual_h):
    """dmz_card_rect_for_screen (dmz.cpp:137-163). Host-side ints."""
    if 0 in (card_w, card_h, std_w, std_h, actual_w, actual_h):
        return (0, 0, 0, 0)
    if (actual_w, actual_h) == (std_w, std_h):
        w, h = card_w, card_h
    else:
        ratio = min(actual_w / std_w, actual_h / std_h)
        w, h = int(card_w * ratio), int(card_h * ratio)
    return ((actual_w - w) // 2, (actual_h - h) // 2, w, h)


def _scoring_roi(shape, use_full_image):
    """dmz_set_roi_for_scoring (dmz.cpp:165-181): the centre 1/9 of the
    card."""
    h, w = shape[-2], shape[-1]
    if use_full_image:
        cw, ch = CARD_WIDTH, CARD_HEIGHT
    else:
        cw, ch = CARD_WIDTH // 3, CARD_HEIGHT // 3
    return card_rect_for_screen(cw, ch, LANDSCAPE_SAMPLE_WIDTH,
                                LANDSCAPE_SAMPLE_HEIGHT, w, h)


def focus_score(image, use_full_image=False):
    """dmz_focus_score (dmz.cpp:183-188): stddev of the sobel3 cross
    derivative on the centre ROI. image: (S, H, W) u8 -> (S,) f32."""
    x, y, rw, rh = _scoring_roi(image.shape, use_full_image)
    return stddev_of_abs(sobel3_dx_dy(image[..., y:y + rh, x:x + rw]))


def brightness_score(image, use_full_image=False):
    """dmz_brightness_score (dmz.cpp:190-195). (S, H, W) u8 -> (S,) f32."""
    x, y, rw, rh = _scoring_roi(image.shape, use_full_image)
    return brightness_mean(image[..., y:y + rh, x:x + rw])


# ---------------------------------------------------------------------------
# edge detection
# ---------------------------------------------------------------------------

class FoundEdge(typing.NamedTuple):
    found: torch.Tensor  # (S,) bool
    rho: torch.Tensor    # (S,) f32, full-image coordinates
    theta: torch.Tensor  # (S,) f32


class CardEdges(typing.NamedTuple):
    top: FoundEdge
    bottom: FoundEdge
    left: FoundEdge
    right: FoundEdge


class CornerPoints(typing.NamedTuple):
    found_all: torch.Tensor     # (S,) bool
    top_left: torch.Tensor      # (S, 2) f32 (x, y)
    top_right: torch.Tensor
    bottom_left: torch.Tensor
    bottom_right: torch.Tensor


def detection_boxes(shape, orientation):
    """detection_boxes_for_sample (dmz.cpp:279-341). Static host math.
    Returns {edge: (x, y, w, h)}."""
    h, w = shape[-2], shape[-1]
    width = (h * 4) // 3
    left_margin = (w - width) // 2

    if orientation in (ORIENTATION_PORTRAIT,
                       ORIENTATION_PORTRAIT_UPSIDE_DOWN):
        inset_vert = int(round(PORTRAIT_HORIZONTAL_PERCENT_INSET * h))
        slop_vert = int(round(HORIZONTAL_PERCENT_SLOP * h))
        inset_horiz = int(round(PORTRAIT_VERTICAL_PERCENT_INSET * width))
        slop_horiz = int(round(VERTICAL_PERCENT_SLOP * width))
    elif orientation in (ORIENTATION_LANDSCAPE_LEFT,
                         ORIENTATION_LANDSCAPE_RIGHT):
        inset_vert = int(round(LANDSCAPE_VERTICAL_PERCENT_INSET * h))
        slop_vert = int(round(HORIZONTAL_PERCENT_SLOP * h))
        inset_horiz = int(round(LANDSCAPE_HORIZONTAL_PERCENT_INSET * width))
        slop_horiz = int(round(VERTICAL_PERCENT_SLOP * width))
    else:
        inset_vert = slop_vert = inset_horiz = slop_horiz = 0

    def inset_rect(x, y, rw, rh, dx, dy):
        return (x + dx, y + dy, rw - 2 * dx, rh - 2 * dy)

    ix, iy, iw, ih = (left_margin, 0, width - 1, h - 1)
    ox, oy, ow, oh = inset_rect(ix, iy, iw, ih, inset_horiz - slop_horiz,
                                inset_vert - slop_vert)
    nx, ny, nw, nh = inset_rect(ix, iy, iw, ih, inset_horiz + slop_horiz,
                                inset_vert + slop_vert)
    return {
        "top": (nx, oy, nw, 2 * slop_vert),
        "bottom": (nx, ny + nh, nw, 2 * slop_vert),
        "left": (ox, ny, 2 * slop_horiz, nh),
        "right": (nx + nw, ny, 2 * slop_horiz, nh),
    }


_EDGE_SPECS = (("top", False), ("bottom", False),
               ("left", True), ("right", True))
_RHO_MULTIPLIERS = (1.0, 2.0, 2.0)   # Cb/Cr are half size (dmz.cpp:383)


def _band_lines(samples, boxes):
    """The best line of each of the 12 detection bands (4 edges x the Y,
    Cb and Cr planes), best_line_for_sample (dmz.cpp:224-271): sobel7 ->
    canny with the band's adaptive thresholds -> the gated Hough.

    Bands of one shape and direction run as one batch over streams and
    bands (four batches for a 480x640 frame), each band on its own with a
    replicate border for sobel7 and a zero border for NMS, which is what
    the JAX package's packed canvases compute band by band. Returns
    {edge: [(is_null, rho, theta, x, y), ...]} in plane order, each
    tensor (S,)."""
    groups = {}
    for p, box_set in enumerate(boxes):
        for name, vertical in _EDGE_SPECS:
            x, y, w, h = box_set[name]
            groups.setdefault((h, w, vertical), []).append((p, name, x, y))

    found = {}
    for (h, w, vertical), members in groups.items():
        bands = torch.stack([samples[p][:, y:y + h, x:x + w]
                             for p, _, x, y in members], dim=1)
        n_streams, n_bands = bands.shape[:2]
        bands = bands.reshape(n_streams * n_bands, h, w)
        # sobel7 -> canny with the band's adaptive thresholds
        edges, dx, dy = adaptive_canny7(bands)

        base = VERTICAL_ANGLE if vertical else HORIZONTAL_ANGLE
        line = hough_best_line(
            edges, dx, dy, rho=1.0, theta=HOUGH_THETA_RES,
            threshold=max(w, h) // HOUGH_THRESHOLD_LENGTH_DIVISOR,
            theta_min=base - MAX_ANGLE_DEVIATION,
            theta_max=base + MAX_ANGLE_DEVIATION, vertical=vertical,
            gradient_angle_threshold=HOUGH_GRADIENT_ANGLE_THRESHOLD)
        line = [v.reshape(n_streams, n_bands) for v in line]
        for k, (p, name, x, y) in enumerate(members):
            found[(p, name)] = tuple(v[:, k] for v in line) + (x, y)

    return {name: [found[(p, name)] for p in range(len(samples))]
            for name, _ in _EDGE_SPECS}


def _select_edge(plane_lines):
    """find_line_in_detection_rects (dmz.cpp:346-369): the first plane,
    in Y, Cb, Cr order, whose band found a line."""
    is_null = plane_lines[0][0]
    found = torch.zeros_like(is_null)
    rho_out = torch.zeros(is_null.shape, dtype=torch.float32,
                          device=is_null.device)
    theta_out = torch.zeros_like(rho_out)
    for (is_null, rho, theta, x, y), mult in zip(plane_lines,
                                                 _RHO_MULTIPLIERS):
        rho, theta = line_by_shifting_origin_torch(rho, theta, x, y)
        rho = rho * mult
        take = ~is_null & ~found
        rho_out = torch.where(take, rho, rho_out)
        theta_out = torch.where(take, theta, theta_out)
        found = found | ~is_null
    return FoundEdge(found=found, rho=rho_out, theta=theta_out)


def detect_edges(y_sample, cb_sample, cr_sample,
                 orientation=ORIENTATION_LANDSCAPE_RIGHT):
    """dmz_detect_edges (dmz.cpp:371-439) for every stream.

    y_sample: (S, H, W) u8 (e.g. 480x640); cb/cr: (S, H/2, W/2) u8.
    Returns (CardEdges, CornerPoints); corners are in Y-plane pixels."""
    samples = (y_sample, cb_sample, cr_sample)
    boxes = [detection_boxes(s.shape, orientation) for s in samples]
    lines = _band_lines(samples, boxes)
    edges = CardEdges(**{name: _select_edge(lines[name])
                         for name, _ in _EDGE_SPECS})

    def isect(l1, l2):
        ok, x, y = parametric_intersect_torch(l1.rho, l1.theta, l2.rho,
                                              l2.theta)
        return ok, torch.stack([x, y], dim=-1)

    ok_tl, tl = isect(edges.top, edges.left)
    ok_bl, bl = isect(edges.bottom, edges.left)
    ok_tr, tr = isect(edges.top, edges.right)
    ok_br, br = isect(edges.bottom, edges.right)
    found_all = (edges.top.found & edges.bottom.found & edges.left.found
                 & edges.right.found & ok_tl & ok_bl & ok_tr & ok_br)
    return edges, CornerPoints(found_all=found_all, top_left=tl,
                               top_right=tr, bottom_left=bl,
                               bottom_right=br)


# ---------------------------------------------------------------------------
# transform
# ---------------------------------------------------------------------------

_CORNER_ORDER = {
    ORIENTATION_PORTRAIT: ("bl", "tl", "br", "tr"),
    ORIENTATION_LANDSCAPE_LEFT: ("br", "bl", "tr", "tl"),
    ORIENTATION_LANDSCAPE_RIGHT: ("tl", "tr", "bl", "br"),
    ORIENTATION_PORTRAIT_UPSIDE_DOWN: ("tr", "br", "tl", "bl"),
}


def _orientation_transposes(orientation):
    """Portrait quads lie ~90 degrees rotated in the frame; the warp
    resamples the transposed frame (ops/warp.py)."""
    return orientation in (ORIENTATION_PORTRAIT,
                           ORIENTATION_PORTRAIT_UPSIDE_DOWN)


def transform_card(sample, corner_points: CornerPoints,
                   orientation=ORIENTATION_LANDSCAPE_RIGHT, upsample=False):
    """dmz_transform_card (dmz.cpp:443-497): the corners in the
    orientation's order, then the exact perspective warp to 428x270.
    sample: (S, H, W) u8 plane; upsample=True for the half-size Cb/Cr
    planes (corner coordinates halved, dmz.cpp:473-481)."""
    cp = corner_points
    by_name = {"tl": cp.top_left, "tr": cp.top_right,
               "bl": cp.bottom_left, "br": cp.bottom_right}
    src = torch.stack([by_name[k] for k in _CORNER_ORDER[orientation]],
                      dim=1)                                # (S, 4, 2)
    if upsample:
        src = src / 2.0
    return unwarp_card(sample, src, out_shape=(CARD_HEIGHT, CARD_WIDTH),
                       transpose=_orientation_transposes(orientation))


def preprocess_frame(y_sample, cb_sample, cr_sample,
                     orientation=ORIENTATION_LANDSCAPE_RIGHT):
    """Detect each stream's card across the Y/Cb/Cr planes and rectify its
    luma plane to the 428x270 card (the reference's per-preview-frame host
    loop). Returns (found (S,) bool, card (S, 270, 428) u8, zero where not
    found)."""
    _, corners = detect_edges(y_sample, cb_sample, cr_sample, orientation)
    card = transform_card(y_sample, corners, orientation)
    card = torch.where(corners.found_all[:, None, None], card, 0)
    return corners.found_all, card


def blur_card(card_rgb, state, unblur_digits=4, stream=None):
    """dmz_blur_card (dmz.cpp:499-515): median-blur the digit cells but the
    last `unblur_digits`. A cosmetic step on the host, in numpy.

    card_rgb: (270, 428[, C]) numpy u8; state: the port's stream-major
    ScannerState, of which one stream's last segmentation is read
    (last_offsets, last_n_offsets, last_number_width, last_vseg_y).
    stream: which one; None only for a state of one stream."""
    if unblur_digits < 0:
        return card_rgb
    n_streams = state.last_n_offsets.shape[0]
    if stream is None:
        if n_streams != 1:
            raise ValueError(f"the state holds {n_streams} streams: say "
                             f"which stream's card this is")
        stream = 0
    img = np.array(card_rgb)
    n = int(state.last_n_offsets[stream])
    blur_count = n - unblur_digits
    offsets = state.last_offsets[stream].cpu().numpy()
    width = int(round(float(state.last_number_width[stream])))
    y0 = int(state.last_vseg_y[stream])
    for i in range(min(n, blur_count)):
        x = int(offsets[i]) - 1
        y = y0 - 1
        w = width + 2
        h = NUMBER_HEIGHT + 2
        if i < 4:
            h *= 2  # the smaller four digits below the first bucket
            #         (dmz.cpp:508)
        x0c, y0c = max(x, 0), max(y, 0)
        roi = img[y0c:y + h, x0c:x + w]
        if roi.size:
            img[y0c:y + h, x0c:x + w] = median_blur(roi, 25)
    return img
