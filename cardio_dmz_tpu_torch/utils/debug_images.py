"""Debug image dumps of the expiry segmentation (DEBUG_EXPIRY_IMAGES).

Counterpart of the JAX package's utils/debug_images.py. The reference
saves per-stage PNGs during expiry segmentation (expiry_seg.cpp:15-20,
345-384, 506-526, 871-888 via ios_save_file); this module renders the same
views from the host segmentation (scan/expiry_seg_host.py), with the same
file names, and writes them as 8-bit grayscale PNGs with zlib and struct
from the standard library instead of PIL.

Usage:
    from cardio_dmz_tpu_torch.utils.debug_images import dump_expiry_stages
    paths = dump_expiry_stages(card_y, vseg_y, params["slash_mlp"], "dbg")
"""

import os
import struct
import zlib

import numpy as np


def write_png(path, gray):
    """An (h, w) uint8 array as an 8-bit grayscale PNG (every row filter
    0, one zlib stream)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), gray], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 9))
                + chunk(b"IEND", b""))


def _save(path, arr):
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        m = a.max()
        a = (a.astype(np.float64) * (255.0 / m if m > 0 else 1)).astype(
            np.uint8)
    write_png(path, a)
    return path


def _draw_rects(img, rects, value=255):
    """rects: iterable of (top, left, h, w)."""
    out = np.asarray(img).copy()
    hh, ww = out.shape
    for top, left, h, w in rects:
        t, l = max(top, 0), max(left, 0)
        b, r = min(top + h, hh - 1), min(left + w, ww - 1)
        out[t, l:r] = value
        out[b, l:r] = value
        out[t:b, l] = value
        out[t:b, r] = value
    return out


def dump_expiry_stages(card_y, starting_y_offset, slash_mlp, out_dir,
                       prefix="expiry"):
    """Run the host expiry segmentation and save one PNG per stage.

    card_y: (270, 428) uint8 card; starting_y_offset: the PAN row (vseg
    y offset); slash_mlp: the port's slash Mlp (load_all_params(...)
    ["slash_mlp"]). Returns the list of written paths (original, sobel,
    stripes, groups)."""
    from ..scan import expiry_seg_host as seg

    os.makedirs(out_dir, exist_ok=True)
    card_y = np.asarray(card_y)
    paths = []

    paths.append(_save(os.path.join(out_dir, f"{prefix}-a-original.png"),
                       card_y))

    sobel = seg.scharr_dx_abs_below(card_y, starting_y_offset)
    paths.append(_save(os.path.join(out_dir, f"{prefix}-b-sobel.png"),
                       np.clip(sobel // 16, 0, 255).astype(np.uint8)))

    stripes = seg.select_stripes(sobel, starting_y_offset)
    stripe_img = _draw_rects(
        card_y, [(b, 0, seg.SMALL_CHAR_HEIGHT, card_y.shape[1] - 1)
                 for b, _ in stripes])
    paths.append(_save(os.path.join(out_dir, f"{prefix}-d-stripes.png"),
                       stripe_img))

    groups, _ = seg.best_expiry_seg(card_y, starting_y_offset, slash_mlp)
    rects = []
    for g in groups:
        rects.append((g.top - 1, g.left - 1, g.height + 2, g.width + 2))
        for r in g.character_rects:
            rects.append((r.top, r.left, seg.TRIMMED_CHAR_HEIGHT,
                          seg.TRIMMED_CHAR_WIDTH))
    paths.append(_save(os.path.join(out_dir, f"{prefix}-h-groups.png"),
                       _draw_rects(card_y, rects)))
    return paths
