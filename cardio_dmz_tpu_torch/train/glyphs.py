"""The glyphs of the synthetic training data, without PIL.

The JAX package's generators draw their digits with PIL (its
synthetic._digit_mask and train/data._render_expiry_char). Every mask they
draw depends only on the digit, and for an expiry character on its jitter
(jx in {-1, 0, 1}, jy in {-1, 0}), so the port takes the masks from a
table: data/train_glyphs.npz, written by tests/torch_fixture.py from the
JAX package's own rendering. With it the port's generators draw the same
numpy RandomState stream and make the same batches on a machine without
PIL. The hand-drawn 6 and 7, the relief shading and the card's background
are copies of the JAX package's synthetic.py.
"""

import functools
import os

import numpy as np

GLYPH_TABLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "train_glyphs.npz")

CARD_BG = 140
PAN_CELL = (27, 19)
EXPIRY_CELL = (16, 11)

_STROKE_GLYPHS = {
    # (r0, c0, r1, c1) filled rectangles in the 27x19 cell: Farrington-7B
    # style 6 and 7, the shapes no system font has
    6: [(3, 4, 24, 7), (13, 4, 16, 15), (22, 4, 24, 15), (13, 12, 24, 15)],
    7: [(3, 3, 6, 16), (3, 11, 24, 14)],
}

EMBOSS_AV = 22        # vertical relief amplitude (top-lit)
EMBOSS_AH = 25        # horizontal relief amplitude (left-lit)
EMBOSS_TINT = -55     # stroke-face tint relative to the card background


@functools.lru_cache(maxsize=None)
def _glyph_table():
    """(pan (10, 27, 19), expiry (10, 3, 2, 16, 11)) float32 masks in
    [0, 1]; expiry[d, jx + 1, jy + 1] is digit d drawn at jitter (jx, jy)."""
    with np.load(GLYPH_TABLE) as table:
        return table["pan_digits"], table["expiry_digits"]


def _emboss_delta(mask, av=None, ah=None, tint=None):
    """Relief shading delta (int array, same shape) from an ink mask in
    [0, 1]: top/left edges bright, bottom/right edges dark, the face
    tinted. Add to the background region."""
    av = EMBOSS_AV if av is None else av
    ah = EMBOSS_AH if ah is None else ah
    tint = EMBOSS_TINT if tint is None else tint
    m = np.asarray(mask, np.float32)
    up = np.zeros_like(m)
    dn = np.zeros_like(m)
    lf = np.zeros_like(m)
    rt = np.zeros_like(m)
    up[1:, :] = m[:-1, :]
    dn[:-1, :] = m[1:, :]
    lf[:, 1:] = m[:, :-1]
    rt[:, :-1] = m[:, 1:]
    d = av * (up - dn) + ah * (lf - rt) + tint * m
    return np.round(d).astype(np.int32)


def _digit_mask(digit):
    """Ink mask in [0, 1] for one 27x19 PAN digit cell."""
    digit = int(digit)
    if digit in _STROKE_GLYPHS:
        m = np.zeros(PAN_CELL, np.float32)
        for (r0, c0, r1, c1) in _STROKE_GLYPHS[digit]:
            m[r0:r1, c0:c1] = 1.0
        return m
    return _glyph_table()[0][digit].copy()


def expiry_digit_mask(digit, jx, jy):
    """Ink mask in [0, 1] of one 16x11 expiry digit cell, the glyph shifted
    by jx in {-1, 0, 1} columns and jy in {-1, 0} rows."""
    if not (-1 <= jx <= 1 and -1 <= jy <= 0):
        raise ValueError(f"expiry glyph jitter ({jx}, {jy}) is outside the "
                         f"table")
    return _glyph_table()[1][int(digit), jx + 1, jy + 1].copy()
