"""Synthetic training data for the scan's models.

Counterpart of the JAX package's train/data.py. Each generator takes an
np.random.RandomState and draws from it in the same order as the JAX
package's, and takes its glyph masks from a table instead of PIL
(train/glyphs.py), so one seed gives the same batches in both packages,
bit for bit. The inputs go through the same preprocessing chains as
serving (the port's ops, on CPU tensors); outputs are numpy, as the JAX
generators' are.

Generators (model -> (inputs, labels)):
* pan digit conv (27x19 cells, [0,1] f32)        synthetic_digit_batch
* vseg MLP (204-sample strip rows, 3 classes)    synthetic_vseg_batch
* slash MLP (16x11 scharr crops /255, 2 classes) synthetic_slash_batch
* expiry digit conv (prepare_image_for_cat prep) synthetic_expiry_digit_batch
"""

import numpy as np
import torch

from ..ops import (
    bilateral3x3, equalize_hist, lineardown2_1d_u8, morph_grad3_1d_u8,
    morph_grad3_2d_cross_u8, norm_convert_minmax, scharr3_dx_abs)
from .glyphs import (
    CARD_BG, EXPIRY_CELL, PAN_CELL, _digit_mask, _emboss_delta,
    expiry_digit_mask)

# Relief glyphs by default (real card characters are raised ridges); a
# share of flat-ink cells as augmentation, as in the JAX package.
FLAT_FRAC = 0.25

# visa 4-4-4-4 / amex 4-6-5 pattern masks (n_vseg.cpp:28-31)
_PATTERN_VISA = [1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1]
_PATTERN_AMEX = [1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1]


def _ink_delta(rng, mask, bg=CARD_BG, flat_frac=FLAT_FRAC):
    """Luma DELTA (int array, add to a bg-valued canvas) shading an ink
    mask as relief under a randomized light, or as flat dark ink."""
    if rng.uniform() < flat_frac:
        fill = int(rng.randint(40, 90))
        return np.round((fill - bg) * mask).astype(np.int32)
    av = int(rng.randint(16, 29))     # around EMBOSS_AV=22
    ah = int(rng.randint(18, 33))     # around EMBOSS_AH=25
    tint = int(rng.randint(-70, -40))  # around EMBOSS_TINT=-55
    return _emboss_delta(mask, av=av, ah=ah, tint=tint)


def synthetic_digit_batch(rng, batch_size, bg=CARD_BG, noise=6):
    """(cells (B, 27, 19) f32 in [0,1], labels (B,) int32). Relief digits
    (flat-ink augmentation, `_ink_delta`) with jitter and noise, scaled
    to [0, 1] without the serving digit prep, as the JAX package trains."""
    h, w = PAN_CELL
    cells = np.zeros((batch_size, h, w), np.uint8)
    labels = rng.randint(0, 10, batch_size).astype(np.int32)
    for i, d in enumerate(labels):
        m = _digit_mask(int(d))
        jx, jy = rng.randint(-1, 2), rng.randint(-1, 2)
        m = np.roll(np.roll(m, jy, axis=0), jx, axis=1)
        a = bg + _ink_delta(rng, m, bg)
        a = a + rng.randint(-noise, noise + 1, (h, w))
        cells[i] = np.clip(a, 0, 255)
    return cells.astype(np.float32) / 255.0, labels


def _render_pan_block(rng, pattern, width=18.0, offset=30, bg=CARD_BG,
                      noise=4, rows=60, pan_top=16):
    """A (rows, 428) card slab with a PAN row at pan_top following
    `pattern`. One ink mask for the whole row, shaded as relief or flat
    (`_ink_delta`: cards share one lighting)."""
    y = np.full((rows, 428), bg, np.int32)
    if noise:
        y += rng.randint(-noise, noise + 1, y.shape)
    mask = np.zeros((rows, 428), np.float32)
    for k, m in enumerate(pattern):
        if not m:
            continue
        g = _digit_mask(rng.randint(0, 10))
        x0 = offset + int(round(k * width))
        mask[pan_top:pan_top + 27, x0 + 2:x0 + 21] = np.maximum(
            mask[pan_top:pan_top + 27, x0 + 2:x0 + 21], g)
    y += _ink_delta(rng, mask, bg)
    return np.clip(y, 0, 255).astype(np.uint8)


def synthetic_vseg_batch(rng, batch_size):
    """Strip rows through the vseg prep (1-D morph gradient -> 2x
    downsample -> min-max normalize, n_vseg.cpp:39-47).

    Returns (x (B, 204) f32, labels (B,) int32): 0 = background row,
    1 = row crossing a visa-pattern PAN, 2 = amex-pattern.
    """
    rows = np.zeros((batch_size, 408), np.uint8)
    labels = np.zeros((batch_size,), np.int32)
    i = 0
    while i < batch_size:
        pat_label = int(rng.randint(0, 3))
        pattern = _PATTERN_VISA if pat_label != 2 else _PATTERN_AMEX
        block = _render_pan_block(
            rng, pattern, width=float(rng.uniform(17.3, 19.5)),
            offset=int(rng.randint(25, 45)))
        take = min(4, batch_size - i)
        for _ in range(take):
            if pat_label == 0:
                # background: rows above/below the digit band
                r = int(rng.choice([rng.randint(0, 10),
                                    rng.randint(50, 60)]))
            else:
                # rows through the digit ink (glyphs span ~rows 20-37)
                r = int(rng.randint(22, 36))
            rows[i] = block[r, 10:418]
            labels[i] = pat_label
            i += 1
    grad = morph_grad3_1d_u8(torch.from_numpy(rows))
    x = norm_convert_minmax(lineardown2_1d_u8(grad), dim=-1)
    return x.numpy().astype(np.float32), labels


def _render_expiry_char(rng, ch, bg=CARD_BG, noise=3):
    """A (16, 11) luma cell holding `ch` (a digit, "/" or " ") in the
    expiry glyph style, shaded as relief by default (`_ink_delta`; flat
    ink as augmentation). A digit draws its jitter from rng first."""
    h, w = EXPIRY_CELL
    mask = np.zeros((h, w), np.float32)
    if ch == "/":
        # the slash stroke
        for r in range(h):
            c = int(round((1.0 - r / (h - 1)) * (w - 3)))
            mask[r, max(c, 0):min(c + 2, w)] = 1.0
    elif ch != " ":
        jx, jy = rng.randint(-1, 2), rng.randint(-1, 1)
        mask = expiry_digit_mask(int(ch), jx, jy)
    cell = np.full((h, w), bg, np.int32) + _ink_delta(rng, mask, bg)
    if noise:
        cell += rng.randint(-noise, noise + 1, cell.shape)
    return np.clip(cell, 0, 255).astype(np.uint8)


def synthetic_slash_batch(rng, batch_size):
    """Slash-vs-other crops through the slash prep: scharr3 |dx| of the
    luma, 16x11 crop, scaled by 1/255 (expiry_seg.cpp:50-54 is_slash).

    Returns (x (B, 176) f32, labels (B,) int32): 0 = slash (the MLP's
    class order: P(slash) is output 0), 1 = not-slash.
    """
    cells = np.zeros((batch_size,) + EXPIRY_CELL, np.uint8)
    labels = np.zeros((batch_size,), np.int32)
    digits = "0123456789"
    for i in range(batch_size):
        is_slash = bool(rng.randint(0, 2))
        ch = "/" if is_slash else rng.choice(list(digits + "  "))
        cells[i] = _render_expiry_char(rng, ch)
        labels[i] = 0 if is_slash else 1
    sob = scharr3_dx_abs(torch.from_numpy(cells)).numpy()
    x = (sob.astype(np.float32) / 255.0).reshape(batch_size, -1)
    return x, labels


def synthetic_expiry_digit_batch(rng, batch_size):
    """Expiry digit cells through the categorization prep chain: morph
    gradient -> equalize -> 3x3 bilateral -> [0,1] f32
    (prepare_image_for_cat, expiry_categorize.cpp:37-73). The mean is
    subtracted inside the model (apply_expiry_conv), as in the reference.

    Returns (cells (B, 16, 11) f32, labels (B,) int32).
    """
    raw = np.zeros((batch_size,) + EXPIRY_CELL, np.uint8)
    labels = rng.randint(0, 10, batch_size).astype(np.int32)
    for i, d in enumerate(labels):
        raw[i] = _render_expiry_char(rng, str(d))
    cells = bilateral3x3(equalize_hist(morph_grad3_2d_cross_u8(
        torch.from_numpy(raw))))
    return cells.numpy().astype(np.float32) / 255.0, labels
