"""Synthetic card-frame rendering, without PIL.

Counterpart of the JAX package's synthetic.py (numpy + PIL): Luhn-valid
PANs and 270x428 rectified card frames with the PAN row drawn flat or
embossed, plus the expiry slash stroke. Every digit mask it draws is one
of the ten PAN glyphs, so it takes them from the glyph table of
train/glyphs.py (data/train_glyphs.npz, written from the JAX package's own
rendering) with the relief shading kept there; the frames come out bit
for bit as the JAX package draws them, on a machine without PIL.

Left out: render_text_small and render_frame_with_expiry, which composite
expiry text with PIL's font rasterizer at positions the caller picks; the
fixtures carry the expiry cards the port's checks need.
"""

import numpy as np

from .constants import PATTERN_MASKS
from .train.glyphs import CARD_BG, _digit_mask, _emboss_delta

DIGIT_FILL = 60
SAFE_DIGITS = tuple(range(10))


def render_digit_cell(digit, seed=0, fill=DIGIT_FILL, bg=CARD_BG,
                      style="flat"):
    """One 27x19 digit cell on the card background + mild noise.

    style="flat": dark printed ink (fill on bg). style="emboss":
    directional-light relief of the same glyph (glyphs._emboss_delta)."""
    r = np.random.RandomState(seed)
    m = _digit_mask(digit)
    if style == "emboss":
        a = bg + _emboss_delta(m)
    else:
        a = np.round(bg + (fill - bg) * m).astype(np.int32)
    a = a + r.randint(-4, 5, (27, 19))
    return np.clip(a, 0, 255).astype(np.uint8)


def render_frame(pan, y0=160, width=18.0, offset=30, seed=0, bg=CARD_BG,
                 noise=4, brightness=0, contrast=1.0, shading=0,
                 style="flat"):
    """A full 270x428 rectified card frame with `pan` on the PAN row.

    pan: string of 15 (amex spacing) or 16 (visa spacing) digits.
    brightness/contrast: global photometric perturbation applied last
    (camera exposure sweep). shading: peak amplitude of a smooth random
    illumination gradient across the card (textured/unevenly lit card).
    style: "flat" printed ink or "emboss" relief glyphs.
    """
    r = np.random.RandomState(seed)
    y = np.full((270, 428), bg, np.int32)
    if noise:
        y += r.randint(-noise, noise + 1, y.shape)
    pan = str(pan)
    pattern = PATTERN_MASKS[1] if len(pan) == 16 else PATTERN_MASKS[2]
    digit_idx = 0
    for k, m in enumerate(pattern):
        if not m:
            continue
        x0 = offset + int(round(k * width))
        cell = render_digit_cell(int(pan[digit_idx]), seed=seed * 100 + k,
                                 bg=bg, style=style)
        region = y[y0:y0 + 27, x0:x0 + 19]
        delta = cell.astype(np.int32) - bg
        y[y0:y0 + 27, x0:x0 + 19] = region + delta
        digit_idx += 1
    if shading:
        gy, gx = r.uniform(-1, 1, 2)
        rows = np.linspace(-0.5, 0.5, 270)[:, None]
        cols = np.linspace(-0.5, 0.5, 428)[None, :]
        y += np.round(shading * (gy * rows + gx * cols)).astype(np.int32)
    if contrast != 1.0 or brightness:
        y = np.round((y - bg) * contrast + bg + brightness).astype(np.int32)
    return np.clip(y, 0, 255).astype(np.uint8)


def luhn_check_digit(prefix_digits):
    """Check digit making prefix+check Luhn-valid."""
    total = 0
    n = len(prefix_digits) + 1
    for i, d in enumerate(prefix_digits):
        # position from end within full number: n-1-i; doubled if odd
        mult = 2 if (n - 1 - i) % 2 == 1 else 1
        a = d * mult
        total += a % 10 + a // 10
    return (10 - total % 10) % 10


def safe_pan(rng, length=16, prefix=(4,)):
    """Random Luhn-valid PAN using only SAFE_DIGITS (retry on unsafe check)."""
    while True:
        body = [int(rng.choice(SAFE_DIGITS))
                for _ in range(length - 1 - len(prefix))]
        digits = list(prefix) + body
        c = luhn_check_digit(digits)
        if c in SAFE_DIGITS:
            return "".join(map(str, digits + [c]))


def draw_expiry_slash(y, top, left, w=7, h=15, fill=DIGIT_FILL, thick=3,
                      style="flat"):
    """Diagonal slash stroke (bottom-left -> top-right) on a copy of y.

    The reference's slash MLP was trained on real embossed card slashes;
    this stroke passes its 0.7 gate (expiry_seg.cpp:50-54). style="emboss"
    renders the same stroke as a relief instead of flat ink."""
    y = np.asarray(y).copy()
    if style == "emboss":
        m = np.zeros((h + 2, w + thick + 1), np.float32)
        for r in range(h):
            c = int(round((h - 1 - r) * (w - 1) / (h - 1)))
            m[r + 1, c:c + thick] = 1.0
        d = _emboss_delta(m)
        reg = y[top - 1:top - 1 + m.shape[0], left:left + m.shape[1]]
        y[top - 1:top - 1 + m.shape[0], left:left + m.shape[1]] = np.clip(
            reg.astype(np.int32) + d[:reg.shape[0], :reg.shape[1]],
            0, 255).astype(y.dtype)
        return y
    for r in range(h):
        c = left + int(round((h - 1 - r) * (w - 1) / (h - 1)))
        y[top + r, c:c + thick] = fill
    return y
