"""Synthetic card-frame rendering, without PIL.

Counterpart of the JAX package's synthetic.py (numpy + PIL): Luhn-valid
PANs and 270x428 rectified card frames with the PAN row drawn flat or
embossed, the expiry slash stroke, and dated cards (render_text_small,
render_frame_with_expiry). Every digit mask of the PAN row is one of the
ten PAN glyphs, so it takes them from the glyph table of train/glyphs.py
(data/train_glyphs.npz, written from the JAX package's own rendering) with
the relief shading kept there. The expiry text's digits come from
data/expiry_glyphs.npz: each one's coverage mask as PIL's FreeType
rasterizer draws it, and its offset and text box, composited here with
PIL's own blend of a mask into an 8-bit image. The frames come out bit
for bit as the JAX package draws them, on a machine without PIL.
"""

import functools
import os

import numpy as np

from .constants import PATTERN_MASKS
from .train.glyphs import CARD_BG, _digit_mask, _emboss_delta

DIGIT_FILL = 60
SAFE_DIGITS = tuple(range(10))
EXPIRY_GLYPHS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "expiry_glyphs.npz")
# the expiry font's sizes whose glyphs EXPIRY_GLYPHS holds
EXPIRY_FONT_SIZES = (18,)


def render_digit_cell(digit, seed=0, fill=DIGIT_FILL, bg=CARD_BG,
                      style="flat", relief=None):
    """One 27x19 digit cell on the card background + mild noise.

    style="flat": dark printed ink (fill on bg). style="emboss":
    directional-light relief of the same glyph (glyphs._emboss_delta);
    relief: its (vertical amplitude, horizontal amplitude, face tint),
    glyphs.EMBOSS_AV, EMBOSS_AH and EMBOSS_TINT when None."""
    r = np.random.RandomState(seed)
    m = _digit_mask(digit)
    if style == "emboss":
        a = bg + _emboss_delta(m, *(relief or ()))
    else:
        a = np.round(bg + (fill - bg) * m).astype(np.int32)
    a = a + r.randint(-4, 5, (27, 19))
    return np.clip(a, 0, 255).astype(np.uint8)


def render_frame(pan, y0=160, width=18.0, offset=30, seed=0, bg=CARD_BG,
                 noise=4, brightness=0, contrast=1.0, shading=0,
                 style="flat", relief=None):
    """A full 270x428 rectified card frame with `pan` on the PAN row.

    pan: string of 15 (amex spacing) or 16 (visa spacing) digits.
    brightness/contrast: global photometric perturbation applied last
    (camera exposure sweep). shading: peak amplitude of a smooth random
    illumination gradient across the card (textured/unevenly lit card).
    style: "flat" printed ink or "emboss" relief glyphs; relief: the
    emboss's (vertical, horizontal, tint), as render_digit_cell takes it.
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
                                 bg=bg, style=style, relief=relief)
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


EXPIRY_SAFE_DIGITS = (0, 1, 2, 3, 4, 5, 7, 8, 9)  # 6's glyph is marginal

# Dates the compiled reference reads correctly with this renderer (the JAX
# package's, bit for bit), measured over 16-frame sessions. The reference's
# date sanity window (expiry_categorize.cpp:334-399) accepts dates in [now,
# now + 5 years], so a test must also pick an in-window date. Failures
# outside this list cluster on the "6"/"0" glyphs' trim alignment (the
# font is not the embossed training font), not on the pipeline.
RELIABLE_EXPIRY_DATES = (
    "01/27", "02/27", "03/27", "04/27", "05/27", "07/27", "09/27", "11/27",
    "12/27", "01/28", "02/28", "03/28", "04/28", "07/28", "08/28", "09/28",
    "11/28", "12/28",
)


def draw_expiry_slash(y, top, left, w=7, h=15, fill=DIGIT_FILL, thick=3,
                      style="flat", relief=None):
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
        d = _emboss_delta(m, *(relief or ()))
        reg = y[top - 1:top - 1 + m.shape[0], left:left + m.shape[1]]
        y[top - 1:top - 1 + m.shape[0], left:left + m.shape[1]] = np.clip(
            reg.astype(np.int32) + d[:reg.shape[0], :reg.shape[1]],
            0, 255).astype(y.dtype)
        return y
    for r in range(h):
        c = left + int(round((h - 1 - r) * (w - 1) / (h - 1)))
        y[top + r, c:c + thick] = fill
    return y


@functools.lru_cache(maxsize=None)
def _expiry_glyphs():
    """[(coverage mask (h, w) uint8, (dx, dy) of the mask from the drawing
    position, text box (x0, y0, x1, y1) at the origin)] of the digits 0-9
    in the expiry font (DejaVu Sans Mono Bold 18)."""
    with np.load(EXPIRY_GLYPHS) as t:
        return [(t["mask"][d, :h, :w], tuple(t["offset"][d]),
                 tuple(t["bbox"][d]))
                for d, (h, w) in enumerate(t["mask_shape"])]


def _blend_mask(out, mask, x, y, ink):
    """PIL's draw_bitmap of an 8-bit coverage mask into an 8-bit image at
    (x, y), clipped to the image: each pixel becomes
    (out * (255 - m) + ink * m) / 255, rounded as PIL's DIV255 rounds."""
    h, w = mask.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, out.shape[0]), min(x + w, out.shape[1])
    if y0 >= y1 or x0 >= x1:
        return
    m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int32)
    t = out[y0:y1, x0:x1].astype(np.int32) * (255 - m) + ink * m + 128
    out[y0:y1, x0:x1] = ((t >> 8) + t) >> 8


def render_text_small(y, text, y0, x0, size=15, fill=DIGIT_FILL, spacing=None,
                      style="flat", relief=None):
    """Render small text (an expiry "08/27") onto a copy of frame y.

    text holds digits, "/" and " ". Digits use the reference-tuned expiry
    font, centred in an 11x16 box on a `spacing`-pitch grid (None = 13);
    "/" is the embossed slash stroke; a space draws nothing (size was the
    JAX package's font size for other characters, and a space leaves no
    ink in any). style="emboss": relief glyphs from the same ink masks
    (_emboss_delta, with `relief` as render_digit_cell takes it) instead of
    flat ink. Another character raises a ValueError."""
    if spacing is None:
        spacing = 13
    base = np.asarray(y)
    emboss = style == "emboss"
    canvas = np.zeros(base.shape, np.uint8) if emboss else base.copy()
    glyphs = _expiry_glyphs()
    slash_positions = []
    for i, ch in enumerate(text):
        if ch == "/":
            slash_positions.append(i)
            continue
        if ch == " ":
            continue
        if ch not in "0123456789":
            raise ValueError(f"render_text_small draws digits, '/' and ' '; "
                             f"got {ch!r} in {text!r}")
        mask, (dx, dy), (bx0, by0, bx1, by1) = glyphs[int(ch)]
        # centre the ink in an 11x16 window on the spacing grid
        x = x0 + i * spacing + (11 - (bx1 - bx0)) // 2 - bx0
        yy = y0 + (16 - (by1 - by0)) // 2 - by0
        _blend_mask(canvas, mask, x + dx, yy + dy, 255 if emboss else fill)
    if emboss:
        m = canvas.astype(np.float32) / 255.0
        out = np.clip(base.astype(np.int32)
                      + _emboss_delta(m, *(relief or ())),
                      0, 255).astype(np.uint8)
    else:
        out = canvas
    for i in slash_positions:
        out = draw_expiry_slash(out, y0, x0 + i * spacing + 1, fill=fill,
                                style=style, relief=relief)
    return out


def render_frame_with_expiry(pan, expiry_text, y0=150, width=18.0, offset=30,
                             expiry_y=None, expiry_x=120, seed=0, bg=CARD_BG,
                             noise=1, expiry_size=15, expiry_spacing=13,
                             style="flat", relief=None):
    """Card frame with a PAN row and an expiry line below it (expiry_y
    defaults to 35 rows below the PAN row). style="emboss": both lines as
    relief glyphs, with `relief` as render_digit_cell takes it."""
    y = render_frame(pan, y0=y0, width=width, offset=offset, seed=seed,
                     bg=bg, noise=noise, style=style, relief=relief)
    if expiry_y is None:
        expiry_y = y0 + 27 + 35
    return render_text_small(y, expiry_text, expiry_y, expiry_x,
                             size=expiry_size, spacing=expiry_spacing,
                             style=style, relief=relief)


def paste_card(card, quad, shape=(480, 640), bg=50):
    """A 270x428 u8 card pasted into a `shape` u8 preview so that its
    corners (0, 0), (427, 0), (0, 269), (427, 269) land on quad (4, 2)
    (x, y), under that perspective; `bg` where no card pixel lands (and
    where one samples as 0, as the JAX package's accuracy tools paste a
    card with warp_perspective and fill 0).

    Each preview pixel samples the card bilinearly at the inverse map of
    its coordinates: the unit square -> quad projective map in closed form
    and its adjugate, in float64, element by element (no linear-algebra
    library, whose summation order can differ between machines), so a
    seed draws the same preview bits on any machine."""
    (x0, y0), (x1, y1), (x3, y3), (x2, y2) = np.asarray(quad, np.float64)
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    if dx3 == 0.0 and dy3 == 0.0:
        g = h = 0.0
    else:
        den = dx1 * dy2 - dx2 * dy1
        g = (dx3 * dy2 - dx2 * dy3) / den
        h = (dx1 * dy3 - dx3 * dy1) / den
    a, b, c = x1 - x0 + g * x1, x3 - x0 + h * x3, x0
    d, e, f = y1 - y0 + g * y1, y3 - y0 + h * y3, y0
    py, px = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    u = (e - f * h) * px + (c * h - b) * py + (b * f - c * e)
    v = (f * g - d) * px + (a - c * g) * py + (c * d - a * f)
    w = (d * h - e * g) * px + (b * g - a * h) * py + (a * e - b * d)
    ch, cw = card.shape
    sx = u / w * (cw - 1)
    sy = v / w * (ch - 1)
    fx0, fy0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - fx0, sy - fy0
    ix, iy = fx0.astype(np.int64), fy0.astype(np.int64)
    img = np.asarray(card, np.float64)

    def tap(r, col):
        ok = (r >= 0) & (r < ch) & (col >= 0) & (col < cw)
        return np.where(ok, img[r.clip(0, ch - 1), col.clip(0, cw - 1)], 0.0)

    top = tap(iy, ix) * (1 - fx) + tap(iy, ix + 1) * fx
    bot = tap(iy + 1, ix) * (1 - fx) + tap(iy + 1, ix + 1) * fx
    out = np.round(top * (1 - fy) + bot * fy).astype(np.uint8)
    return np.where(out > 0, out, bg).astype(np.uint8)
