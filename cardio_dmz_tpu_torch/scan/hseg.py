"""Horizontal segmentation: find the 15/16 digit x-offsets, per stream.

Counterpart of the JAX package's scan/hseg.py `best_n_hseg`, which
reproduces the reference's 4-stage coarse-to-fine search (scan/
n_hseg.cpp:88-152) exactly: the same float32 width chains, lrintf
round-half-even stamp centers, strict-< carry between stages, and
width-major/offset-minor first-min order.

Score for candidate (w, o): L1 distance between the normalized column-sum
gradient profile and a template stamping the 19-sample digit pattern at
o + lrint(k*w) for each masked digit k (n_hseg.cpp:54-72).

The width chains and template banks are host numpy, copied from the JAX
package (tests/test_torch_constants.py holds the tables equal). At run
time the offset windows and the per-stage templates are plain gathers; the
JAX package's Hankel bank and one-hot selects stand in for gathers on the
TPU and are not ported.
"""

import functools
import typing

import numpy as np
import torch

from ..constants import (
    CARD_WIDTH,
    HSEG_GRAD_SUM_PATTERN,
    HSEG_WIDTH_MAX,
    HSEG_WIDTH_MIN,
    NUMBER_WIDTH,
    PATTERN_LENGTH_FOR_PATTERN,
    PATTERN_MASKS,
)
from ..ops import morph_grad3_2d_cross_u8
from ..ops.prefix import cumsum


class HSeg(typing.NamedTuple):
    """NHorizontalSegmentation (scan/n_hseg.h:13-19), one row per stream."""
    n_offsets: torch.Tensor       # (S,) int32 (15 / 16)
    number_width: torch.Tensor    # (S,) float32
    pattern_offset: torch.Tensor  # (S,) int32
    offsets: torch.Tensor         # (S, 16) int32 digit cell left edges
    score: torch.Tensor           # (S,) float32, lower is better


def grad_profile(y_strip):
    """Column sum of the 2-D morph gradient, min-max normalized to [0, 1]
    (n_hseg.cpp:88-96). y_strip: (..., 27, 428) u8 -> (..., 428) f32."""
    col = morph_grad3_2d_cross_u8(y_strip).to(torch.float32).sum(dim=-2)
    mn = col.amin(dim=-1, keepdim=True)
    mx = col.amax(dim=-1, keepdim=True)
    rng = torch.where(mx > mn, mx - mn, 1.0)
    return (col - mn) / rng


# ---------------------------------------------------------------------------
# Host tables of the reference-exact 4-stage search (n_hseg.cpp:110-147)
# ---------------------------------------------------------------------------

def _stage1_widths():
    """float32 width grid of stage 1: w = 17.1f; w < 19.7f; w += 0.5f."""
    ws, w = [], np.float32(HSEG_WIDTH_MIN)
    while w < np.float32(HSEG_WIDTH_MAX):
        ws.append(w)
        w = np.float32(w + np.float32(0.5))
    return np.array(ws, np.float32)          # 6 widths


def _np_chain(center, half, step, slots):
    """Emulate `for (w = c-half; w < c+half; w += step)` in IEEE float32.

    Returns (values (slots,) f32, valid (slots,) bool). The slot count the
    C++ actually runs genuinely depends on f32 rounding (e.g. stage 4 runs
    5 iterations, not 4), hence the fixed-slot + validity-mask form.
    """
    f32 = np.float32
    w = f32(f32(center) - f32(half))
    limit = f32(f32(center) + f32(half))
    vals, valid = [], []
    for _ in range(slots):
        vals.append(w)
        valid.append(bool(w < limit))
        w = f32(w + f32(step))
    return np.array(vals, f32), np.array(valid, bool)


# Valid pattern offsets never reach 151 (the widest reachable bound is
# 428 - lrintf(17 * 16.3) for the amex pattern at the smallest reachable
# width); offsets >= _O_FULL are always invalid and inf-masked.
_O_FULL = 160


# relative offset window around the stage-1 optimum: stage 2 explores
# bo1 + [-10, 9], stage 3 a further +-3, stage 4 another +-3
_R_LO, _R_HI = -16, 14
_N_R = _R_HI - _R_LO


@functools.lru_cache(maxsize=None)
def _cascade_tables():
    """Static tables driving the whole 4-stage search at runtime.

    Every width any stage can visit is an IEEE-f32 chain from the static
    stage-1 grid, so the full width universe (254 values), each width's
    stamped template (deduped by rounded center-vector: 148 per pattern),
    per-width offset bounds, and the chain tables of stages 2-4 are all
    precomputed host-side. The runtime does no width arithmetic: it
    gathers each stage's templates by width index and scores them against
    one window of offsets.
    """
    f32 = np.float32
    tmpl = np.array(HSEG_GRAD_SUM_PATTERN, f32)
    w1 = _stage1_widths()
    c2 = [_np_chain(w, 0.5, 0.2, 6) for w in w1]
    parents3 = sorted({float(v) for v in w1}
                      | {float(v) for vals, _ in c2 for v in vals})
    c3 = {u: _np_chain(u, 0.2, 0.1, 5) for u in parents3}
    parents4 = sorted(set(parents3)
                      | {float(v) for vals, _ in c3.values() for v in vals})
    c4 = {u: _np_chain(u, 0.1, 0.05, 6) for u in parents4}
    allw = sorted(set(parents4)
                  | {float(v) for vals, _ in c4.values() for v in vals})
    wval = np.array(allw, f32)
    nu = len(allw)
    uidx = {v: i for i, v in enumerate(allw)}

    # pattern-independent chain tables (u-index + static loop-bound validity)
    u1 = np.array([uidx[float(v)] for v in w1], np.int32)
    u2 = np.array([[uidx[float(v)] for v in vals] for vals, _ in c2],
                  np.int32)                                   # (6, 6)
    v2 = np.array([ok for _, ok in c2], bool)
    u3 = np.zeros((nu, 5), np.int32)
    v3 = np.zeros((nu, 5), bool)
    for u in parents3:
        vals, ok = c3[u]
        u3[uidx[u]] = [uidx[float(v)] for v in vals]
        v3[uidx[u]] = ok
    u4 = np.zeros((nu, 6), np.int32)
    v4 = np.zeros((nu, 6), bool)
    for u in parents4:
        vals, ok = c4[u]
        u4[uidx[u]] = [uidx[float(v)] for v in vals]
        v4[uidx[u]] = ok

    pats = []
    for p in (1, 2):
        plen, mask = PATTERN_LENGTH_FOR_PATTERN[p], PATTERN_MASKS[p]
        cvmap = {}
        cvid = np.zeros(nu, np.int32)
        obound = np.zeros(nu, np.int32)
        for i, w in enumerate(wval):
            # stamp centers at offset 0: lrintf(k*w) in f32, half-to-even
            c = tuple(int(np.rint(f32(k) * w)) for k in range(plen))
            cvid[i] = cvmap.setdefault(c, len(cvmap))
            maxc = max(ck for k, ck in enumerate(c) if mask[k])
            # candidate (w, o) valid iff o < 428 - lrintf(plen*w) (the loop
            # bound, n_hseg.cpp:49-53) and every stamp is fully inside:
            # o + maxc + 19 < 428 (the in_bounds check, :60-64)
            max_off = CARD_WIDTH - int(np.rint(f32(plen) * w))
            obound[i] = min(max_off, CARD_WIDTH - NUMBER_WIDTH - maxc)
        bank = np.zeros((len(cvmap), CARD_WIDTH), f32)
        for c, ci in cvmap.items():
            for k in range(plen):
                if mask[k]:
                    n = min(NUMBER_WIDTH, CARD_WIDTH - c[k])
                    if n > 0:  # later stamps overwrite (n_hseg.cpp:55-67)
                        bank[ci, c[k]:c[k] + n] = tmpl[:n]
        pats.append({"cvid": cvid, "obound": obound, "bank": bank})

    ncv = max(p["bank"].shape[0] for p in pats)
    out = {"wval": wval, "u1": u1, "v2": v2, "v3": v3, "v4": v4,
           "fu2": u2.astype(f32), "fu3": u3.astype(f32),
           "fu4": u4.astype(f32)}
    for name, d in zip(("visa", "amex"), pats):
        bank = d["bank"]
        if bank.shape[0] < ncv:
            bank = np.pad(bank, ((0, ncv - bank.shape[0]), (0, 0)))
        cvid, obound = d["cvid"], d["obound"]
        out[name] = {
            "bank": bank,
            "base1": bank[cvid[u1]],                  # (6, 428)
            # per-stage templates with the cv select FOLDED IN host-side:
            # base_n[parent, slot, x] — selection commutes with |.|, so
            # comparing these directly equals selecting rows of a full
            # bank sweep, at ~1/18th the arithmetic
            "base2": bank[cvid[u2]],                  # (6, 6, 428)
            "base3": bank[cvid[u3]],                  # (nu, 5, 428)
            "base4": bank[cvid[u4]],                  # (nu, 6, 428)
            "ob1": obound[u1].astype(f32),
            "ob2": obound[u2].astype(f32),            # (6, 6)
            "ob3": obound[u3].astype(f32),            # (nu, 5)
            "ob4": obound[u4].astype(f32),            # (nu, 6)
        }
    return out


def _masked_positions(pattern):
    """Digit positions k with mask[k] set, in digit order, padded to 16."""
    ks = [k for k, m in enumerate(PATTERN_MASKS[pattern]) if m]
    return ks + [0] * (16 - len(ks))


@functools.lru_cache(maxsize=None)
def _device_tables(device):
    """_cascade_tables() as tensors on `device`; per-pattern tables are
    stacked on a leading axis, index 0 visa-like and 1 amex-like."""
    t = _cascade_tables()

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    def both(key, dtype):
        return dev(np.stack([t["visa"][key], t["amex"][key]]), dtype)

    out = {"wval": dev(t["wval"], torch.float32),
           "u1": dev(t["u1"], torch.int64),
           "u2": dev(t["fu2"], torch.int64),
           "u3": dev(t["fu3"], torch.int64),
           "u4": dev(t["fu4"], torch.int64),
           "v2": dev(t["v2"], torch.bool),
           "v3": dev(t["v3"], torch.bool),
           "v4": dev(t["v4"], torch.bool),
           "masked_k": dev([_masked_positions(1), _masked_positions(2)],
                           torch.float32)}
    for n in (1, 2, 3, 4):
        out[f"base{n}"] = both(f"base{n}", torch.float32)
        out[f"ob{n}"] = both(f"ob{n}", torch.int64)
    return out


def best_n_hseg(y_strip, pattern_type, number_length) -> HSeg:
    """Reference-exact 4-stage search for every stream.

    y_strip: (S, 27, 428) uint8 PAN strips; pattern_type, number_length:
    (S,) int. Pattern 2 searches the amex-like templates, anything else the
    visa-like ones."""
    t = _device_tables(y_strip.device)
    s_count = y_strip.shape[0]
    dev = y_strip.device
    pat = (pattern_type == 2).long()                          # (S,)
    gs = grad_profile(y_strip)                                # (S, 428)
    cums = torch.nn.functional.pad(cumsum(gs), (1, 0))   # ops/prefix.py
    gs_pad = torch.nn.functional.pad(gs, (0, _O_FULL))         # zero past 428
    cols = torch.arange(CARD_WIDTH, device=dev)

    def windows(offs):
        """offs: (S, K) -> (gs[o + x] rows (S, K, 428), cums[o] (S, K)).
        Offsets outside [0, _O_FULL) read row clamp(o); every such
        candidate is masked invalid by its caller."""
        o = offs.clamp(0, _O_FULL - 1)
        idx = o[:, :, None] + cols
        win = torch.gather(gs_pad[:, None, :].expand(-1, o.shape[1], -1), 2,
                           idx)
        return win, torch.gather(cums, 1, o)

    def l1(win, pref, base):
        """win (S, K, 428), pref (S, K), base (S, n, 428) -> (S, n, K)."""
        d = (win[:, None, :, :] - base[:, :, None, :]).abs_().sum(dim=-1)
        return d + pref[:, None, :]

    # ---- stage 1: 6 widths x offsets 0, 10, .., 150
    o1 = 10 * torch.arange(16, device=dev).expand(s_count, 16)
    win1, pref1 = windows(o1)
    s1 = l1(win1, pref1, t["base1"][pat])                     # (S, 6, 16)
    ok1 = o1[:, None, :] < t["ob1"][pat][:, :, None]
    flat1 = torch.where(ok1, s1, float("inf")).reshape(s_count, -1)
    i1 = torch.argmin(flat1, dim=1)          # width-major == C++ scan order
    best_s = torch.gather(flat1, 1, i1[:, None])[:, 0]
    p1 = i1 // 16
    bo1 = 10 * (i1 % 16)
    # stage 1 always improves on the 428.0 init in practice; `found`
    # guards the all-invalid case to keep outputs defined
    found = best_s < 428.0
    best_s = torch.clamp(best_s, max=428.0)
    u = t["u1"][p1]
    rbest = torch.zeros_like(bo1)

    # ---- one window of offsets bo1 + [-16, 14) serves stages 2-4
    rr = torch.arange(_R_LO, _R_HI, device=dev)                # (30,)
    ogrid = bo1[:, None] + rr                                  # (S, 30)
    win_r, pref_r = windows(ogrid)

    def stage(base, ob, valid, uidx, r_lo, r_hi, best_s, u, rbest):
        """One best_n_hseg_constrained call (n_hseg.cpp:39-85): score the
        stage's templates against the offset window, then the strict-<
        carry against the running best."""
        blk = l1(win_r, pref_r, base)                          # (S, n, 30)
        ok = (valid[:, :, None]
              & ((rr >= r_lo[:, None]) & (rr < r_hi[:, None])
                 & (ogrid >= 0))[:, None, :]
              & (ogrid[:, None, :] < ob[:, :, None])
              & found[:, None, None])
        flat = torch.where(ok, blk, float("inf")).reshape(s_count, -1)
        i = torch.argmin(flat, dim=1)                          # C++ tie order
        s = torch.gather(flat, 1, i[:, None])[:, 0]
        slot = i // _N_R
        r = _R_LO + i % _N_R
        better = s < best_s
        u_new = torch.gather(uidx, 1, slot[:, None])[:, 0]
        return (torch.where(better, s, best_s), torch.where(better, u_new, u),
                torch.where(better, r, rbest))

    # stage 2: widths chain2(bw1), offsets bo1 +- 10 (n_hseg.cpp:123-131)
    ten = torch.full_like(bo1, 10)
    best_s, u, rbest = stage(t["base2"][pat, p1], t["ob2"][pat, p1],
                             t["v2"][p1], t["u2"][p1], -ten, ten,
                             best_s, u, rbest)
    # stage 3: widths chain3(bw2), offsets bo2 +- 3 (:133-139)
    best_s, u, rbest = stage(t["base3"][pat, u], t["ob3"][pat, u],
                             t["v3"][u], t["u3"][u], rbest - 3, rbest + 3,
                             best_s, u, rbest)
    # stage 4: widths chain4(bw3), offsets bo3 +- 3 (:141-147)
    best_s, u, rbest = stage(t["base4"][pat, u], t["ob4"][pat, u],
                             t["v4"][u], t["u4"][u], rbest - 3, rbest + 3,
                             best_s, u, rbest)

    width = torch.where(found, t["wval"][u], 0.0)
    o = torch.where(found, bo1 + rbest, 0).to(torch.int32)

    # digit cell left edges: o + lrintf(k*w) for the masked k, in digit
    # order (n_hseg.cpp:57-66)
    masked_k = t["masked_k"][pat]                             # (S, 16)
    centers = o[:, None] + torch.round(masked_k * width[:, None]).to(
        torch.int32)
    n_offsets = number_length.to(torch.int32)
    active = torch.arange(16, device=dev) < n_offsets[:, None]
    offsets = torch.where(active, centers, 0).to(torch.int32)

    return HSeg(
        n_offsets=n_offsets,
        number_width=width,
        pattern_offset=o,
        offsets=offsets,
        score=best_s,
    )
