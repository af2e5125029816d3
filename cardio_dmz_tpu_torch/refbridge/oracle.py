"""numpy-only ctypes wrapper over the compiled card.io C++ oracle.

The port's own copy of the JAX package's refbridge/oracle.py: one method
per extern "C" entry point of native/refshim/oracle.cpp, the same result
dataclasses, and the same RefGroup / RefFrame layouts, which must match
that file byte for byte. Images are tight-packed uint8 numpy arrays; the
rectified card is 270x428 (height x width). It imports numpy and ctypes
only, so that tools and fixtures can hold the port against the C++ on a
machine without JAX.

The reference scanner keeps its state behind a handle: create one a
session (scanner_create), destroy it after (scanner_destroy), and share
none across threads.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np

from .build import build

REF_MAX_GROUPS = 12
REF_MAX_CHARS = 48  # pre-filter local groups can span a full stripe
CARD_H, CARD_W = 270, 428

_i32, _f32, _i64 = ctypes.c_int32, ctypes.c_float, ctypes.c_int64
_u8p = ctypes.POINTER(ctypes.c_uint8)


class _RefGroup(ctypes.Structure):
    _fields_ = [
        ("top", _i32), ("left", _i32), ("width", _i32), ("height", _i32),
        ("character_width", _i32), ("pattern", _i32),
        ("recently_seen_count", _i32), ("total_seen_count", _i32),
        ("n_chars", _i32),
        ("char_top", _i32 * REF_MAX_CHARS),
        ("char_left", _i32 * REF_MAX_CHARS),
        ("char_sum", _i64 * REF_MAX_CHARS), ("scores", _f32 * 110),
    ]


class _RefFrame(ctypes.Structure):
    _fields_ = [
        ("vseg_score", _f32), ("vseg_y_offset", _i32),
        ("vseg_pattern_type", _i32), ("vseg_number_length", _i32),
        ("hseg_n_offsets", _i32), ("hseg_offsets", _i32 * 16),
        ("hseg_score", _f32), ("hseg_number_width", _f32),
        ("hseg_pattern_offset", _i32), ("scores", _f32 * 160),
        ("usable", _i32), ("upside_down", _i32),
        ("n_expiry_groups", _i32), ("n_name_groups", _i32),
        ("expiry_groups", _RefGroup * REF_MAX_GROUPS),
        ("name_groups", _RefGroup * REF_MAX_GROUPS),
    ]


@dataclass
class RefGroupResult:
    top: int
    left: int
    width: int
    height: int
    character_width: int
    pattern: int
    recently_seen_count: int
    total_seen_count: int
    char_tops: list = field(default_factory=list)
    char_lefts: list = field(default_factory=list)
    char_sums: list = field(default_factory=list)
    scores: np.ndarray = None  # (11, 10)

    @classmethod
    def from_c(cls, g: _RefGroup) -> "RefGroupResult":
        n = g.n_chars
        return cls(
            top=g.top, left=g.left, width=g.width, height=g.height,
            character_width=g.character_width, pattern=g.pattern,
            recently_seen_count=g.recently_seen_count,
            total_seen_count=g.total_seen_count,
            char_tops=list(g.char_top)[:n], char_lefts=list(g.char_left)[:n],
            char_sums=list(g.char_sum)[:n],
            scores=np.array(g.scores, dtype=np.float32).reshape(11, 10),
        )

    def to_c(self) -> _RefGroup:
        g = _RefGroup()
        g.top, g.left = self.top, self.left
        g.width, g.height = self.width, self.height
        g.character_width = self.character_width
        g.pattern = self.pattern
        g.recently_seen_count = self.recently_seen_count
        g.total_seen_count = self.total_seen_count
        g.n_chars = len(self.char_tops)
        for i, (t, l) in enumerate(zip(self.char_tops, self.char_lefts)):
            g.char_top[i] = t
            g.char_left[i] = l
            g.char_sum[i] = self.char_sums[i] if i < len(self.char_sums) else 0
        if self.scores is not None:
            flat = np.asarray(self.scores, dtype=np.float32).reshape(-1)
            for i, v in enumerate(flat):
                g.scores[i] = float(v)
        return g


@dataclass
class RefFrameResult:
    vseg_score: float
    vseg_y_offset: int
    vseg_pattern_type: int
    vseg_number_length: int
    hseg_n_offsets: int
    hseg_offsets: list
    hseg_score: float
    hseg_number_width: float
    hseg_pattern_offset: int
    scores: np.ndarray  # (16, 10)
    usable: bool
    upside_down: bool
    expiry_groups: list
    name_groups: list

    @property
    def digits(self) -> list:
        return [int(d) for d in self.scores.argmax(1)[: self.hseg_n_offsets]]

    @classmethod
    def from_c(cls, f: _RefFrame) -> "RefFrameResult":
        return cls(
            vseg_score=f.vseg_score, vseg_y_offset=f.vseg_y_offset,
            vseg_pattern_type=f.vseg_pattern_type,
            vseg_number_length=f.vseg_number_length,
            hseg_n_offsets=f.hseg_n_offsets,
            hseg_offsets=list(f.hseg_offsets)[: f.hseg_n_offsets],
            hseg_score=f.hseg_score, hseg_number_width=f.hseg_number_width,
            hseg_pattern_offset=f.hseg_pattern_offset,
            scores=np.array(f.scores, dtype=np.float32).reshape(16, 10),
            usable=bool(f.usable), upside_down=bool(f.upside_down),
            expiry_groups=[RefGroupResult.from_c(f.expiry_groups[i])
                           for i in range(f.n_expiry_groups)],
            name_groups=[RefGroupResult.from_c(f.name_groups[i])
                         for i in range(f.n_name_groups)],
        )


def _as_u8(img) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img, dtype=np.uint8))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


class RefOracle:
    """The compiled reference, one method per extern "C" entry point."""

    _instance = None

    def __init__(self, so_path=None):
        """so_path: the library to load; build()'s (linked now if need
        be, raising on a failed link) when None."""
        self._lib = ctypes.CDLL(so_path or build())
        self._lib.ref_focus_score.restype = ctypes.c_float
        self._lib.ref_brightness_score.restype = ctypes.c_float
        self._lib.ref_slash_prob.restype = ctypes.c_float
        self._lib.ref_scanner_create.restype = ctypes.c_void_p

    @classmethod
    def shared(cls) -> "RefOracle":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # ------------------------------------------------------------- frame
    def scan_card_image(self, y, collect_number=True,
                        scan_expiry=True) -> RefFrameResult:
        a = _as_u8(y)
        assert a.shape == (CARD_H, CARD_W), a.shape
        out = _RefFrame()
        self._lib.ref_scan_card_image(_ptr(a), int(collect_number),
                                      int(scan_expiry), ctypes.byref(out))
        return RefFrameResult.from_c(out)

    def vseg(self, y):
        a = _as_u8(y)
        out = _RefFrame()
        self._lib.ref_vseg(_ptr(a), ctypes.byref(out))
        return (out.vseg_y_offset, out.vseg_score, out.vseg_pattern_type,
                out.vseg_number_length)

    def hseg(self, y, y_offset: int):
        a = _as_u8(y)
        out = _RefFrame()
        self._lib.ref_hseg(_ptr(a), int(y_offset), ctypes.byref(out))
        n = out.hseg_n_offsets
        return (n, list(out.hseg_offsets)[:n], out.hseg_number_width,
                out.hseg_pattern_offset, out.hseg_score)

    def expiry_seg(self, y, y_offset: int):
        a = _as_u8(y)
        out = _RefFrame()
        self._lib.ref_expiry_seg(_ptr(a), int(y_offset), ctypes.byref(out))
        return ([RefGroupResult.from_c(out.expiry_groups[i])
                 for i in range(out.n_expiry_groups)],
                [RefGroupResult.from_c(out.name_groups[i])
                 for i in range(out.n_name_groups)])

    def expiry_extract(self, y, old_groups, new_groups):
        a = _as_u8(y)
        arr = (_RefGroup * REF_MAX_GROUPS)()
        for i, g in enumerate(old_groups[:REF_MAX_GROUPS]):
            arr[i] = g.to_c()
        n_old = _i32(len(old_groups))
        new_arr = (_RefGroup * max(1, len(new_groups)))()
        for i, g in enumerate(new_groups):
            new_arr[i] = g.to_c()
        month, year = _i32(0), _i32(0)
        self._lib.ref_expiry_extract(_ptr(a), arr, ctypes.byref(n_old),
                                     new_arr, _i32(len(new_groups)),
                                     ctypes.byref(month), ctypes.byref(year))
        state = [RefGroupResult.from_c(arr[i]) for i in range(n_old.value)]
        return state, month.value, year.value

    def expiry_extract_group(self, y, group: RefGroupResult):
        a = _as_u8(y)
        g = group.to_c()
        month, year = _i32(0), _i32(0)
        self._lib.ref_expiry_extract_group(
            _ptr(a), ctypes.byref(g), ctypes.byref(month),
            ctypes.byref(year))
        return RefGroupResult.from_c(g), month.value, year.value

    # ------------------------------------------------------------ session
    def scanner_create(self):
        return self._lib.ref_scanner_create()

    def scanner_destroy(self, handle):
        self._lib.ref_scanner_destroy(ctypes.c_void_p(handle))

    def scanner_add_frame(self, handle, y, scan_expiry=True) -> RefFrameResult:
        a = _as_u8(y)
        out = _RefFrame()
        self._lib.ref_scanner_add_frame(ctypes.c_void_p(handle), _ptr(a),
                                        int(scan_expiry), ctypes.byref(out))
        return RefFrameResult.from_c(out)

    def scanner_result(self, handle):
        preds = (_i32 * 16)()
        n, month, year = _i32(0), _i32(0), _i32(0)
        ok = self._lib.ref_scanner_result(ctypes.c_void_p(handle), preds,
                                          ctypes.byref(n), ctypes.byref(month),
                                          ctypes.byref(year))
        if not ok:
            return None
        return (list(preds)[: n.value], month.value, year.value)

    # ------------------------------------------------------------- camera
    def detect_edges(self, y, cb, cr, orientation=3):
        # orientation: FrameOrientation (dmz_olm.h:19-22) —
        # 3 == FrameOrientationLandscapeRight, the canonical one (dmz.cpp:458)
        ya, cba, cra = _as_u8(y), _as_u8(cb), _as_u8(cr)
        rt = (_f32 * 8)()
        found = (_i32 * 4)()
        corners = (_f32 * 8)()
        ok = self._lib.ref_detect_edges(
            _ptr(ya), ya.shape[1], ya.shape[0], _ptr(cba), _ptr(cra),
            cba.shape[1], cba.shape[0], int(orientation), rt, found, corners)
        return (bool(ok), list(found), np.array(rt).reshape(4, 2),
                np.array(corners).reshape(4, 2))

    def transform_card(self, sample, corners, orientation=3, upsample=False):
        a = _as_u8(sample)
        out = np.zeros((CARD_H, CARD_W), dtype=np.uint8)
        c = (_f32 * 8)(*np.asarray(corners, dtype=np.float32).reshape(-1))
        self._lib.ref_transform_card(_ptr(a), a.shape[1], a.shape[0], c,
                                     int(orientation), int(upsample),
                                     _ptr(out))
        return out

    def persp_transform(self, src_pts, dst_pts):
        """llcv_calc_persp_transform (cv/warp.cpp:34-125): the Eigen f32
        householderQr 8x8 solve. Points (4, 2); returns (3, 3) row-major."""
        sp = (_f32 * 8)(*np.asarray(src_pts, np.float32).reshape(-1))
        dp = (_f32 * 8)(*np.asarray(dst_pts, np.float32).reshape(-1))
        out = (_f32 * 9)()
        self._lib.ref_persp_transform(sp, dp, out)
        return np.array(out, dtype=np.float32).reshape(3, 3)

    def warp_perspective(self, image, matrix, out_shape):
        """cvWarpPerspective INTER_LINEAR + FILL_OUTLIERS with a fixed
        row-major f32 src->dst matrix (the warp half of llcv_unwarp)."""
        a = _as_u8(image)
        m = (_f32 * 9)(*np.asarray(matrix, np.float32).reshape(-1))
        out_h, out_w = out_shape
        out = np.zeros((out_h, out_w), dtype=np.uint8)
        self._lib.ref_warp_perspective(_ptr(a), a.shape[1], a.shape[0], m,
                                       out_w, out_h, _ptr(out))
        return out

    def focus_score(self, y, use_full_image=False) -> float:
        a = _as_u8(y)
        return float(self._lib.ref_focus_score(_ptr(a), a.shape[1], a.shape[0],
                                               int(use_full_image)))

    def brightness_score(self, y, use_full_image=False) -> float:
        a = _as_u8(y)
        return float(self._lib.ref_brightness_score(
            _ptr(a), a.shape[1], a.shape[0], int(use_full_image)))

    # ------------------------------------------------------------ kernels
    def sobel7(self, src, dx: bool):
        a = _as_u8(src)
        out = np.zeros(a.shape, dtype=np.int16)
        self._lib.ref_sobel7(
            _ptr(a), a.shape[1], a.shape[0], int(dx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out

    def canny7(self, src):
        a = _as_u8(src)
        out = np.zeros(a.shape, dtype=np.uint8)
        self._lib.ref_canny7(_ptr(a), a.shape[1], a.shape[0], _ptr(out))
        return out

    def hough(self, canny, dx, dy, rho_res, theta_res, threshold, theta_min,
              theta_max, vertical, gradient_angle_threshold):
        c = _as_u8(canny)
        dxa = np.ascontiguousarray(dx, dtype=np.int16)
        dya = np.ascontiguousarray(dy, dtype=np.int16)
        out = (_f32 * 3)()
        i16p = ctypes.POINTER(ctypes.c_int16)
        self._lib.ref_hough(_ptr(c), dxa.ctypes.data_as(i16p),
                            dya.ctypes.data_as(i16p), c.shape[1], c.shape[0],
                            _f32(rho_res), _f32(theta_res), int(threshold),
                            _f32(theta_min), _f32(theta_max), int(vertical),
                            _f32(gradient_angle_threshold), out)
        return float(out[0]), float(out[1]), bool(out[2])

    def morph_grad3(self, src, two_d: bool):
        a = _as_u8(src)
        out = np.zeros(a.shape, dtype=np.uint8)
        self._lib.ref_morph_grad3(_ptr(a), a.shape[1], a.shape[0],
                                  int(two_d), _ptr(out))
        return out

    def equalize_hist(self, src):
        a = _as_u8(src)
        out = np.zeros(a.shape, dtype=np.uint8)
        self._lib.ref_equalize_hist(_ptr(a), a.shape[1], a.shape[0], _ptr(out))
        return out

    def scharr3_abs(self, src, is_dx: bool):
        a = _as_u8(src)
        out = np.zeros(a.shape, dtype=np.int16)
        self._lib.ref_scharr3_abs(
            _ptr(a), a.shape[1], a.shape[0], int(is_dx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out

    # ----------------------------------------------- expiry stage oracles
    def expiry_sobel(self, y, y_offset: int):
        a = _as_u8(y)
        out = np.zeros((CARD_H, CARD_W), dtype=np.int16)
        self._lib.ref_expiry_sobel(
            _ptr(a), int(y_offset),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out

    def find_character_groups(self, sobel, base_row: int, stripe_sum: int):
        s = np.ascontiguousarray(sobel, dtype=np.int16)
        eg = (_RefGroup * REF_MAX_GROUPS)()
        ng = (_RefGroup * REF_MAX_GROUPS)()
        n_e, n_n = _i32(0), _i32(0)
        self._lib.ref_find_character_groups(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), int(base_row),
            _i64(int(stripe_sum)), eg, ctypes.byref(n_e), ng,
            ctypes.byref(n_n))
        return ([RefGroupResult.from_c(eg[i]) for i in range(n_e.value)],
                [RefGroupResult.from_c(ng[i]) for i in range(n_n.value)])

    def regrid_group(self, sobel, group: RefGroupResult) -> RefGroupResult:
        s = np.ascontiguousarray(sobel, dtype=np.int16)
        g = group.to_c()
        self._lib.ref_regrid_group(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), ctypes.byref(g))
        return RefGroupResult.from_c(g)

    def optimize_character_rects(self, sobel,
                                 group: RefGroupResult) -> RefGroupResult:
        s = np.ascontiguousarray(sobel, dtype=np.int16)
        g = group.to_c()
        self._lib.ref_optimize_character_rects(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), ctypes.byref(g))
        return RefGroupResult.from_c(g)

    def slash_prob(self, sobel, top: int, left: int) -> float:
        s = np.ascontiguousarray(sobel, dtype=np.int16)
        return float(self._lib.ref_slash_prob(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), int(top),
            int(left)))

    def gather_groups(self, groups, tolerance: int):
        """gather_into_groups over GROUPS with character rects — the
        super-group gather (expiry_seg.cpp:548, carried disabled)."""
        n = len(groups)
        arr = (_RefGroup * n)(*[g.to_c() for g in groups])
        out = (_RefGroup * REF_MAX_GROUPS)()
        n_out = _i32(0)
        self._lib.ref_gather_groups(arr, n, int(tolerance), out,
                                    ctypes.byref(n_out))
        return [RefGroupResult.from_c(out[i]) for i in range(n_out.value)]

    def gather_into_groups(self, tops, lefts, sums, tolerance: int):
        n = len(tops)
        t = (_i32 * n)(*tops)
        l = (_i32 * n)(*lefts)
        sm = (_i64 * n)(*[int(x) for x in sums])
        out = (_RefGroup * REF_MAX_GROUPS)()
        n_out = _i32(0)
        self._lib.ref_gather_into_groups(t, l, sm, n, int(tolerance), out,
                                         ctypes.byref(n_out))
        return [RefGroupResult.from_c(out[i]) for i in range(n_out.value)]

    def expiry_prep_char(self, y, top: int, left: int):
        a = _as_u8(y)
        out = np.zeros((16, 11), dtype=np.float32)
        self._lib.ref_expiry_prep_char(
            _ptr(a), int(top), int(left),
            out.ctypes.data_as(ctypes.POINTER(_f32)))
        return out

    # ------------------------------------------------------------- models
    def model_vseg(self, x204):
        a = np.ascontiguousarray(x204, dtype=np.float32)
        out = (_f32 * 3)()
        self._lib.ref_model_vseg(a.ctypes.data_as(ctypes.POINTER(_f32)), out)
        return np.array(out)

    def model_pan(self, which: int, cell27x19):
        a = np.ascontiguousarray(cell27x19, dtype=np.float32)
        out = (_f32 * 10)()
        self._lib.ref_model_pan(int(which),
                                a.ctypes.data_as(ctypes.POINTER(_f32)), out)
        return np.array(out)

    def model_slash(self, x176):
        a = np.ascontiguousarray(x176, dtype=np.float32)
        out = (_f32 * 2)()
        self._lib.ref_model_slash(a.ctypes.data_as(ctypes.POINTER(_f32)), out)
        return np.array(out)

    def model_expiry(self, cell16x11):
        a = np.ascontiguousarray(cell16x11, dtype=np.float32)
        out = (_f32 * 10)()
        self._lib.ref_model_expiry(a.ctypes.data_as(ctypes.POINTER(_f32)), out)
        return np.array(out)

    def models_selfcheck(self) -> bool:
        return bool(self._lib.ref_models_selfcheck())
