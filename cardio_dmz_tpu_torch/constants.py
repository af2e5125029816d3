"""Framework-wide constants of the PyTorch port.

The same names and values as the JAX package's constants.py (the
reference's dmz_constants.h plus the algorithm constants the C++ keeps
beside each algorithm). A copy, not an import: importing the JAX package
would import jax. tests/test_torch_constants.py holds the two equal.
"""

import math

# --- card geometry (dmz_constants.h:7-14) ---
CARD_WIDTH = 428
CARD_HEIGHT = 270

PORTRAIT_SAMPLE_WIDTH = 480
PORTRAIT_SAMPLE_HEIGHT = 640
LANDSCAPE_SAMPLE_WIDTH = PORTRAIT_SAMPLE_HEIGHT   # 640
LANDSCAPE_SAMPLE_HEIGHT = PORTRAIT_SAMPLE_WIDTH   # 480

NUMBER_WIDTH = 19    # PAN digit cell width
NUMBER_HEIGHT = 27   # PAN digit cell height

# Derived percent insets (dmz_constants.h:16-27)
PORTRAIT_VERTICAL_INSET = (PORTRAIT_SAMPLE_HEIGHT - CARD_HEIGHT) // 2
PORTRAIT_VERTICAL_PERCENT_INSET = PORTRAIT_VERTICAL_INSET / PORTRAIT_SAMPLE_HEIGHT
PORTRAIT_HORIZONTAL_INSET = (PORTRAIT_SAMPLE_WIDTH - CARD_WIDTH) // 2
PORTRAIT_HORIZONTAL_PERCENT_INSET = PORTRAIT_HORIZONTAL_INSET / PORTRAIT_SAMPLE_WIDTH
LANDSCAPE_VERTICAL_INSET = (LANDSCAPE_SAMPLE_HEIGHT - CARD_HEIGHT) // 2
LANDSCAPE_VERTICAL_PERCENT_INSET = LANDSCAPE_VERTICAL_INSET / LANDSCAPE_SAMPLE_HEIGHT
LANDSCAPE_HORIZONTAL_INSET = (LANDSCAPE_SAMPLE_WIDTH - CARD_WIDTH) // 2
LANDSCAPE_HORIZONTAL_PERCENT_INSET = LANDSCAPE_HORIZONTAL_INSET / LANDSCAPE_SAMPLE_WIDTH

# --- frame orientations (dmz_olm.h) ---
ORIENTATION_PORTRAIT = 1
ORIENTATION_PORTRAIT_UPSIDE_DOWN = 2
ORIENTATION_LANDSCAPE_RIGHT = 3
ORIENTATION_LANDSCAPE_LEFT = 4

# --- vertical segmentation (scan/n_vseg.cpp:20-37) ---
VSEG_STRIP_X = 10          # strips are 408 px wide starting at x=10
VSEG_STRIP_WIDTH = 408
VSEG_MODEL_INPUT = 204     # after 2x downsample
VSEG_WINDOW = 27           # box-window sum height (kVertSegSumWindowSize)

PATTERN_UNKNOWN = 0
PATTERN_VISALIKE = 1
PATTERN_AMEXLIKE = 2

# number of digits for each pattern type (n_vseg.cpp:26)
NUMBER_LENGTH_FOR_PATTERN = (0, 16, 15)
# pattern template length (n_vseg.cpp:27)
PATTERN_LENGTH_FOR_PATTERN = (0, 19, 17)
# digit-presence masks (n_vseg.cpp:28-31); always 19 long, zero-padded
PATTERN_MASKS = (
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1),  # Visa 4-4-4-4
    (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 0),  # Amex 4-6-5
)

# --- horizontal segmentation (scan/n_hseg.cpp:15-20, 110-147) ---
HSEG_GRAD_SUM_PATTERN = (
    0.26228655, 0.30289554, 0.34632607, 0.38725636, 0.42745813, 0.45875135,
    0.46498017, 0.45258447, 0.43045216, 0.42430462, 0.44796554, 0.47726529,
    0.48471646, 0.46457738, 0.42799847, 0.38851183, 0.33966308, 0.28802608,
    0.25377602,
)
HSEG_WIDTH_MIN = 17.1
HSEG_WIDTH_MAX = 19.7
HSEG_WIDTH_STEP = 0.05    # dense evaluation at the reference's finest step
HSEG_MAX_OFFSET = 428     # integer pattern offsets

# --- frame usability (scan/frame.cpp:20-22) ---
MIN_VSEG_SCORE = 15.0
MAX_NUMBER_SCORE_DELTA = 3.0
FLIP_VSEG_Y_OFFSET_CUTOFF = (CARD_HEIGHT - NUMBER_HEIGHT) // 2   # 121

# --- session aggregation (scan/scan.cpp:13-17) ---
PAN_DECAY_FACTOR = 0.8
PAN_MIN_STABILITY = 0.7
MIN_FRAME_LEAD = 3          # |count15-count16| >= 3 (scan.cpp:104)
EXTRA_TIME_FOR_EXPIRY_MS = 1000  # reference's us-vs-ms quirk => ~1s (scan.cpp:14,175)

# --- expiry (scan/expiry_types.h:17-21, expiry_categorize.cpp:23-29) ---
SMALL_CHARACTER_WIDTH = 9
SMALL_CHARACTER_HEIGHT = 15
TRIMMED_CHARACTER_WIDTH = 11
TRIMMED_CHARACTER_HEIGHT = 16
EXPIRY_MAX_VALID_LENGTH = 11
EXPIRY_DECAY_FACTOR = 0.7
EXPIRY_MIN_STABILITY = 0.7
EXPIRY_MIN_SEEN_COUNT = 3   # group must be seen >= 3 frames (expiry_categorize.cpp:483)

# --- edge detection (dmz.cpp:199-208) ---
HOUGH_GRADIENT_ANGLE_THRESHOLD = 10.0     # degrees
HOUGH_THRESHOLD_LENGTH_DIVISOR = 6
HORIZONTAL_ANGLE = math.pi / 2.0
VERTICAL_ANGLE = math.pi
MAX_ANGLE_DEVIATION = 5.0 * math.pi / 180.0
VERTICAL_PERCENT_SLOP = 0.03
HORIZONTAL_PERCENT_SLOP = 0.03
HOUGH_THETA_RES = math.pi / 180.0
HOUGH_RHO_RES = 1.0
