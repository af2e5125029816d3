"""The scan's models as PyTorch modules.

Counterparts of the JAX package's models/zoo.py:

* vseg strip MLP      204 -> 50 tanh -> 3 softmax       (`Mlp`)
* slash MLP           176 -> 80 tanh -> 2 softmax       (`Mlp`)
* PAN digit conv (x3) 27x19 -> 8@3x3 (truncated valid 24x15) -> 3x3 maxpool
                      -> +bias, tanh -> 320 -> 32 tanh -> 10 softmax
                                                        (`PanConv`)
* the 3-model ensemble (r0 + r1 + r2 - max) / 2         (`pan_digit_scores`)
* expiry digit conv   16x11 (mean-sub) -> 50@5x5 full -> 2x2 pool -> relu
                      -> 40@5x5 valid (sum over maps) -> 2x3 pool -> relu
                      -> 120 -> 176 relu -> 10 softmax  (`ExpiryConv`)

Weights are buffers, not parameters: nothing on the serving path takes a
gradient. The products go to torch.matmul, as the JAX package leaves them
to XLA.

Training takes the trainable forms instead (`apply_mlp`, `apply_pan_conv`,
`apply_expiry_conv`): plain functions of a dict of tensors, the JAX
package's functions of the same names in their conv form, differentiable.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Full-f32 products everywhere in the port: TF32 keeps about three decimal
# digits and breaks the reference's 1e-5 golden tolerance. (The matmul
# switch is already off by default; cuDNN's is on by default.)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAN_CELL_PIXELS = 27 * 19


def _tanh(x):
    # The exp-based form of the JAX package (models/zoo.py:_tanh): good to
    # ~2e-6 against libm tanhf, which a fast tanh approximation may not be.
    ax = x.abs()
    t = 1.0 - 2.0 / (torch.exp(2.0 * ax) + 1.0)
    return torch.sign(x) * t


class Mlp(nn.Module):
    """Two-layer MLP: tanh hidden layer, softmax output (vseg 204->50->3,
    slash 176->80->2)."""

    def __init__(self, hidden_w, hidden_b, logistic_w, logistic_b):
        super().__init__()
        self.register_buffer("hidden_w", hidden_w)
        self.register_buffer("hidden_b", hidden_b)
        self.register_buffer("logistic_w", logistic_w)
        self.register_buffer("logistic_b", logistic_b)

    def forward(self, x):
        """x: (..., n_in) float32 -> (..., n_out) probabilities."""
        h = _tanh(torch.matmul(x, self.hidden_w.T) + self.hidden_b)
        logits = torch.matmul(h, self.logistic_w.T) + self.logistic_b
        return torch.softmax(logits, dim=-1)


def _conv_as_matmul_tables(in_hw, out_hw, k, pad):
    """(tap, mask) tables that fold a KxK correlation with the given
    low-side padding into one matrix: M[p, q] = w_flat[tap[p, q]] *
    mask[p, q], p the input pixel and q the output position, both
    row-major; the conv is then x_flat @ M."""
    ih, iw = in_hw
    oh, ow = out_hw
    r = np.arange(ih)[:, None, None, None]
    c = np.arange(iw)[None, :, None, None]
    i = np.arange(oh)[None, None, :, None]
    j = np.arange(ow)[None, None, None, :]
    ki, kj = r - i + pad[0], c - j + pad[1]
    valid = (ki >= 0) & (ki < k) & (kj >= 0) & (kj < k)
    tap = np.clip(ki, 0, k - 1) * k + np.clip(kj, 0, k - 1)
    return (tap.reshape(ih * iw, oh * ow),
            valid.reshape(ih * iw, oh * ow).astype(np.float32))


def _pool_perm(out_hw, pool_hw):
    """Column order putting each non-overlapping pool window's taps last:
    q' = (pr, pc, dr, dc) for q = (pr*ph + dr, pc*pw + dc)."""
    oh, ow = out_hw
    ph, pw = pool_hw
    pr = np.arange(oh // ph)[:, None, None, None]
    pc = np.arange(ow // pw)[None, :, None, None]
    dr = np.arange(ph)[None, None, :, None]
    dc = np.arange(pw)[None, None, None, :]
    return ((pr * ph + dr) * ow + pc * pw + dc).reshape(-1)


def pan_conv_matrix(conv_w):
    """(513, 8*8*5*9) matrix of the PAN conv: the 3x3 valid correlation,
    truncated to 24x15, with the 3x3 pool windows' taps in the minor axis.
    conv_w: (8, 3, 3) numpy. The same matrix as the JAX package's
    _pan_conv_matmul."""
    tap, mask = _conv_as_matmul_tables((27, 19), (24, 15), 3, (0, 0))
    m = conv_w.reshape(8, 9)[:, tap] * mask                    # 8x513x360
    m = m[:, :, _pool_perm((24, 15), (3, 3))]
    return np.ascontiguousarray(
        m.transpose(1, 0, 2).reshape(PAN_CELL_PIXELS, 8 * 360), np.float32)


class PanConv(nn.Module):
    """PAN digit classifier on (..., 27, 19) float cells in [0, 1].

    The conv is one matmul against the folded `conv_mm` buffer; the 3x3
    max pool is then a max over the minor 9 columns."""

    def __init__(self, conv_w, conv_b, hidden_w, hidden_b, logistic_w,
                 logistic_b):
        super().__init__()
        self.register_buffer("conv_w", conv_w)
        self.register_buffer("conv_b", conv_b)
        self.register_buffer("hidden_w", hidden_w)
        self.register_buffer("hidden_b", hidden_b)
        self.register_buffer("logistic_w", logistic_w)
        self.register_buffer("logistic_b", logistic_b)
        mm = torch.from_numpy(pan_conv_matrix(conv_w.cpu().numpy()))
        self.register_buffer("conv_mm", mm.to(conv_w.device), persistent=False)

    def forward(self, img):
        if img.shape[-2:] != (27, 19):
            raise ValueError(
                f"PAN digit cell must be (..., 27, 19) (H, W); got "
                f"{tuple(img.shape)}")
        batch_shape = img.shape[:-2]
        x = img.reshape(-1, PAN_CELL_PIXELS)
        n = x.shape[0]
        c = torch.matmul(x, self.conv_mm)                       # (N, 2880)
        pooled = c.reshape(n, 8, 8, 5, 9).amax(-1)              # (N, 8, 8, 5)
        act = _tanh(pooled + self.conv_b[None, :, None, None])
        flat = act.reshape(n, 320)            # kernel-major, then row-major
        h = _tanh(torch.matmul(flat, self.hidden_w.T) + self.hidden_b)
        logits = torch.matmul(h, self.logistic_w.T) + self.logistic_b
        return torch.softmax(logits, dim=-1).reshape(batch_shape + (10,))


def expiry_conv_matrices(conv1_w, conv2_w):
    """The two 5x5 convolutions of the expiry classifier as matrices, pool
    windows' taps in the minor axis: (176, 50*10*7*4) for conv1 (full,
    zero-padded, 16x11 -> 20x14, 2x2 pool) and (50*10*7, 40*3*6) for conv2
    (valid over the 50 maps, 10x7 -> 6x3, 2x3 pool). conv1_w: (50, 5, 5),
    conv2_w: (40, 50, 5, 5) numpy. The same matrices as the JAX package's
    apply_expiry_conv_mm builds."""
    tap, mask = _conv_as_matmul_tables((16, 11), (20, 14), 5, (4, 4))
    m1 = conv1_w.reshape(50, 25)[:, tap] * mask                # 50x176x280
    m1 = m1[:, :, _pool_perm((20, 14), (2, 2))]
    m1 = m1.transpose(1, 0, 2).reshape(176, 50 * 280)
    tap, mask = _conv_as_matmul_tables((10, 7), (6, 3), 5, (0, 0))
    m2 = conv2_w.reshape(40, 50, 25)[:, :, tap] * mask         # 40x50x70x18
    m2 = m2[:, :, :, _pool_perm((6, 3), (2, 3))]
    m2 = m2.transpose(1, 2, 0, 3).reshape(50 * 70, 40 * 18)
    return (np.ascontiguousarray(m1, np.float32),
            np.ascontiguousarray(m2, np.float32))


class ExpiryConv(nn.Module):
    """Expiry digit classifier on (..., 16, 11) float cells in [0, 1]
    (modelc_bf4dd6c8.cpp:12495-13505). Each conv is one matmul against a
    folded buffer (`conv1_mm`, `conv2_mm`); each max pool is then a max over
    the minor columns."""

    def __init__(self, conv1_w, conv1_b, conv2_w, conv2_b, hidden_w,
                 hidden_b, logistic_w, logistic_b):
        super().__init__()
        for name, value in (("conv1_w", conv1_w), ("conv1_b", conv1_b),
                            ("conv2_w", conv2_w), ("conv2_b", conv2_b),
                            ("hidden_w", hidden_w), ("hidden_b", hidden_b),
                            ("logistic_w", logistic_w),
                            ("logistic_b", logistic_b)):
            self.register_buffer(name, value)
        m1, m2 = expiry_conv_matrices(conv1_w.cpu().numpy(),
                                      conv2_w.cpu().numpy())
        self.register_buffer("conv1_mm", torch.from_numpy(m1).to(
            conv1_w.device), persistent=False)
        self.register_buffer("conv2_mm", torch.from_numpy(m2).to(
            conv1_w.device), persistent=False)

    def forward(self, img, return_intermediates=False):
        """img: (..., 16, 11) -> (..., 10) probabilities; with
        return_intermediates also conv1's (..., 50, 10, 7) and conv2's
        (..., 40, 3) pooled activations and the (..., 176) hidden layer."""
        if img.shape[-2:] != (16, 11):
            raise ValueError(
                f"expiry digit cell must be (..., 16, 11) (H, W); got "
                f"{tuple(img.shape)}")
        batch_shape = img.shape[:-2]
        x = img.reshape(-1, 176)
        x = x - x.mean(dim=-1, keepdim=True)
        n = x.shape[0]
        c1 = torch.matmul(x, self.conv1_mm)                  # (N, 14000)
        p1 = c1.reshape(n, 50, 10, 7, 4).amax(-1)
        a1 = torch.relu(p1 + self.conv1_b[None, :, None, None])
        c2 = torch.matmul(a1.reshape(n, 3500), self.conv2_mm)   # (N, 720)
        p2 = c2.reshape(n, 40, 3, 6).amax(-1)
        a2 = torch.relu(p2 + self.conv2_b[None, :, None])
        flat = a2.reshape(n, 120)        # map-major: Eigen's 40x3 row-major
        h = torch.relu(torch.matmul(flat, self.hidden_w.T) + self.hidden_b)
        logits = torch.matmul(h, self.logistic_w.T) + self.logistic_b
        probs = torch.softmax(logits, dim=-1).reshape(batch_shape + (10,))
        if return_intermediates:
            return (probs, a1.reshape(batch_shape + (50, 10, 7)),
                    a2.reshape(batch_shape + (40, 3)),
                    h.reshape(batch_shape + (176,)))
        return probs


def pan_digit_scores(model_a, model_b, model_c, img):
    """3-model ensemble (scan/n_categorize.cpp:45-72):
    (r0 + r1 + r2 - max(r0, r1, r2)) / 2. img: (..., 27, 19) -> (..., 10)."""
    r0, r1, r2 = model_a(img), model_b(img), model_c(img)
    rmax = torch.maximum(torch.maximum(r0, r1), r2)
    return (r0 + r1 + r2 - rmax) / 2.0


# --- the trainable forms -------------------------------------------------
# A tie's gradient is split as JAX splits it: max pools by amax (shared
# evenly among the tied inputs) and ReLUs by torch.maximum against a zero
# tensor (half each way at 0); torch.relu, max(dim) and F.max_pool2d give
# all of it to one side.

def _affine(params, x, name):
    """x @ w.T + b for the layer `name` ("hidden", "logistic"), or the
    caller's own product of the layer where params holds a callable under
    `name` (the trainer's column-parallel hidden layer)."""
    if name in params:
        return params[name](x)
    return torch.matmul(x, params[f"{name}_w"].T) + params[f"{name}_b"]


def _relu(x):
    return torch.maximum(x, x.new_zeros(()))


def _conv2d(x, w):
    """Valid 2-D correlation of x (N, C, H, W) with w (O, C, kh, kw) as one
    f32 GEMM (TF32 off) of the input's patches against the weights, in
    forward and backward alike. The patches are a strided view of x
    (Tensor.unfold), laid out by one copy whatever N is. cuDNN picks its
    convolution algorithms itself, and on an H100 its weight gradient of
    the expiry conv was off from XLA's by up to 2.2e-05, TF32 off; F.unfold
    and cuDNN-less F.conv2d launch an im2col kernel a sample."""
    o, c, kh, kw = w.shape
    patches = x.unfold(2, kh, 1).unfold(3, kw, 1)   # (N, C, Ho, Wo, kh, kw)
    n, _, ho, wo = patches.shape[:4]
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw)
    out = torch.matmul(cols, w.reshape(o, c * kh * kw).T)
    return out.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def apply_mlp(params, x):
    """The vseg (204->50->3) and slash (176->80->2) MLP on a dict of
    tensors. x: (..., n_in) float32 -> (..., n_out) probabilities."""
    h = _tanh(_affine(params, x, "hidden"))
    return torch.softmax(_affine(params, h, "logistic"), dim=-1)


def apply_pan_conv(params, img):
    """The PAN digit conv on a dict of tensors: the 3x3 valid correlation
    truncated to 24x15, 3x3 max pool, bias + tanh, 320 -> 32 tanh -> 10
    softmax. img: (..., 27, 19) float32 -> (..., 10)."""
    if img.shape[-2:] != (27, 19):
        raise ValueError(
            f"PAN digit cell must be (..., 27, 19) (H, W); got "
            f"{tuple(img.shape)}")
    batch_shape = img.shape[:-2]
    x = img.reshape(-1, 1, 27, 19)
    conv = _conv2d(x, params["conv_w"][:, None])[:, :, :24, :15]
    n = conv.shape[0]
    pooled = conv.reshape(n, 8, 8, 3, 5, 3).amax((3, 5))    # (N, 8, 8, 5)
    act = _tanh(pooled + params["conv_b"][None, :, None, None])
    h = _tanh(_affine(params, act.reshape(n, 320), "hidden"))
    logits = _affine(params, h, "logistic")
    return torch.softmax(logits, dim=-1).reshape(batch_shape + (10,))


def apply_expiry_conv(params, img):
    """The expiry digit conv on a dict of tensors: mean-subtracted input,
    conv1 a full 5x5 correlation (padding (4, 4) rows, (4, 3) columns) to
    20x14, 2x2 pool, bias + ReLU; conv2 valid to 6x3, 2x3 pool, bias +
    ReLU; 120 -> 176 ReLU -> 10 softmax. img: (..., 16, 11) -> (..., 10)."""
    if img.shape[-2:] != (16, 11):
        raise ValueError(
            f"expiry digit cell must be (..., 16, 11) (H, W); got "
            f"{tuple(img.shape)}")
    batch_shape = img.shape[:-2]
    x = img.reshape(-1, 16, 11)
    x = x - x.mean(dim=(-1, -2), keepdim=True)
    c1 = _conv2d(F.pad(x[:, None], (4, 3, 4, 4)),
                 params["conv1_w"][:, None])                 # (N, 50, 20, 14)
    n = c1.shape[0]
    p1 = c1.reshape(n, 50, 10, 2, 7, 2).amax((3, 5))
    a1 = _relu(p1 + params["conv1_b"][None, :, None, None])
    c2 = _conv2d(a1, params["conv2_w"])                      # (N, 40, 6, 3)
    p2 = c2.reshape(n, 40, 3, 2, 1, 3).amax((3, 5)).reshape(n, 40, 3)
    a2 = _relu(p2 + params["conv2_b"][None, :, None])
    h = _relu(_affine(params, a2.reshape(n, 120), "hidden"))
    logits = _affine(params, h, "logistic")
    return torch.softmax(logits, dim=-1).reshape(batch_shape + (10,))
