"""The PAN-path models as PyTorch modules.

Counterparts of the JAX package's models/zoo.py:

* vseg strip MLP      204 -> 50 tanh -> 3 softmax       (`Mlp`)
* PAN digit conv (x3) 27x19 -> 8@3x3 (truncated valid 24x15) -> 3x3 maxpool
                      -> +bias, tanh -> 320 -> 32 tanh -> 10 softmax
                                                        (`PanConv`)
* the 3-model ensemble (r0 + r1 + r2 - max) / 2         (`pan_digit_scores`)

Weights are buffers, not parameters: nothing on the serving path takes a
gradient. The products go to torch.matmul, as the JAX package leaves them
to XLA.
"""

import numpy as np
import torch
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
    """Two-layer MLP: tanh hidden layer, softmax output (vseg 204->50->3)."""

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
    r = np.arange(27)[:, None, None, None]
    c = np.arange(19)[None, :, None, None]
    i = np.arange(24)[None, None, :, None]
    j = np.arange(15)[None, None, None, :]
    ki, kj = r - i, c - j
    valid = ((ki >= 0) & (ki < 3) & (kj >= 0) & (kj < 3)).reshape(513, 360)
    tap = (np.clip(ki, 0, 2) * 3 + np.clip(kj, 0, 2)).reshape(513, 360)
    m = conv_w.reshape(8, 9)[:, tap] * valid.astype(np.float32)  # 8x513x360
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


def pan_digit_scores(model_a, model_b, model_c, img):
    """3-model ensemble (scan/n_categorize.cpp:45-72):
    (r0 + r1 + r2 - max(r0, r1, r2)) / 2. img: (..., 27, 19) -> (..., 10)."""
    r0, r1, r2 = model_a(img), model_b(img), model_c(img)
    rmax = torch.maximum(torch.maximum(r0, r1), r2)
    return (r0 + r1 + r2 - rmax) / 2.0
