"""The session fixture shared by the PyTorch port's tests and chip_smoke.py.

Four streams of six rendered 270x428 card frames go through the JAX
package's scanner_step, vmapped over streams. Streams 0 and 1 (two
readable PANs) become cardio_dmz_tpu_torch/data/smoke_session.npz: their
frames, the date the sessions start from, the JAX package's per-frame
vseg/hseg/scores/usable and the final completed digits. chip_smoke.py
replays those frames through the port on the card, where neither JAX nor
the renderer is installed.

Write the file anew with:  python tests/torch_fixture.py
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import synthetic  # noqa: E402
from cardio_dmz_tpu.models.weights import load_all_params  # noqa: E402
from cardio_dmz_tpu.session import scanner_reset, scanner_step  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cardio_dmz_tpu_torch", "data", "smoke_session.npz")
NOW = (2026, 1)
N_FRAMES = 6
# (pan, y0, noise): two readable PANs, a wrong-Luhn PAN and an upside-down
# card; geometry as in tests/test_session.py
STREAMS = (("4111111111111111", 150, 1),
           ("4530504390541813", 150, 2),
           ("4111111111111112", 150, 1),
           ("4111111111111111", 60, 1))
FIXTURE_STREAMS = 2


@functools.lru_cache(maxsize=None)
def frames():
    """(4, 6, 270, 428) uint8."""
    return np.stack([
        np.stack([synthetic.render_frame(pan, y0=y0, width=18.0, offset=35,
                                         seed=s, noise=noise)
                  for s in range(N_FRAMES)])
        for pan, y0, noise in STREAMS])


def _np(tree):
    return jax.tree.map(np.array, tree)


@functools.lru_cache(maxsize=None)
def jax_session():
    """The JAX package's run over frames(): a list, one entry per step,
    of (state, frame result, scanner result) as numpy pytrees, each
    stream-major."""
    params = load_all_params()
    step = jax.jit(jax.vmap(lambda s, y: scanner_step(params, s, y)))
    fr = frames()
    state = jax.vmap(lambda _: scanner_reset(now=NOW))(jnp.arange(len(fr)))
    out = []
    for t in range(N_FRAMES):
        state, (frame, result) = step(state, jnp.asarray(fr[:, t]))
        out.append((_np(state), _np(frame), _np(result)))
    return out


def fixture_arrays():
    """What smoke_session.npz holds, computed now from the JAX package."""
    run = jax_session()
    k = FIXTURE_STREAMS

    def per_frame(get):
        return np.stack([get(f)[:k] for _, f, _ in run], axis=1)

    final = run[-1][0]
    return {
        "frames": frames()[:k],
        "now": np.asarray(NOW, np.int32),
        "vseg_y_offset": per_frame(lambda f: f.vseg.y_offset),
        "vseg_pattern_type": per_frame(lambda f: f.vseg.pattern_type),
        "vseg_score": per_frame(lambda f: f.vseg.score),
        "hseg_n_offsets": per_frame(lambda f: f.hseg.n_offsets),
        "hseg_offsets": per_frame(lambda f: f.hseg.offsets),
        "hseg_pattern_offset": per_frame(lambda f: f.hseg.pattern_offset),
        "hseg_number_width": per_frame(lambda f: f.hseg.number_width),
        "hseg_score": per_frame(lambda f: f.hseg.score),
        "scores": per_frame(lambda f: f.scores),
        "usable": per_frame(lambda f: f.usable),
        "number_complete": final.number_complete[:k],
        "completed_digits": final.completed_digits[:k],
        "completed_n": final.completed_n[:k],
    }


if __name__ == "__main__":
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez_compressed(FIXTURE, **fixture_arrays())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
