"""Quick-tier smoke coverage of the view-synthesis prep path.

The heavier align/e2e tests are marked slow; this file stays UNMARKED so
the quick loop (`pytest -m 'not slow'`) still exercises the
`_prep_sequence_views` structure (vmapped view synthesis + batched
detection) at a tiny shape."""

import numpy as np
import jax.numpy as jnp

from multiviewstitch_tpu.config import StitchConfig
from multiviewstitch_tpu.pipeline.align_seq import (Sequence,
                                                    _prep_sequence_views)
from multiviewstitch_tpu.core.cameras import CameraBatch


def _tiny_sequence(n=2, h=48, w=64):
    rng = np.random.default_rng(0)
    gray = rng.uniform(0, 255, size=(n, h, w)).astype(np.float32)
    disp = np.full((n, h, w), 0.5, np.float32)
    K = np.asarray([[60.0, 0, (w - 1) / 2], [0, 60.0, (h - 1) / 2],
                    [0, 0, 1]], np.float32)
    cams = CameraBatch(jnp.asarray(np.tile(K, (n, 1, 1))),
                       jnp.asarray(np.tile(np.eye(3, dtype=np.float32),
                                           (n, 1, 1))),
                       jnp.zeros((n, 3), jnp.float32), w, h)
    return Sequence(jnp.asarray(gray), jnp.asarray(disp), cams)


def test_prep_sequence_views_smoke():
    seq = _tiny_sequence()
    cfg = StitchConfig().replace(view_count=3, rot_angle=10.0,
                                 max_keypoints=32, segment=False)
    kp, tex = _prep_sequence_views(seq, cfg)
    n, h, w = seq.gray.shape
    assert tex.shape == (n, 3, h, w)
    assert kp.desc.shape[:2] == (n, 3)
    # middle view is the zero-angle view: texIndex must be the identity
    # mapping wherever valid (and it is fully valid at angle 0)
    mid = np.asarray(tex[:, 1])
    ident = np.arange(h * w).reshape(h, w)
    for i in range(n):
        np.testing.assert_array_equal(mid[i], ident)
    # rotated views keep substantial coverage
    assert (np.asarray(tex[:, 0]) >= 0).mean() > 0.5
    assert (np.asarray(tex[:, 2]) >= 0).mean() > 0.5
