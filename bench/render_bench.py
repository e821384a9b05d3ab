"""Rasterizer + view-synthesis benchmark on the default device.

Times
  - render_disparity: one VGA frame of a ~100k-face mesh (the Model2Depth
    re-render unit, Model2Depth.cpp:118-156)
  - synthesize_views: 3 virtual views of one VGA RGB frame (GenNewViews,
    Image3D.cpp:109-222)
chained on-device (lax.scan with a data dependency), synced with
block_until_ready. Usage: python bench/render_bench.py [--cpu]
Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.rasterizer import render_disparity
    from multiviewstitch_tpu.ops.view_synth import (synthesize_views,
                                                    view_angles)
    from multiviewstitch_tpu.pipeline.fixtures import uv_sphere

    h, w = 480, 640
    # ~100k-face sphere in front of the camera
    v, f = uv_sphere(224, 224, radius=0.8)
    v = v.astype(np.float32)
    v[:, 2] += 2.5
    verts = jnp.asarray(v)
    faces = jnp.asarray(f.astype(np.int32))
    fmask = jnp.ones(len(f), bool)
    K = jnp.asarray([[520.0, 0, (w - 1) / 2], [0, 520.0, (h - 1) / 2],
                     [0, 0, 1]], jnp.float32)
    cam = CameraBatch(K, jnp.eye(3), jnp.zeros(3), w, h)
    REPS = args.reps

    def timeit(fn, *a):
        jax.block_until_ready(fn(*a))          # compile + warm
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    @jax.jit
    def render_chain(vv):
        def body(carry, _):
            out = render_disparity(carry, faces, fmask, cam,
                                   height=h, width=w)
            s = out.disparity.sum()
            return carry + s * 1e-20, s
        out, _ = jax.lax.scan(body, vv, None, length=REPS)
        return jnp.sum(out) * 1e-20

    t_render = timeit(render_chain, verts) / REPS

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, size=(h, w, 3)).astype(np.float32))
    angles = jnp.asarray(view_angles(3, 16.0))

    @jax.jit
    def synth_chain(im):
        def body(carry, _):
            sv = synthesize_views(carry, K, jnp.eye(3), angles)
            s = sv.images.sum()
            return carry + s * 1e-20, s
        out, _ = jax.lax.scan(body, im, None, length=REPS)
        return jnp.sum(out) * 1e-20

    t_synth = timeit(synth_chain, img) / REPS

    # gray single-channel synthesis: the shape the align pipeline pays
    # per frame (_prep_sequence_views feeds gray[..., None])
    t_synth_gray = timeit(synth_chain, img[..., :1]) / REPS

    # config-3 render-refine loop: one outer iteration = re-render the
    # model into all N frames + variational depth refine against the
    # measured maps (the reference's Model2Depth/DepthOptimizer loop,
    # Model2Depth.cpp:118-156; VERDICT r3 item 6's missing wall)
    from multiviewstitch_tpu.ops.depth_refine import refine_depth
    from multiviewstitch_tpu.ops.rasterizer import render_sequence
    from multiviewstitch_tpu.pipeline.fixtures import ring_cameras
    n_frames = 8
    # look at the sphere's actual center (z=2.5): aiming at the origin
    # puts it at grazing close-up angles whose giant faces fall through to
    # the full-frame passes
    cams8 = ring_cameras(n_frames, radius=2.5, width=w, img_height=h,
                         length_focal=520.0, arc_deg=90.0,
                         look_at=(0.0, 0.0, 2.5))
    measured = jnp.asarray(
        rng.uniform(0.3, 0.5, size=(n_frames, h, w)).astype(np.float32))

    @jax.jit
    def loop_chain(vv):
        def body(carry, _):
            disp = render_sequence(carry, faces, fmask, cams8,
                                   height=h, width=w)
            ref = refine_depth(measured, disp)
            s = ref.sum()
            return carry + s * 1e-20, s
        out, _ = jax.lax.scan(body, vv, None, length=2)
        return jnp.sum(out) * 1e-20

    t_loop = timeit(loop_chain, verts) / 2

    out = {"metric": "render_and_viewsynth_ms",
           "device": device_info(),
           "render_ms_per_frame_100k_faces": t_render * 1e3,
           "viewsynth_ms_per_3view_vga": t_synth * 1e3,
           "viewsynth_gray_ms_per_3view_vga": t_synth_gray * 1e3,
           "config3_loop_ms_per_outer_iter_8f": t_loop * 1e3}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
