"""SIFT detect+describe+match throughput (BASELINE config 2 front half).

Times detect_batch on 8 VGA-class frames followed by descriptor matching
of consecutive pairs, chained on-device (lax.scan with a data dependency)
and synced with block_until_ready. The reference's counterpart is
SiftGPU detect + SiftMatchGPU (FeatureProc.cpp:20,83-90) — it publishes no
numbers (SURVEY §6), so the CPU run of this same harness (--cpu) is the
recorded baseline.

Usage: python bench/sift_bench.py [--cpu] [--frames 8] [--kp 512]
Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for i in range(n):
        img = np.zeros((h, w), np.float32)
        for _ in range(200):
            cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
            s = rng.uniform(2.0, 12.0)
            a = rng.uniform(-1.0, 1.0)
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) /
                              (2 * s * s))
        imgs.append(img * 80.0 + 120.0)
    return np.stack(imgs).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--kp", type=int, default=512)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()
    import jax.numpy as jnp
    from multiviewstitch_tpu.ops.features import detect_batch
    from multiviewstitch_tpu.ops.match import match_descriptors

    n = args.frames
    frames = jnp.asarray(make_frames(n, args.height, args.width))
    REPS = args.reps

    @jax.jit
    def step(fr):
        def body(carry, _):
            kp = detect_batch(carry, max_keypoints=args.kp)
            m = jax.vmap(lambda a, va, b, vb: match_descriptors(
                a, va, b, vb).valid.sum())(
                kp.desc[:-1], kp.valid[:-1], kp.desc[1:], kp.valid[1:])
            total = m.sum().astype(jnp.float32)
            # data dependency between reps without changing the images
            return carry + total * 1e-20, total
        out, totals = jax.lax.scan(body, fr, None, length=REPS)
        return out, totals

    jax.block_until_ready(step(frames))        # compile + warm
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        out, totals = jax.block_until_ready(step(frames))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts)) / REPS
    fps = n / dt
    print(json.dumps({
        "metric": "sift_detect_match_frames_per_s",
        "value": round(fps, 2),
        "unit": f"frames/s ({n}x {args.height}x{args.width}, "
                f"{args.kp} kp, detect+describe+pairwise match)",
        "device": device_info(),
        "matches_per_pair": round(float(totals[0]) / max(n - 1, 1), 1),
        "all_s": ts,
    }))


if __name__ == "__main__":
    main()
