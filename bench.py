"""Benchmark: frames/s of the front-end step on the default device.

Times the fused per-sequence pipeline front-end (cross-view depth
consistency + multi-frame oriented point sampling) on VGA frames — the
per-pixel work that dominates the reference's serial CPU pipeline
(Processor::CheckConsistencyCore O(h*w*refs) loop + GeoRec point sampling).

Prints ONE JSON line with the device it ran on.
"""

import json
import os
import time

import numpy as np


def make_inputs(n=8, h=480, w=640):
    rng = np.random.default_rng(0)
    disp = rng.uniform(0.2, 0.4, size=(n, h, w)).astype(np.float32)
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = 520.0
    K[:, 1, 1] = 520.0
    K[:, 0, 2] = (w - 1) / 2
    K[:, 1, 2] = (h - 1) / 2
    K[:, 2, 2] = 1.0
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    t = np.zeros((n, 3), np.float32)
    t[:, 0] = np.linspace(0, 0.3, n)
    return disp, K, R, t


def main():
    import jax
    import jax.numpy as jnp
    from multiviewstitch_tpu.core.cameras import CameraBatch
    from multiviewstitch_tpu.ops.consistency import check_consistency
    from multiviewstitch_tpu.ops.point_sampling import sample_oriented_points
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info

    enable_compile_cache()
    n, h, w = 8, 480, 640
    disp, K, R, t = make_inputs(n, h, w)

    REPS = 10  # chained on-device with a real dependency between reps

    @jax.jit
    def chained(disp, K, R, t):
        cams = CameraBatch(K, R, t, w, h)

        def body(carry, _):
            d, total = carry
            f = check_consistency(d, cams, min_dsp=1e-3, max_dsp=10.0,
                                  reproj_err=4)
            op = sample_oriented_points(f, cams, min_dsp=1e-3,
                                        max_dsp=10.0, sample_radius=2,
                                        nbr_num=2, nbr_step=1, dsp_err=0.05,
                                        conf_min=0.5)
            # real dependency between reps: no CSE across iterations
            return (jnp.where(f > 0, f, d),
                    total + op.valid.sum().astype(jnp.float32)), None

        # scan: the step compiles ONCE (a python loop would multiply the
        # program size by REPS)
        (d, total), _ = jax.lax.scan(body, (disp, jnp.float32(0.0)), None,
                                     length=REPS)
        return d, total

    args = [jnp.asarray(x) for x in (disp, K, R, t)]
    jax.block_until_ready(chained(*args))          # compile + warm

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(*args))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    fps = n * REPS / med

    print(json.dumps({
        "metric": "frontend_frames_per_s",
        "value": fps,
        "unit": "frames/s (8x VGA consistency+sampling)",
        "device": device_info(),
        "median_of": 5,
        "run_spread": (max(times) - min(times)) / med,
        "all_s": times,
    }))


if __name__ == "__main__":
    main()
