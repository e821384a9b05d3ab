"""End-to-end pipeline benchmark on the default device.

Times the FULL align path — features -> batched edge sweep -> filter
cascade -> RANSAC SRT -> keyframe selection -> (optional pose-graph
refine) -> fusion — through the public align_sequences/fuse_sequences API,
wall-clock including every host sync, at two BASELINE shapes:

  config-2: 2 sequences x 5 VGA frames (the AlignmentSeq unit of work,
            Processor.cpp:835-1106)
  config-4: 4 sequences x 4 frames (16 views, chained pairwise)

Per-stage wins can hide host-sync losses; this is the number that can't.

Run: python bench/e2e.py [--cpu] [--small]   (prints one JSON line)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="128x96 frames (CI-sized smoke run)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from multiviewstitch_tpu.utils.compile_cache import enable_compile_cache
    from multiviewstitch_tpu.utils.profiling import device_info
    enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp
    from multiviewstitch_tpu.pipeline.fixtures import (
        build_two_sequences, E2E_CONFIG as CFG)
    from multiviewstitch_tpu.pipeline.align_seq import (align_sequences,
                                                        fuse_sequences)

    if args.small:
        w, h = 128, 96
    else:
        w, h = 640, 480
    cfg = CFG.replace(max_keypoints=512)

    results = {}

    def stage_breakdown(seqs, warm=True):
        """Per-stage wall times (each stage synced) for one align+fuse run.
        Stages mirror align_sequences' internal sequencing. Runs itself
        twice: the first pass compiles the per-leaf sync fetch programs,
        the second pass measures."""
        if warm:
            stage_breakdown(seqs, warm=False)
        from multiviewstitch_tpu.pipeline.match_edges import (
            prep_sequence, match_edges, edge_knobs, select_keyframe)
        from multiviewstitch_tpu.pipeline.align_seq import (
            match_sequence_pair)
        import jax
        t = {}

        def sync(tree):
            jax.block_until_ready(tree)

        t0 = time.perf_counter()
        preps = [prep_sequence(s, cfg) for s in seqs]
        sync(preps)
        t["prep_synth_detect_s"] = time.perf_counter() - t0

        key = jax.random.key(0)
        t0 = time.perf_counter()
        ebs = []
        for k in range(len(seqs) - 1):
            key, sub = jax.random.split(key)
            ebs.append(match_edges(preps[k], preps[k + 1], sub,
                                   **edge_knobs(cfg)))
        sync([eb.residual for eb in ebs])
        t["edge_sweep_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for eb in ebs:
            select_keyframe(eb, cfg.min_match_count)
        t["select_hostpull_s"] = time.perf_counter() - t0

        # full per-pair path incl. candidate host pulls + final RANSAC,
        # minus what the stages above already cover
        t0 = time.perf_counter()
        key = jax.random.key(0)
        for k in range(len(seqs) - 1):
            key, sub = jax.random.split(key)
            match_sequence_pair(seqs[k], seqs[k + 1], cfg, sub,
                                preps[k], preps[k + 1])
        t["pair_total_s"] = time.perf_counter() - t0

        res = align_sequences(seqs, cfg, seed=0)
        t0 = time.perf_counter()
        fuse_sequences(seqs, res, cfg)
        t["fuse_s"] = time.perf_counter() - t0
        return t

    def run_case(name, seqs, breakdown=False):
        n_frames = sum(int(s.gray.shape[0]) for s in seqs)

        def once():
            res = align_sequences(seqs, cfg, seed=0)
            fuse_sequences(seqs, res, cfg)   # returns host numpy arrays
            return res

        once()                           # warm (compile)
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            once()
            ts.append(time.perf_counter() - t0)
        wall = float(np.median(ts))
        results[name] = {"wall_s": wall,
                         "frames_per_s": n_frames / wall,
                         "n_frames": n_frames}
        if breakdown:
            results[name]["stages"] = stage_breakdown(seqs)
        print(f"{name}: {wall:.3f}s wall, {n_frames / wall:.2f} frames/s"
              + (f" stages={results[name].get('stages')}" if breakdown
                 else ""),
              file=sys.stderr)

    # config-2: two sequences, 5 frames each
    seq1, seq2, gt, _, _ = build_two_sequences(n_frames=5, width=w,
                                               height=h)
    run_case("config2_align_fuse", [seq1, seq2], breakdown=True)

    # config-4 shape: 4 sequences x 4 frames = 16 views
    s1, s2, _, _, _ = build_two_sequences(n_frames=4, width=w, height=h)
    s3, s4, _, _, _ = build_two_sequences(n_frames=4, width=w, height=h)
    run_case("config4_align_fuse_16view", [s1, s2, s3, s4])

    out = {"metric": "e2e_align_fuse", "device": device_info(),
           "width": w, "height": h,
           "cases": results}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
