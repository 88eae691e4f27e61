"""A/B cheap accuracy levers on the bench blob scene (CPU-friendly).

bench.py reports ATE 0.118 m where the reference-port baseline measures
0.094 m on the same scene — the one metric the port still wins.  This
sweeps per-step-cost-free (or near-free) config levers over >= 3 scene
seeds to find what actually moves blob-scene ATE (one seed is chaotic;
verify-skill rule).

Run CPU: JAX_PLATFORMS=cpu python tools/exp_ate_levers.py
"""
import dataclasses
import time

import numpy as np


def run_variant(label, cfg, seeds, n_frames=100, n_points=None, H=376,
                W=1241, speed=0.8):
    import jax
    import jax.numpy as jnp

    from rso.engine import Engine
    from rso.geometry import pose_matrix
    from rso.geometry.stereo_camera import StereoCamera
    from rso.metrics.ate import ate_rmse
    from rso.synthetic import make_sequence

    if n_points is None:
        # bench.py density: 8000 points / 480 frames
        n_points = int(8000 * n_frames / 480)
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    ates = []
    for seed in seeds:
        seq = make_sequence(n_frames=n_frames, n_points=n_points, H=H, W=W,
                            cam=cam, speed=speed, seed=seed)
        eng = Engine(cfg, seq.cam)
        lefts = jnp.stack([jnp.asarray(l) for l, _ in seq.frames])
        rights = jnp.stack([jnp.asarray(r) for _, r in seq.frames])
        res = eng.process_chunk(lefts, rights)
        rel = np.asarray(res.pose)
        valids = np.asarray(res.valid)
        T = np.eye(4)
        poses = [T.copy()]
        last = None
        for k in range(n_frames):
            if valids[k]:
                last = np.asarray(pose_matrix(rel[k]))
            if last is not None:
                T = T @ last
            poses.append(T.copy())
        a = ate_rmse(np.stack(poses), seq.poses)
        ates.append(a)
        print(f"  {label} seed={seed}: ATE {a:.4f} m "
              f"({int(valids.sum())}/{n_frames} valid)", flush=True)
    arr = np.asarray(ates)
    print(f"{label}: mean {arr.mean():.4f} m  max {arr.max():.4f} m", flush=True)
    return arr


def main():
    from rso.synthetic import synthetic_config

    cfg0 = synthetic_config()
    seeds = [0, 1, 2]

    t0 = time.time()
    base = run_variant("baseline(cfg0)", cfg0, seeds)

    variants = {
        # deeper RANSAC pool: measured +0.04 ms per extra 64 hypotheses
        "ransac256": cfg0.replace(
            engine=dataclasses.replace(cfg0.engine, ransac_iters=256)),
        # tighter inlier gate
        "ransac_th0.5": cfg0.replace(
            engine=dataclasses.replace(cfg0.engine, ransac_threshold=0.5)),
        # exact top-K (costs ~0.4 ms/image-pass; measure the ATE side)
        "topk1.0": cfg0.replace(
            engine=dataclasses.replace(cfg0.engine, topk_recall=1.0)),
        # keep more observations for the solver (min_distance drives both
        # the stage-2 NMS radius and the stage-5 decimation, like the
        # reference's shared TDetectParams.min_distance)
        "min_distance2": cfg0.replace(
            detect=dataclasses.replace(cfg0.detect, min_distance=2)),
        # tighter phase-1 outlier cut before phase 2
        "residual_th4": cfg0.replace(
            least_squares=dataclasses.replace(
                cfg0.least_squares, residual_threshold=4.0)),
    }
    out = {"baseline": base}
    for name, cfg in variants.items():
        out[name] = run_variant(name, cfg, seeds)
    print(f"\ntotal {time.time() - t0:.0f}s")
    print(f"{'variant':<16} {'mean':>8} {'max':>8}  vs base mean")
    b = out["baseline"].mean()
    for k, v in out.items():
        print(f"{k:<16} {v.mean():8.4f} {v.max():8.4f}  "
              f"{(v.mean() - b) / b * 100:+6.1f}%")


if __name__ == "__main__":
    main()
