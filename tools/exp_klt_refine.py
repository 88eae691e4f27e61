"""Diagnose the r5 compare_baseline textured regression: KLT x refine x horizon.

The 60-frame round-5 A/B (klt_ab_r5.json) showed KLT beating FASTER on the
textured corridor every seed (0.106 vs 0.138 mean), but the refreshed
120-frame compare_baseline textured run (refine ON — its rso arm sets
subpixel_track_refine=True) measured KLT at 0.258 where round-4's FASTER
scored 0.128.  Two variables changed at once: the detector AND the horizon
/refine setting.  This isolates them: textured corridor, 120 frames,
{FASTER, KLT} x {refine off, on}, 2 seeds, one process.

Usage: python tools/exp_klt_refine.py [--json docs/artifacts/klt_refine_r5.json]
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def run(seed, dm, refine, W, H, N, cam):
    import jax.numpy as jnp

    from rso.engine import Engine
    from rso.geometry import pose_matrix
    from rso.metrics.ate import ate_rmse
    from rso.synthetic import make_textured_sequence, textured_config

    seq = make_textured_sequence(n_frames=N, H=H, W=W, cam=cam, speed=0.8,
                                 px_per_m=24.0, corridor=(8.0, 3.0),
                                 seed=seed)
    base = textured_config()
    cfg = base.replace(
        detect=dataclasses.replace(base.detect, detect_method=dm),
        engine=dataclasses.replace(base.engine, subpixel_track_refine=refine))
    eng = Engine(cfg, cam)
    L = jnp.stack([jnp.asarray(l) for l, _ in seq.frames])
    R = jnp.stack([jnp.asarray(r) for _, r in seq.frames])
    res = eng.process_chunk(L, R)
    rel = np.asarray(res.pose)
    ok = np.asarray(res.valid)
    T = np.eye(4)
    est = [T.copy()]
    last = None
    for k in range(N):
        if ok[k]:
            last = np.asarray(pose_matrix(rel[k]))
        if last is not None:
            T = T @ last
        est.append(T.copy())
    return (float(ate_rmse(np.stack(est)[: N + 1], seq.poses[: N + 1])),
            int(ok.sum()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args()

    import jax

    from rso.config import DetectMethod
    from rso.geometry.stereo_camera import StereoCamera

    W, H = 1241, 376
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    rows = []
    for seed in range(args.seeds):
        for name, dm in (("FASTER", DetectMethod.FASTER),
                         ("KLT", DetectMethod.KLT)):
            for refine in (False, True):
                a, nv = run(seed, dm, refine, W, H, args.frames, cam)
                rows.append({"seed": seed, "detector": name,
                             "refine": refine, "ate_m": a, "valid": nv})
                print(f"seed {seed} {name:<7} refine={int(refine)} "
                      f"ATE {a:7.4f} m  valid {nv}/{args.frames}",
                      flush=True)
    for name in ("FASTER", "KLT"):
        for refine in (False, True):
            sel = [r["ate_m"] for r in rows
                   if r["detector"] == name and r["refine"] == refine]
            print(f"{name:<7} refine={int(refine)} "
                  f"mean ATE {np.mean(sel):7.4f} m", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"backend": jax.default_backend(),
                       "frames": args.frames, "rows": rows}, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
