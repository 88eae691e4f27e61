"""End-to-end ATE for every reference mode combination, with a JSON artifact.

Detector x stereo-matcher x inter-frame-tracker matrix (reference modes
dmKLT/dmORB/dmFAST_ORB/dmFASTER x smSAD/smDescBF/smDescRbR x
ifmSAD/ifmDescBF/ifmDescWin/ifmOpticalFlow; semantics
stage4_match_consecutive.cpp:71-801), chunked, on either the blob scene or
the textured corridor (real-image statistics).

Usage: python tools/eval_modes.py [--frames N] [--scene blob|textured]
       [--speed S] [--skip 0,3] [--json OUT.json]
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--scene", choices=("blob", "textured"), default="blob")
    ap.add_argument("--speed", type=float, default=0.8)
    ap.add_argument("--skip", default="")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    import jax, jax.numpy as jnp
    from rso.config import (DetectMethod, IFMatchMethod, StereoMatchMethod)
    from rso.engine import Engine
    from rso.geometry import pose_matrix
    from rso.metrics.ate import ate_rmse
    from rso.geometry.stereo_camera import StereoCamera
    from rso.synthetic import (make_sequence, make_textured_sequence,
                               synthetic_config, textured_config)

    W, H = 1241, 376
    N = args.frames
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    if args.scene == "blob":
        seq = make_sequence(n_frames=N, n_points=max(2000, N * 17), H=H, W=W,
                            cam=cam, speed=args.speed)
        base = synthetic_config()
    else:
        seq = make_textured_sequence(n_frames=N, H=H, W=W, cam=cam,
                                     speed=args.speed, px_per_m=24.0,
                                     corridor=(8.0, 3.0))
        base = textured_config()
    L = jnp.stack([jnp.asarray(l) for l, _ in seq.frames])
    R = jnp.stack([jnp.asarray(r) for _, r in seq.frames])

    # the reference's meaningful combinations (stage3/stage4 cross-support):
    combos = [
        # name, detector, stereo matcher, tracker
        ("FASTER +SAD   +SAD  (default)",
         DetectMethod.FASTER, StereoMatchMethod.SAD, IFMatchMethod.SAD),
        ("FASTER +SAD   +LK   (optical flow)",
         DetectMethod.FASTER, StereoMatchMethod.SAD, IFMatchMethod.OPTICAL_FLOW),
        ("KLT    +SAD   +SAD",
         DetectMethod.KLT, StereoMatchMethod.SAD, IFMatchMethod.SAD),
        ("ORB    +DescBF+DescBF (1 octave)",
         DetectMethod.ORB, StereoMatchMethod.DESC_BF, IFMatchMethod.DESC_BF),
        ("FAST_ORB+DescRbR+DescWin",
         DetectMethod.FAST_ORB, StereoMatchMethod.DESC_RBR, IFMatchMethod.DESC_WIN),
        ("FAST_ORB+DescBF+DescBF",
         DetectMethod.FAST_ORB, StereoMatchMethod.DESC_BF, IFMatchMethod.DESC_BF),
        ("FAST_ORB+SAD  +DescWin",
         DetectMethod.FAST_ORB, StereoMatchMethod.SAD, IFMatchMethod.DESC_WIN),
    ]
    skip = args.skip.split(",") if args.skip else []
    rows = []
    for ci, (name, dm, sm, ifm) in enumerate(combos):
        if str(ci) in skip:
            continue
        cfg = base.replace(
            detect=dataclasses.replace(
                base.detect, detect_method=dm,
                minimum_ORB_response=0.0),
            lr_match=dataclasses.replace(base.lr_match, match_method=sm,
                                         orb_max_distance=90.0),
            if_match=dataclasses.replace(base.if_match, ifm_method=ifm,
                                         orb_max_distance=90.0),
        )
        if dm == DetectMethod.ORB:
            cfg = cfg.replace(rectify=dataclasses.replace(cfg.rectify,
                                                          nOctaves=1))
        eng = Engine(cfg, cam)
        try:
            res = eng.process_chunk(L, R)
        except Exception as e:  # keep the matrix running
            print(f"{name:<40} ERROR {type(e).__name__}: {e}", flush=True)
            rows.append({"mode": name.strip(), "error": str(e)})
            continue
        rel = np.asarray(res.pose); ok = np.asarray(res.valid)
        T = np.eye(4); est = [T.copy()]; last = None
        for k in range(N):
            if ok[k]:
                last = np.asarray(pose_matrix(rel[k]))
            if last is not None:
                T = T @ last
            est.append(T.copy())
        a = ate_rmse(np.asarray(est[:N]), seq.poses)
        nval = int(ok.sum())
        print(f"{name:<40} ATE {a:7.4f} m   valid {nval}/{N}", flush=True)
        rows.append({"mode": name.strip(), "ate_m": float(a),
                     "valid": nval, "frames": N})
    print(f"backend: {jax.default_backend()}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scene": args.scene, "frames": N, "speed": args.speed,
                       "backend": jax.default_backend(), "modes": rows},
                      f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
