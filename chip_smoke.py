#!/usr/bin/env python
"""Smoke test of rso on a GPU: the quickest proof that the system still runs.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: the sharded paths only

One process; it fails (non-zero exit, no result line) unless JAX's default
backend is a GPU, and any failed check fails the run.  Phases, one card:

  device   device kind/count, card name and power limit (nvidia-smi child)
  compile  the bench-configuration step at 1241x376: compile time and
           memory_analysis()
  kernels  the stage-3/4 exact-SAD cores on the card vs NumPy brute force at
           the octave widths, the RANSAC null vector vs float64 eigh, and
           matmul precision "highest" (the step has no hand-written kernel:
           plain XLA won the on-card A/B, PERF.md)
  vo       480 frames through Engine.process_chunk, 30 through process_frame
           (same blob scene as bench.py): agreement, finiteness, ATE and
           valid fraction within bounds taken from the same scene on a CPU
  ba       VOWithBA (the `rso.cli.demo --ba` path) over 100 frames, then
           bundle_adjust on the 8x1024 bench problem: finite, cost decreases
  tests    the `gpu`-marked tests, in this process

--four runs window-sharded, landmark-sharded and batch-of-sequences paths
on a four-card mesh, each against its one-device result.

The last line is one JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

H, W = 376, 1241
N_CHUNK, N_POINTS, N_LIVE, N_ATE, N_BA = 480, 8000, 30, 120, 100
# Same scene on a CPU (JAX_PLATFORMS=cpu, this script's vo phase; the same
# program as on the GPU): ATE over the first 120
# frames 0.1170 m, valid fraction 475/480.  Bounds: ATE within 1.5x of that,
# valid fraction at most 0.02 lower.
CPU_ATE_M, CPU_VALID = 0.1170, 475 / 480
ATE_MAX_M, VALID_MIN = 1.5 * CPU_ATE_M, CPU_VALID - 0.02


_T0 = time.perf_counter()


def say(*a):
    if a and str(a[0]).startswith("=="):
        a = (f"{a[0]} [t={time.perf_counter() - _T0:.1f} s]",) + a[1:]
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    say(f"  ok: {what}")


def bench_camera():
    from rso.geometry.stereo_camera import StereoCamera

    return StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                             cy_l=H / 2.0, baseline=0.5371)


def phase_compile(cfg, cam):
    import jax
    import jax.numpy as jnp

    from rso.engine import init_state, make_step

    say("== compile: bench-configuration step, 1241x376")
    step = make_step(cfg, cam, H, W)
    st = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                      init_state(cfg, (H, W)))
    img = jax.ShapeDtypeStruct((H, W), jnp.uint8)
    lowered = jax.jit(step).lower(st, img, img)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    say(f"  compile time: {time.perf_counter() - t0:.3f} s")
    say(f"  memory_analysis: {compiled.memory_analysis()}")


def phase_kernels(cfg):
    import jax
    import jax.numpy as jnp

    from rso.frontend.detect import octave_k_slots
    from rso.kernels.distance import stereo_sad_best, track_sad_best
    from rso.kernels.smallchol import nullvec9

    say("== kernels: exact-SAD cores vs NumPy, null vector vs eigh")
    prec = jax.config.jax_default_matmul_precision
    check(prec == "highest", f"jax_default_matmul_precision is {prec!r}")
    ks = octave_k_slots(cfg.detect.orb_nfeats, cfg.n_octaves,
                        cfg.engine.max_kps_per_octave,
                        cfg.engine.octave_slot_decay)
    rng = np.random.default_rng(0)
    skw = dict(max_y_diff=1.0, max_disp=0.7 * W, max_distance=4000.0)
    tkw = dict(win_row=40.0, win_col=40.0, sad_max=4000.0)
    stereo = jax.jit(lambda *a: stereo_sad_best(*a, **skw))
    track = jax.jit(lambda *a: track_sad_best(*a, **tkw))

    def sad(a, b):
        return np.abs(a[:, None, :] - b[None, :, :]).sum(-1)

    def best_ok(what, idx, dist, Dm):
        """distances bit-equal; index equal or pointing at a tie"""
        ref = Dm.min(1)
        hit = ref < 1e9
        say(f"  {what}: max|best_d - numpy| = {np.abs(dist - ref).max()} "
            f"(tolerance 0); {int(hit.sum())} rows with a match")
        check(np.array_equal(dist, ref), f"{what} distances bit-equal")
        check(np.all(Dm[hit, idx[hit]] == ref[hit]),
              f"{what} best index equal or tied")

    for K in sorted(set(ks)) + [203]:   # 203: an odd K
        # noisy copies so real matches exist; u8-valued, so SADs are exact
        base = rng.integers(0, 256, (K, 64))
        p_l = base.astype(np.float32)
        p_r = np.clip(base[rng.permutation(K)] + rng.integers(-6, 7, (K, 64)),
                      0, 255).astype(np.float32)
        xy_l = np.stack([rng.uniform(20, W - 20, K),
                         rng.integers(0, 12, K)], -1).astype(np.float32)
        xy_r = np.stack([xy_l[:, 0] - rng.uniform(-30, 200, K),
                         xy_l[:, 1] + rng.uniform(-0.7, 0.7, K)],
                        -1).astype(np.float32)
        ok_l, ok_r = rng.random(K) > 0.05, rng.random(K) > 0.05
        br, bd, _ = (np.asarray(x) for x in stereo(
            *(jnp.asarray(a) for a in (p_l, p_r, xy_l, xy_r, ok_l, ok_r))))
        D = sad(p_l, p_r)
        disp = xy_l[:, 0][:, None] - xy_r[:, 0][None, :]
        ok = (ok_l[:, None] & ok_r[None, :]
              & (np.abs(np.round(xy_l[:, 1])[:, None]
                        - np.round(xy_r[:, 1])[None, :]) <= 1.0)
              & (disp >= 1.0) & (disp <= skw["max_disp"]) & (D <= 4000.0))
        best_ok(f"stereo K={K}", br, bd, np.where(ok, D, 1e9))

        p_l2 = np.clip(p_l + rng.integers(-4, 5, (K, 64)), 0, 255)
        p_r2 = np.clip(p_r + rng.integers(-4, 5, (K, 64)), 0, 255)
        c_xy = (xy_l + rng.uniform(-30, 30, (K, 2))).astype(np.float32)
        c_rx = (c_xy[:, 0] - rng.uniform(2, 30, K)).astype(np.float32)
        targs = (p_l, p_l2, p_r, p_r2, xy_l, c_xy, xy_r[:, 0], c_rx)
        bc, tbd = (np.asarray(x) for x in track(
            *(jnp.asarray(np.asarray(a, np.float32)) for a in targs),
            jnp.asarray(ok_l), jnp.asarray(ok_r)))
        sl, sr = sad(p_l, p_l2), sad(p_r, p_r2)
        ok = (ok_l[:, None] & ok_r[None, :]
              & (np.abs(xy_l[:, 1][:, None] - c_xy[:, 1][None]) <= 40.0)
              & (np.abs(xy_l[:, 0][:, None] - c_xy[:, 0][None]) <= 40.0)
              & (np.abs(xy_r[:, 0][:, None] - c_rx[None]) <= 40.0)
              & (sl <= 4000.0) & (sr <= 4000.0))
        best_ok(f"track  K={K}", bc, tbd, np.where(ok, sl + sr, 1e9))

    # RANSAC null vectors: 256 hypotheses of 8 normalized correspondences
    B = 256
    x1, x2 = rng.normal(0, 1, (B, 8, 2)), rng.normal(0, 1, (B, 8, 2))
    A = np.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1],
                  x2[..., 0], x2[..., 1] * x1[..., 0],
                  x2[..., 1] * x1[..., 1], x2[..., 1], x1[..., 0],
                  x1[..., 1], np.ones((B, 8))], -1).astype(np.float32)
    M = np.einsum("bki,bkj->bij", A, A)
    w, V = np.linalg.eigh(M.astype(np.float64))
    good = w[:, 1] > 1e-3 * w[:, -1]      # well-conditioned samples
    x = np.asarray(jax.jit(nullvec9)(jnp.asarray(M)))
    cos = np.abs(np.sum(x * V[:, :, 0], axis=1))[good]
    say(f"  nullvec9: {int(good.sum())}/{B} well-conditioned, "
        f"min|cos| = {cos.min():.7f} (tolerance 1 - 1e-4)")
    check(cos.min() >= 1 - 1e-4, "null vectors match float64 eigh")


def _integrate(rel_poses, valids, n):
    """Camera-to-world track with constant-velocity coast (as bench.py)."""
    import jax

    from rso.geometry import pose_matrix

    mats = np.asarray(jax.vmap(pose_matrix)(rel_poses[:n]))
    T, out, last = np.eye(4), [np.eye(4)], None
    for k in range(n):
        if valids[k]:
            last = mats[k]
        if last is not None:
            T = T @ last
        out.append(T.copy())
    return np.stack(out)


def phase_vo(cfg, cam, card):
    import jax
    import jax.numpy as jnp

    from rso.engine import Engine
    from rso.metrics.ate import ate_rmse
    from rso.synthetic import make_sequence

    say(f"== vo: {N_CHUNK}-frame chunk + {N_LIVE} frames one at a time")
    seq = make_sequence(n_frames=N_CHUNK, n_points=N_POINTS, H=H, W=W,
                        cam=cam, speed=0.8)
    lefts = jax.device_put(jnp.stack([jnp.asarray(l) for l, _ in seq.frames]))
    rights = jax.device_put(jnp.stack([jnp.asarray(r) for _, r in seq.frames]))
    eng = Engine(cfg, seq.cam)
    res = eng.process_chunk(lefts, rights)          # compiles
    jax.block_until_ready(res.pose)
    eng.reset()
    t0 = time.perf_counter()
    res = eng.process_chunk(lefts, rights)
    jax.block_until_ready(res.pose)
    fps_chunk = N_CHUNK / (time.perf_counter() - t0)
    pose_c = np.asarray(res.pose)
    valid_c = np.asarray(res.valid)

    eng.reset()
    eng.process_frame(lefts[0], rights[0])          # compiles
    eng.reset()
    live = []
    t0 = time.perf_counter()
    for i in range(N_LIVE):
        live.append(eng.process_frame(lefts[i], rights[i]).pose)
    jax.block_until_ready(live[-1])
    fps_live = N_LIVE / (time.perf_counter() - t0)
    pose_f = np.stack([np.asarray(p) for p in live])

    say(f"  frames/s: process_chunk {fps_chunk:.1f}, process_frame "
        f"{fps_live:.1f} (information only; card: {card})")
    check(np.all(np.isfinite(pose_c)) and np.all(np.isfinite(pose_f)),
          "all poses finite")
    dmax = float(np.abs(pose_f - pose_c[:N_LIVE]).max())
    check(dmax <= 1e-4, f"process_frame vs process_chunk, first {N_LIVE} "
                        f"poses: max diff {dmax:.3g} <= 1e-4")
    ate = ate_rmse(_integrate(pose_c, valid_c, N_ATE),
                   seq.poses[: N_ATE + 1])
    vfrac = float(valid_c.mean())
    say(f"  ATE over first {N_ATE} frames: {ate:.4f} m (CPU {CPU_ATE_M}, "
        f"max {ATE_MAX_M:.4f}); valid fraction {vfrac:.4f} (CPU "
        f"{CPU_VALID:.4f}, min {VALID_MIN:.4f})")
    check(ate <= ATE_MAX_M, "ATE within the CPU-derived bound")
    check(vfrac >= VALID_MIN, "valid fraction within the CPU-derived bound")
    return seq


def bench_ba_problem(cam):
    """The 8-keyframe x 1024-landmark problem of rso/cli/bench.py."""
    import jax.numpy as jnp

    from rso.ba import BAProblem
    from rso.ba.ba import _project_grid

    rng = np.random.default_rng(0)
    P, L = 8, 1024
    poses0 = jnp.zeros((P, 6), jnp.float32).at[:, 5].set(
        jnp.arange(P, dtype=jnp.float32) * -0.4)
    lmks0 = jnp.asarray(np.stack([rng.uniform(-10, 10, L),
                                  rng.uniform(-5, 5, L),
                                  rng.uniform(5, 40, L)], -1), jnp.float32)
    obs, _, _ = _project_grid(cam, poses0, lmks0)
    return BAProblem(poses=poses0 + 0.01, lmks=lmks0 + 0.05, obs=obs,
                     mask=jnp.ones((P, L), bool))


def phase_ba(cfg, cam, seq):
    import jax

    from rso.ba import bundle_adjust
    from rso.ba.pipeline import VOWithBA

    say(f"== ba: VOWithBA over {N_BA} frames, bundle_adjust 8x1024")
    ba = VOWithBA(cfg, seq.cam, max_keyframes=8, max_landmarks=1024)
    out = [ba.process_frame(*seq.frames[i]) for i in range(N_BA)]
    poses = np.stack([o.pose_wc for o in out])
    n_kf = sum(o.is_keyframe for o in out)
    costs = [o.ba_cost for o in out if o.ba_cost is not None]
    say(f"  {n_kf} keyframes, {len(costs)} window solves")
    check(np.all(np.isfinite(poses)), "VOWithBA poses finite")
    check(len(costs) > 0 and np.all(np.isfinite(costs)),
          "window BA ran and its costs are finite")

    prob = bench_ba_problem(cam)
    c0 = float(jax.jit(lambda p: bundle_adjust(cam, p, max_iters=0).cost)(
        prob))
    res = jax.jit(lambda p: bundle_adjust(cam, p, max_iters=5))(prob)
    c1 = float(res.cost)
    say(f"  bundle_adjust: cost {c0:.6g} -> {c1:.6g} in "
        f"{int(res.n_iters)} iterations")
    check(np.all(np.isfinite(np.asarray(res.poses))), "BA poses finite")
    check(c1 <= c0, "BA cost did not increase")


def phase_tests():
    import pytest

    say("== tests: gpu-marked tests (pytest -m gpu tests/test_backend.py)")
    os.environ["RSO_TEST_DEVICE"] = "gpu"   # the conftest keeps the card
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_backend.py")])
    check(rc == 0, f"gpu-marked tests pass (pytest exit code {rc})")


def phase_four():
    import jax
    import jax.numpy as jnp

    from rso.ba import bundle_adjust
    from rso.ba.distributed import distributed_bundle_adjust, make_mesh
    from rso.ba.window_sharded import (
        make_win_mesh,
        window_sharded_bundle_adjust,
    )
    from rso.engine import Engine
    from rso.parallel import BatchEngine
    from rso.synthetic import make_sequence, synthetic_config

    def distinct(mesh, what):
        ids = {d.id for d in mesh.devices.flat}
        check(mesh.devices.size == 4 and len(ids) == 4,
              f"{what} mesh spans 4 distinct devices {sorted(ids)}")

    cam = bench_camera()
    say("== four: window-sharded BA, ('win','lmk') = (2,2)")
    base = bench_ba_problem(cam)
    probs = [base._replace(poses=base.poses + 0.002 * w) for w in range(4)]
    mesh = make_win_mesh(2, 2)
    distinct(mesh, "('win','lmk')")
    outs = window_sharded_bundle_adjust(cam, probs, mesh, max_iters=10)
    for w, (prob, out) in enumerate(zip(probs, outs)):
        ref = bundle_adjust(cam, prob, max_iters=10)
        d = float(np.abs(np.asarray(out.poses) - np.asarray(ref.poses)).max())
        check(d <= 1e-3, f"window {w}: poses vs one device, max diff "
                         f"{d:.3g} <= 1e-3")

    say("== four: landmark-sharded BA, 'lmk' = 4")
    mesh = make_mesh(4)
    distinct(mesh, "'lmk'")
    out = distributed_bundle_adjust(cam, base, mesh, max_iters=10)
    ref = bundle_adjust(cam, base, max_iters=10)
    d = float(np.abs(np.asarray(out.poses) - np.asarray(ref.poses)).max())
    check(d <= 1e-3, f"poses vs one device, max diff {d:.3g} <= 1e-3")

    say("== four: BatchEngine, 4 sequences over 'seq' = 4")
    # depth cut to one octave: the check is the sharding, and the four-card
    # call pays for every second of compile
    cfg = synthetic_config()
    cfg = cfg.replace(rectify=dataclasses.replace(cfg.rectify, nOctaves=1))
    n = 8
    seqs = [make_sequence(n_frames=n, n_points=2000, H=H, W=W, cam=cam,
                          speed=0.8, seed=s) for s in range(4)]
    be = BatchEngine(cfg, cam, batch=4, img_h=H, img_w=W)
    distinct(be.mesh, "'seq'")
    res = be.process_chunk(
        np.stack([np.stack([l for l, _ in s.frames]) for s in seqs]),
        np.stack([np.stack([r for _, r in s.frames]) for s in seqs]))
    shards = {s.device.id for s in res.pose.addressable_shards}
    check(len(shards) == 4, f"results sharded over devices {sorted(shards)}")
    for i, s in enumerate(seqs):
        eng = Engine(cfg, cam)
        one = eng.process_chunk(jnp.stack([l for l, _ in s.frames]),
                                jnp.stack([r for _, r in s.frames]))
        d = float(np.abs(np.asarray(res.pose[:, i])
                         - np.asarray(one.pose)).max())
        same = np.array_equal(np.asarray(res.valid[:, i]),
                              np.asarray(one.valid))
        check(same and d <= 1e-4, f"sequence {i}: {n} poses vs one "
                                  f"Engine, max diff {d:.3g} <= 1e-4")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded paths")
    args = p.parse_args(argv)

    from rso import compile_cache
    from rso.device import card_name_and_power_limit, describe, require_gpu

    compile_cache.enable()
    devs = require_gpu()
    if args.four and len(devs) != 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    card = card_name_and_power_limit()
    say("== device")
    say(f"  jax: {devs[0].device_kind}, {len(devs)} device(s)")
    say(f"  nvidia-smi: {card}")

    from rso.synthetic import synthetic_config

    if args.four:
        phase_four()
    else:
        cfg, cam = synthetic_config(), bench_camera()
        phase_compile(cfg, cam)
        phase_kernels(cfg)
        seq = phase_vo(cfg, cam, card)
        phase_ba(cfg, cam, seq)
        phase_tests()
    say(card)
    print(json.dumps({"ok": True, "device": describe(devs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
