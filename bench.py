#!/usr/bin/env python
"""Benchmark: steady-state stereo-VO frames/sec on one GPU at KITTI image size.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
plus the device it ran on.  Fails unless JAX's default backend is a GPU.

Baseline: the reference (famoreno/stereo-vo) publishes no end-to-end numbers
and cannot be compiled here (MRPT absent), so `vs_baseline` divides by a
MEASURED run of native/rso_baseline — the faithful OpenCV port of the
reference pipeline (stages 1-5 semantics) — on a host CPU, on the same scene
(tools/measure_baseline.py writes BASELINE_MEASURED.json; re-run it to
refresh).  If the artifact is missing the round-1 estimate (20 FPS) is used
and flagged via "baseline_kind": "estimate".
"""
import json
import os
import sys

REFERENCE_FPS_ESTIMATE = 20.0  # fallback only; see module docstring


def _measured_baseline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
    try:
        with open(path) as f:
            doc = json.load(f)
        for r in doc.get("results", []):
            if r.get("scene") == "blob":   # the bench scene
                kind = "measured"
                # the artifact is host-specific: flag it when this host does
                # not match the one that measured it (different CPU/core
                # count => the baseline FPS is not this machine's)
                import platform
                here = (platform.processor() or platform.machine(),
                        os.cpu_count())
                there = (doc.get("host_cpu"), doc.get("nproc"))
                if there != here:
                    kind = "measured-other-host"
                    print(f"[bench] BASELINE_MEASURED.json was measured on "
                          f"{there}, this host is {here}; re-run "
                          f"tools/measure_baseline.py for a local baseline",
                          file=sys.stderr)
                return float(r["fps"]), kind
    except (OSError, ValueError, KeyError):
        pass
    return REFERENCE_FPS_ESTIMATE, "estimate"


def main():
    from rso import compile_cache
    from rso.cli.bench import run_bench
    from rso.device import card_name_and_power_limit, describe, require_gpu

    compile_cache.enable()
    devs = require_gpu()
    card = card_name_and_power_limit()
    print(f"[bench] {devs[0].device_kind} x{len(devs)}; card: {card}",
          file=sys.stderr)

    # 480-frame chunks amortize the one-dispatch fixed cost.  n_points
    # scales with n_frames: the synthetic blob field anchors points
    # uniformly along the trajectory, so density per metre must stay equal
    # to the original 120-frame scene or the tracker starves.
    out = run_bench(n_frames=480, n_points=8000, width=1241, height=376,
                    repeat_passes=4)
    base_fps, base_kind = _measured_baseline()
    line = {
        "metric": "vo_frames_per_sec_per_chip_kitti_size",
        "value": out["fps"],
        "unit": "frames/s",
        "vs_baseline": out["fps"] / base_fps,
        "baseline_fps": base_fps,
        "baseline_kind": base_kind,
        "ate_rmse_m": out["ate_rmse_m"],
        "fps_live_per_dispatch": out["fps_live_per_dispatch"],
        "step_ms_device": out["step_ms_device"],
        "fps_device_step": out["fps_device_step"],
        "ba_iters_per_sec": out["ba_iters_per_sec"],
        "detect_ms_per_image": out["detect_ms_per_image"],
        "detect_hbm_gbps_model": out["detect_hbm_gbps_model"],
        "card": card,
        "device": describe(devs),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
