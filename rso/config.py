"""Typed, frozen configuration tree for the rso engine.

Mirrors the reference's seven parameter structs and INI sections
(reference: libstereo-odometry/include/libstereo-odometry.h:554-663, defaults in
stage1_rectify.cpp:27-30, stage2_detect.cpp:44-58, stage3_match_left_right.cpp:46-57,
common.cpp:69-84, process_new_image_pair.cpp:34-35) with identical key names so
reference INI files load unchanged.  Extended with an [ENGINE] section holding the
static capacities that make every per-frame array shape-stable (the
fixed-shape replacement for the reference's dynamic std::vectors).

All dataclasses are frozen + hashable so a config can be a `static_argnum` of a
jitted step function.
"""
from __future__ import annotations

import configparser
import dataclasses
import enum
from dataclasses import dataclass
from typing import Tuple


class DetectMethod(enum.IntEnum):
    """reference: TDetectParams::TDMethod (libstereo-odometry.h:383)."""

    ORB = 0
    FAST_ORB = 1
    FASTER = 2
    KLT = 3


class NMSMethod(enum.IntEnum):
    """reference: TDetectParams::NMSMethod."""

    STANDARD = 0
    ADAPTIVE = 1


class StereoMatchMethod(enum.IntEnum):
    """reference: TLeftRightMatchParams::TSMMethod (libstereo-odometry.h:449)."""

    DESC_BF = 0
    DESC_RBR = 1
    SAD = 2


class IFMatchMethod(enum.IntEnum):
    """reference: TInterFrameMatchingParams::TIFMMethod (libstereo-odometry.h:285)."""

    DESC_BF = 0
    DESC_WIN = 1
    SAD = 2
    OPTICAL_FLOW = 3


@dataclass(frozen=True)
class RectifyParams:
    """[RECTIFY] — reference TRectifyParams (stage1_rectify.cpp:27-30)."""

    nOctaves: int = 3


@dataclass(frozen=True)
class DetectParams:
    """[DETECT] — reference TDetectParams defaults (stage2_detect.cpp:44-58).

    Default detector: dmFASTER, same as the reference — settled by TWO
    rounds of measurement, because the short-horizon answer inverts.  At 60
    frames the round-5 3-seed A/B (docs/artifacts/klt_ab_r5.json) has dmKLT
    winning the textured corridor every seed (0.106 vs 0.138 m) and 9%
    faster per step; at 120 frames on the same corridor
    (docs/artifacts/klt_refine_r5.json) dmKLT drifts ~2x WORSE than
    dmFASTER (0.258/0.284 vs 0.121/0.154, seeds 0/1, refine on or off) —
    dense Shi-Tomasi peaks carry a slow positional bias that FAST's corner
    gate filters out, and long-horizon ATE is what deployment sees.  dmKLT
    stays available (set detect_method = 3) for short-window runs where its
    subpixel response and step speed win.  docs/MODES.md "Round 5".
    """

    detect_method: DetectMethod = DetectMethod.FASTER
    target_feats_per_pixel: float = 10.0 / 1000.0
    KLT_win: int = 4
    minimum_KLT_response: float = 10.0
    non_maximal_suppression: bool = True
    nmsMethod: NMSMethod = NMSMethod.STANDARD
    min_distance: int = 3
    orb_nfeats: int = 500
    orb_nlevels: int = 8
    minimum_ORB_response: float = 0.0
    fast_min_th: int = 5
    fast_max_th: int = 30
    initial_FAST_threshold: int = 20
    # the stage-2 call flag (reference h:1020, default false): enables the
    # per-octave FAST threshold servo toward target_feats_per_pixel
    update_dyn_thresholds: bool = False
    # rso extension: upright (unrotated) BRIEF.  The intensity-centroid
    # orientation is only stable on asymmetric patches; for low-roll rigs
    # (automotive / rectified stereo) upright descriptors match more
    # reliably.  Default False = ORB-faithful oriented BRIEF.
    orb_upright: bool = False


@dataclass(frozen=True)
class LeftRightMatchParams:
    """[MATCH] — reference TLeftRightMatchParams (stage3_match_left_right.cpp:46-57)."""

    match_method: StereoMatchMethod = StereoMatchMethod.SAD
    sad_max_distance: int = 200
    sad_max_ratio: float = 0.5
    orb_max_distance: float = 40.0
    orb_min_th: int = 30
    orb_max_th: int = 100
    enable_robust_1to1_match: bool = False
    rectified_images: bool = False
    max_y_diff: float = 0.0
    min_z: float = 0.3
    max_z: float = 5.0
    # rso extension: actually enforce the min_z/max_z depth gate as disparity
    # bounds.  The reference declares min_z/max_z (h:497) but hardcodes the
    # disparity window to [1, 0.7*W] (stage3:155-156 comments show the intent);
    # off by default for reference-faithful behavior.
    use_z_gate: bool = False


@dataclass(frozen=True)
class InterFrameMatchParams:
    """[IF-MATCH] — reference TInterFrameMatchingParams (libstereo-odometry.h:285-310).

    The reference leaves the ctor empty (common.cpp:84); these defaults match the
    demo config shipped with the reference and the windowed-SAD code paths
    (stage4_match_consecutive.cpp:441-448).
    """

    ifm_method: IFMatchMethod = IFMatchMethod.SAD
    ifm_win_w: int = 40
    ifm_win_h: int = 40
    sad_max_distance: int = 200
    sad_max_ratio: float = 0.5
    orb_max_distance: float = 40.0
    filter_fund_matrix: bool = True


@dataclass(frozen=True)
class LeastSquaresParams:
    """[LEAST_SQUARES] — reference TLeastSquaresParams (common.cpp:69-82)."""

    use_robust_kernel: bool = True
    kernel_param: float = 3.0
    max_iters: int = 100
    initial_max_iters: int = 10
    min_mod_out_vector: float = 1e-3
    std_noise_pixels: float = 1.0
    max_incr_cost: int = 3
    residual_threshold: float = 10.0
    bad_tracking_th: int = 5
    use_previous_pose_as_initial: bool = True
    use_custom_initial_pose: bool = False
    # rso extension: weight the Hessian by the robust-kernel derivative rho'
    # as well as the gradient (proper IRLS).  The reference weights only the
    # gradient (stage5_optimization.cpp:364-365), which scales GN steps by
    # rho' (~0.03 for large residuals) and stalls cold starts.  Both schemes
    # share the fixed point sum(rho' J^T r)=0, so the converged pose is the
    # same; this only changes the path.  Set False for exact reference
    # iteration behavior.
    irls_hessian_weighting: bool = True
    # rso extension: Levenberg-Marquardt damping in the pose solver (the
    # BASELINE "robust LM pose refinement" configuration).  lambda adapts
    # per accepted/rejected step; False = pure Gauss-Newton like the
    # reference.
    use_lm: bool = False
    lm_init_lambda: float = 1e-3
    # rso extension: how the 6x6 normal system solves each GN iteration.
    #   "eigh" — symmetric eigendecomposition + exact cond_2 guard +
    #            pseudo-inverse thresholding (mirrors the reference's
    #            JacobiSVD semantics, stage5_optimization.cpp:375-388).
    #   "chol" — Cholesky solve + cond_1 guard (||H||_1 ||H^-1||_1, same
    #            1e8 threshold; cond_1/cond_2 agree within a factor of 6 on
    #            6x6).  Identical dx for the well-conditioned systems real
    #            frames produce (H is PD there); near the abort threshold
    #            borderline frames may flag one iteration earlier/later.
    #            Default "chol": same pose to ~1e-7 on real solves and the
    #            same error code on degenerate input (equivalence pinned in
    #            tests/test_solver.py::TestSolveBackends); set "eigh" for
    #            the reference's exact cond_2 guard semantics.
    solve_backend: str = "chol"


@dataclass(frozen=True)
class GUIParams:
    """[GUI] — reference TGUIParams (gui_thread.cpp:34-40).

    rso has no interactive window; these flags gate the offline
    visualization writer (rso.metrics.viz) instead.
    """

    show_gui: bool = False
    draw_all_raw_feats: bool = False
    draw_lr_pairings: bool = False
    draw_tracking: bool = True


@dataclass(frozen=True)
class GeneralParams:
    """[GENERAL] — reference TGeneralParams (process_new_image_pair.cpp:34-35)."""

    vo_use_matches_ids: bool = False
    vo_save_files: bool = False
    vo_debug: bool = False
    vo_pause_it: bool = False
    vo_out_dir: str = "out"
    # Bound on consecutive keep-prev recovery frames (no reference
    # equivalent — the reference skips the prev-frame shift on EVERY
    # voecBadTracking/voecBadCondNumber, process_new_image_pair.cpp:86-89,
    # which is unbounded: the camera keeps moving, the motion-to-recover
    # grows ~1 m/frame, and one marginal solver failure can wedge the
    # engine against a stale frame for tens of frames.  After this many
    # consecutive failures the frame is consumed anyway; VO resumes from
    # fresh consecutive frames at ordinary inter-frame motion and the
    # caller bridges the short invalid gap (constant-velocity coast).
    max_recovery_frames: int = 3


@dataclass(frozen=True)
class EngineParams:
    """[ENGINE] — static capacities & numerics (no reference equivalent; this is the
    fixed-shape contract that replaces dynamic std::vector sizes everywhere)."""

    max_kps_per_octave: int = 512      # K: feature slots per image per octave
    max_tracks: int = 1024             # T: flat tracked-pair slots entering stage 5
    # Shrink per-octave slot capacities to the octave budget (rounded up to a
    # 128 lane multiple): the budget halves per octave, so uniform K wastes
    # ~60% of the stereo-match / tracking distance-matrix work on slots the
    # budget gate always empties.  frontend.detect.octave_k_slots.
    octave_slot_decay: bool = True
    # Fixed hypothesis count (replaces cv::FM_RANSAC adaptive iteration).
    # At the ~30-80 tracked counts the window search yields, the hypothesis
    # pool must be deep enough that the best model is never merely mediocre —
    # a bad accepted model erases the track set (ATE collapse measured at 64
    # on the bench scenes).  256 vs 128: -7.8% mean ATE on 3 scene seeds
    # (every seed improves; tools/exp_ate_levers.py).
    ransac_iters: int = 256
    ransac_threshold: float = 1.0      # epipolar (Sampson) inlier distance, px
    # Amortized detection (the reference's flow-mode feature-decay
    # semantics, stage4_match_consecutive.cpp:402-412, as an opt-in perf
    # mode): detect_every=N runs full stage-2/3 detection every Nth frame
    # and LK-PROPAGATES the previous frame's matched stereo pairs on the
    # frames between (rso/engine.py _propagate) — re-validated per frame by
    # LK convergence, epipolar row consistency, disparity sign, and the
    # stereo SAD threshold.  A detection frame is forced whenever the
    # surviving pair count drops below propagate_min_matches or after a
    # recovery.  1 = detect every frame (the shipped default).  Requires
    # the SAD match/track methods (descriptors are not re-extracted on
    # propagated frames).
    detect_every: int = 1
    propagate_min_matches: int = 48
    # Detector top-K recall target (lax.approx_max_k).  0.95 drops 1.6-2.5%
    # of the 512 winners on blob scenes and none on textured scenes; the
    # e2e ATE effect is within seed noise (docs/MODES.md).  No effect on a
    # GPU or CPU: there approx_max_k lowers to an exact top-k.
    topk_recall: float = 0.95
    fast_arc: int = 12                 # FAST-N contiguous arc (FASTER-12 equivalent)
    # Stage-3/4 SAD with the squared-L2 shortlist (one matmul ranks the
    # candidates, exact SAD re-scores the top 8; rso.kernels.distance
    # .sad_topk_refine) instead of exact all-pairs SAD — same thresholds,
    # near-identical ranking, but candidates ranked below the top 8 are
    # lost.  Off: on the H100 exact SAD is also the faster of the two
    # (PERF.md, PR 1).
    use_mxu_distance: bool = False
    # LK subpixel alignment of tracked observations against the previous
    # frame's stored patches before the pose solve (rso.frontend.refine) —
    # gated on per-feature SSD improvement.  Measured: improves ATE 6-15% in
    # 6/6 seed x speed configs on the textured corridor (real-image
    # statistics; tools/exp_refine_texture.py), accuracy-neutral on blob
    # fields (match-structure-limited there).  Its step cost on the GPU is
    # not measured.
    # Off in the bare default (costs step time for nothing on blob
    # benches); ON in the dataset presets configs/{kitti,euroc,malaga}.ini.
    subpixel_track_refine: bool = False
    # Refine schedule: GN iterations (one window eval each) and the
    # SSD-improvement acceptance gate (two extra evals).  iters=2 without
    # the gate keeps the full ATE win of the original iters=3+gate at 2/5
    # of the evals — measured 3 seeds x 5 variants on the textured corridor
    # (tools/exp_refine_trim.py); the det>1e-6 solvability check already
    # rejects weak-gradient patches.  Gate ON = conservative acceptance.
    refine_iters: int = 2
    refine_ssd_gate: bool = False
    # Run the dense detection passes (FAST segment test + Shi-Tomasi/Harris
    # structure tensor) in bfloat16 to halve their bytes.  Measured trade
    # on a synthetic 40-frame scene: ~2x ATE (0.020 -> 0.045 m) — bf16
    # rounding of img+threshold shifts the effective FAST threshold by +-1
    # for pixels >= 256 and inflates NMS ties, churning ~10% of the
    # keypoint set.  OFF by default; a throughput-over-accuracy escape
    # hatch only.  Its speed on the GPU is not measured.
    detect_bf16: bool = False
    # Run the FAST segment test's 16 neighbor comparisons on an int16 image
    # scaled by 16 — EXACT (unlike detect_bf16): u8 pixels and every 2x2-avg
    # pyramid value are multiples of 1/16, so x16 is integral and the
    # comparisons are bit-identical while the 16 shifted neighbor reads move
    # half the bytes.  (With a bilinear rectification map active the x16
    # values are no longer integral and truncation can shift the effective
    # threshold by <1/16 px-value — gate it off in rectified configs.)
    # OFF; its speed on the GPU is not measured.
    fast_i16: bool = False


@dataclass(frozen=True)
class RSOConfig:
    rectify: RectifyParams = RectifyParams()
    detect: DetectParams = DetectParams()
    lr_match: LeftRightMatchParams = LeftRightMatchParams()
    if_match: InterFrameMatchParams = InterFrameMatchParams()
    least_squares: LeastSquaresParams = LeastSquaresParams()
    gui: GUIParams = GUIParams()
    general: GeneralParams = GeneralParams()
    engine: EngineParams = EngineParams()

    @property
    def n_octaves(self) -> int:
        """ORB detection works on a single octave (its scale space is internal);
        other detectors use the pyramid — reference stage1_rectify.cpp:80."""
        if self.detect.detect_method == DetectMethod.ORB:
            return 1
        return self.rectify.nOctaves

    def replace(self, **kw) -> "RSOConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# INI loader — same section order & key names as the reference loader
# (libstereo-odometry.h:554-663): RECTIFY, DETECT, MATCH, IF-MATCH,
# LEAST_SQUARES, GUI, GENERAL.  Unknown keys are ignored, missing keys keep
# defaults, matching mrpt::CConfigFile semantics.
# --------------------------------------------------------------------------

_SECTION_FIELDS = {
    "RECTIFY": ("rectify", RectifyParams, {"nOctaves": "nOctaves"}),
    "DETECT": (
        "detect",
        DetectParams,
        {
            "detect_method": "detect_method",
            "min_distance": "min_distance",
            "target_feats_per_pixel": "target_feats_per_pixel",
            "initial_FAST_threshold": "initial_FAST_threshold",
            "fast_min_th": "fast_min_th",
            "fast_max_th": "fast_max_th",
            "KLT_win": "KLT_win",
            "minimum_KLT_response": "minimum_KLT_response",
            "orb_nfeats": "orb_nfeats",
            "orb_nlevels": "orb_nlevels",
            "minimum_ORB_response": "minimum_ORB_response",
            "non_maximal_suppression": "non_maximal_suppression",
            "non_max_supp_method": "nmsMethod",
        },
    ),
    "MATCH": (
        "lr_match",
        LeftRightMatchParams,
        {
            "match_method": "match_method",
            "max_y_diff": "max_y_diff",
            "enable_robust_1to1_match": "enable_robust_1to1_match",
            "rectified_images": "rectified_images",
            "min_z": "min_z",
            "max_z": "max_z",
            "sad_max_ratio": "sad_max_ratio",
            "sad_max_distance": "sad_max_distance",
            "orb_min_th": "orb_min_th",
            "orb_max_th": "orb_max_th",
            "orb_max_distance": "orb_max_distance",
            # rso-extension key (no reference equivalent): see
            # LeftRightMatchParams.use_z_gate
            "use_z_gate": "use_z_gate",
        },
    ),
    "IF-MATCH": (
        "if_match",
        InterFrameMatchParams,
        {
            "if_match_method": "ifm_method",
            "filter_fund_matrix": "filter_fund_matrix",
            "window_height": "ifm_win_h",
            "window_width": "ifm_win_w",
            "sad_max_ratio": "sad_max_ratio",
            "sad_max_distance": "sad_max_distance",
            "orb_max_distance": "orb_max_distance",
        },
    ),
    "LEAST_SQUARES": (
        "least_squares",
        LeastSquaresParams,
        {
            "std_noise_pixels": "std_noise_pixels",
            "use_previous_pose_as_initial": "use_previous_pose_as_initial",
            "initial_max_iters": "initial_max_iters",
            "max_iters": "max_iters",
            "min_mod_out_vector": "min_mod_out_vector",
            "max_incr_cost": "max_incr_cost",
            "residual_threshold": "residual_threshold",
            "bad_tracking_th": "bad_tracking_th",
            "use_robust_kernel": "use_robust_kernel",
            "kernel_param": "kernel_param",
        },
    ),
    "GUI": (
        "gui",
        GUIParams,
        {
            "show_gui": "show_gui",
            "draw_all_raw_feats": "draw_all_raw_feats",
            "draw_lr_pairings": "draw_lr_pairings",
            "draw_tracking": "draw_tracking",
        },
    ),
    "GENERAL": (
        "general",
        GeneralParams,
        {
            "vo_use_matches_ids": "vo_use_matches_ids",
            "vo_save_files": "vo_save_files",
            "vo_debug": "vo_debug",
            "vo_pause_it": "vo_pause_it",
            "vo_out_dir": "vo_out_dir",
        },
    ),
    "ENGINE": (
        "engine",
        EngineParams,
        {f.name: f.name for f in dataclasses.fields(EngineParams)},
    ),
}

_ENUM_FIELDS = {
    "detect_method": DetectMethod,
    "nmsMethod": NMSMethod,
    "match_method": StereoMatchMethod,
    "ifm_method": IFMatchMethod,
}


def _parse_value(field_type, raw: str):
    raw = raw.strip()
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if field_type is int:
        return int(float(raw))
    if field_type is float:
        return float(raw)
    if isinstance(field_type, type) and issubclass(field_type, enum.IntEnum):
        return field_type(int(raw))
    return raw


def load_config(path: str, base: RSOConfig | None = None) -> RSOConfig:
    """Load an INI config with the reference's sections/keys into an RSOConfig."""
    cfg = base or RSOConfig()
    parser = configparser.ConfigParser(inline_comment_prefixes=("//", ";", "#"))
    parser.optionxform = str  # preserve case of keys
    with open(path) as f:
        parser.read_string(f.read())

    updates = {}
    for section, (attr, cls, keymap) in _SECTION_FIELDS.items():
        if not parser.has_section(section):
            continue
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for ini_key, field_name in keymap.items():
            if parser.has_option(section, ini_key):
                ftype = _ENUM_FIELDS.get(field_name, fields[field_name].type)
                if isinstance(ftype, str):  # from __future__ annotations
                    ftype = {"int": int, "float": float, "bool": bool, "str": str}.get(
                        ftype, _ENUM_FIELDS.get(field_name, str)
                    )
                kw[field_name] = _parse_value(ftype, parser.get(section, ini_key))
        if kw:
            updates[attr] = dataclasses.replace(getattr(cfg, attr), **kw)
    return cfg.replace(**updates) if updates else cfg


def dump_to_console(cfg: RSOConfig) -> str:
    """Pretty-print the config (reference: dumpToConsole(), libstereo-odometry.h:187)."""
    lines = []
    for attr in ("rectify", "detect", "lr_match", "if_match", "least_squares",
                 "gui", "general", "engine"):
        sub = getattr(cfg, attr)
        name = type(sub).__name__
        for f in dataclasses.fields(sub):
            lines.append(f"\t[{name}]\t{f.name} = {getattr(sub, f.name)}")
    text = "\n".join(lines)
    print(text)
    return text
