"""Learn the 256-pair rBRIEF test pattern (ORB-paper greedy decorrelation).

The round-1 descriptor used a seeded random-Gaussian BRIEF pattern; the
reference uses cv::ORB's LEARNED pattern (stage2_detect.cpp:458-497), trained
to maximize per-test variance and minimize inter-test correlation over
steered keypoint patches (Rublee et al., ICCV 2011, sec. 4.3).  This tool
re-runs that training procedure on real texture (the reference's own test
images plus textured-corridor renders) and emits rso/frontend/orb_pattern.py.

Procedure (as in the paper):
  1. collect oriented 31x31 keypoint patches (5x5 box-smoothed),
  2. enumerate candidate tests = point pairs from a grid inside the r<=12
     disc (rotation keeps samples inside the 37x37 descriptor patch),
  3. evaluate every candidate on every steered patch,
  4. greedily keep tests with mean nearest 0.5 and |correlation| below a
     threshold against all kept tests, relaxing the threshold until 256 fill.

Usage: JAX_PLATFORMS=cpu python tools/learn_orb_pattern.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATCH = 37
C = PATCH // 2          # 18
ORIENT_R = 15
MAX_R = 12.0
MIN_PAIR_DIST = 2.5


def _smooth5(p):
    """5x5 box filter, same edge handling as orb_descriptors (zero pad)."""
    pp = np.pad(p, ((2, 2), (0, 0)))
    rows = sum(pp[dy:dy + PATCH, :] for dy in range(5))
    pp = np.pad(rows, ((0, 0), (2, 2)))
    return sum(pp[:, dx:dx + PATCH] for dx in range(5))


_yx = np.mgrid[-ORIENT_R:ORIENT_R + 1, -ORIENT_R:ORIENT_R + 1]
_CIRC = (_yx[0] ** 2 + _yx[1] ** 2) <= ORIENT_R ** 2


def _orientation(p31):
    m10 = float((_yx[1] * p31 * _CIRC).sum())
    m01 = float((_yx[0] * p31 * _CIRC).sum())
    return np.arctan2(m01, m10)


def _bilinear(img, x, y):
    x0 = np.floor(x).astype(int); y0 = np.floor(y).astype(int)
    fx = x - x0; fy = y - y0
    x1 = np.clip(x0 + 1, 0, img.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, img.shape[0] - 1)
    x0 = np.clip(x0, 0, img.shape[1] - 1)
    y0 = np.clip(y0, 0, img.shape[0] - 1)
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x1] * (1 - fy) * fx
            + img[y1, x0] * fy * (1 - fx) + img[y1, x1] * fy * fx)


def collect_patches():
    """Oriented, smoothed 37x37 patches at FAST corners of real texture."""
    import cv2

    from rso.synthetic import default_texture, make_textured_sequence

    images = []
    ref = "/root/reference/libstereo-odometry/tests"
    for name in ("0L.png", "0R.png"):
        p = os.path.join(ref, name)
        if os.path.exists(p):
            img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            images.append(img)
            images.append(cv2.resize(img, (img.shape[1] * 2 // 3,
                                           img.shape[0] * 2 // 3)))
            images.append(cv2.resize(img, (img.shape[1] // 2,
                                           img.shape[0] // 2)))
    # corridor renders add perspective-warped views of the texture
    seq = make_textured_sequence(n_frames=3, H=376, W=1000, px_per_m=32.0)
    for l, r in seq.frames:
        images.append(l)
        images.append(r)
    images.append(default_texture())

    patches = []
    for img in images:
        kps = cv2.FastFeatureDetector_create(threshold=15).detect(img)
        kps = sorted(kps, key=lambda k: -k.response)[:600]
        imf = img.astype(np.float32)
        for k in kps:
            x, y = int(round(k.pt[0])), int(round(k.pt[1]))
            if (x < C + 1 or y < C + 1 or x + C + 1 >= img.shape[1]
                    or y + C + 1 >= img.shape[0]):
                continue
            patch = imf[y - C:y + C + 1, x - C:x + C + 1]
            sm = _smooth5(patch)
            theta = _orientation(patch[3:34, 3:34])
            patches.append((sm, theta))
    print(f"collected {len(patches)} training patches")
    return patches


def candidate_points():
    pts = []
    for yy in range(-12, 13, 2):
        for xx in range(-12, 13, 2):
            if xx * xx + yy * yy <= MAX_R * MAX_R:
                pts.append((float(xx), float(yy)))
    return np.asarray(pts, np.float32)


def main():
    rng = np.random.default_rng(0)
    patches = collect_patches()
    pts = candidate_points()
    P = len(pts)
    print(f"{P} grid points")

    # sample every grid point on every steered patch
    vals = np.empty((len(patches), P), np.float32)
    for i, (sm, theta) in enumerate(patches):
        c, s = np.cos(theta), np.sin(theta)
        rx = pts[:, 0] * c - pts[:, 1] * s + C
        ry = pts[:, 0] * s + pts[:, 1] * c + C
        vals[i] = _bilinear(sm, rx, ry)

    # candidate tests: all point pairs far enough apart
    ii, jj = np.triu_indices(P, k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    okd = d >= MIN_PAIR_DIST
    ii, jj = ii[okd], jj[okd]
    bits = (vals[:, ii] < vals[:, jj])          # [N, n_cand]
    n_cand = bits.shape[1]
    print(f"{n_cand} candidate tests on {bits.shape[0]} patches")

    mean = bits.mean(0)
    order = np.argsort(np.abs(mean - 0.5))
    bf = bits.astype(np.float32)
    std = bf.std(0) + 1e-9

    chosen = []
    thresh = 0.2
    while len(chosen) < 256 and thresh <= 0.9:
        for c in order:
            if len(chosen) >= 256:
                break
            if any(c == k for k in chosen):
                continue
            if chosen:
                M = bf[:, chosen]                       # [N, k]
                cov = (bf[:, c][:, None] * M).mean(0) - mean[c] * mean[chosen]
                corr = cov / (std[c] * std[chosen])
                if np.abs(corr).max() > thresh:
                    continue
            chosen.append(int(c))
        if len(chosen) < 256:
            thresh += 0.05
            print(f"relaxing correlation threshold to {thresh:.2f} "
                  f"({len(chosen)} chosen)")
    assert len(chosen) == 256, len(chosen)
    chosen = np.asarray(chosen)
    print(f"final: mean|mean-0.5| = {np.abs(mean[chosen]-0.5).mean():.4f}")

    pat = np.stack([np.stack([pts[ii[c]], pts[jj[c]]]) for c in chosen])
    # [256, 2, 2] float32 (pair, xy)

    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "rso", "frontend", "orb_pattern.py")
    with open(out_path, "w") as f:
        f.write('"""Learned rBRIEF test pattern (generated by '
                'tools/learn_orb_pattern.py).\n\n'
                'Greedy variance/decorrelation selection (ORB paper sec 4.3) '
                'over steered\nkeypoint patches from real texture — the '
                'learned-pattern equivalent of\ncv::ORB\'s bit_pattern_31_ '
                'used by the reference (stage2_detect.cpp:480-493).\n'
                f'Trained on {bits.shape[0]} patches, {n_cand} candidate '
                'tests, final corr\nthreshold '
                f'{thresh:.2f}.\n"""\n'
                'import numpy as np\n\n'
                '# [256, 2 (pair), 2 (x,y)] offsets within the r<=12 disc\n'
                'LEARNED_PATTERN = np.array([\n')
        for row in pat:
            f.write(f"    [[{row[0,0]:.0f}, {row[0,1]:.0f}], "
                    f"[{row[1,0]:.0f}, {row[1,1]:.0f}]],\n")
        f.write("], dtype=np.float32)\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
