"""NumPy oracle for the NN detector post-processing
(nn_feature_point_detector.cpp:59-230); the port's copy of
``feature_detector_tpu/oracle/nn_postproc.py`` (plain numpy): mask creation, heatmap candidate
selection with greedy mask-NMS, and stride-8 bilinear descriptor sampling.

Tie-break note (Q10): the reference iterates a multimap in reverse (equal
scores: reverse insertion order); this oracle uses (score desc, row-major)
like the rest of the framework.
"""

from __future__ import annotations

import numpy as np

from ..core.config import NNDetectorOptions


def create_mask(shape, existing, opts: NNDetectorOptions) -> np.ndarray:
    rows, cols = shape
    mask = np.ones(shape, np.int32)
    b = opts.invalid_boundary
    if b:
        mask[:b] = 0
        mask[-b:] = 0
        mask[:, :b] = 0
        mask[:, -b:] = 0
    for x, y in existing:
        r, c = int(y), int(x)
        r0, r1 = max(0, r - opts.min_feature_distance), min(rows - 1, r + opts.min_feature_distance)
        c0, c1 = max(0, c - opts.min_feature_distance), min(cols - 1, c + opts.min_feature_distance)
        mask[r0 : r1 + 1, c0 : c1 + 1] = 0
    return mask


def select_features(heatmap: np.ndarray, existing, opts: NNDetectorOptions):
    """Returns existing + new [(x, y)] capped at kMaxNumberOfDetectedFeatures."""
    rows, cols = heatmap.shape
    mask = create_mask(heatmap.shape, existing, opts)
    ys, xs = np.nonzero(heatmap > opts.min_response)
    scores = heatmap[ys, xs]
    order = np.argsort(-scores, kind="stable")
    feats = list(existing)
    for i in order:
        y, x = int(ys[i]), int(xs[i])
        if not mask[y, x]:
            continue
        feats.append((float(x), float(y)))
        if len(feats) >= opts.max_number_of_detected_features:
            break
        r0, r1 = max(0, y - opts.min_feature_distance), min(rows - 1, y + opts.min_feature_distance)
        c0, c1 = max(0, x - opts.min_feature_distance), min(cols - 1, x + opts.min_feature_distance)
        mask[r0 : r1 + 1, c0 : c1 + 1] = 0
    return feats


def sample_descriptors(desc_map: np.ndarray, feats, stride: int = 8) -> np.ndarray:
    """[Hc, Wc, D] map, [(x, y)] -> [N, D]; zero outside [0, dim-2]
    (nn_feature_point_detector.cpp:162-193)."""
    hc, wc, ddim = desc_map.shape
    out = np.zeros((len(feats), ddim), np.float32)
    for i, (x, y) in enumerate(feats):
        row = y / stride
        col = x / stride
        ir, ic = int(row), int(col)
        if ir < 0 or ir >= hc - 1 or ic < 0 or ic >= wc - 1:
            continue
        sr = row - np.floor(row)
        sc = col - np.floor(col)
        w = [(1 - sc) * (1 - sr), sc * (1 - sr), (1 - sc) * sr, sc * sr]
        out[i] = (
            w[0] * desc_map[ir, ic]
            + w[1] * desc_map[ir, ic + 1]
            + w[2] * desc_map[ir + 1, ic]
            + w[3] * desc_map[ir + 1, ic + 1]
        )
    return out


def direct_select(kpts, scores, existing, opts: NNDetectorOptions, rows, cols):
    """Oracle for the NMS-model path
    (DirectlySelectGoodFeaturesWithDescriptors,
    nn_feature_point_detector.cpp:203-230 + ArgSort superpoint.cpp:106-112):
    iterate candidates by descending score (row-major tie-break), accept if
    inside the boundary band, outside every accepted feature's suppression
    square, and under the capacity cap.  Returns the list of selected
    candidate INDICES (into kpts) appended after ``existing``.
    """
    b = opts.invalid_boundary
    r = opts.min_feature_distance
    accepted = list(existing)  # [(x, y)]
    picked = []
    order = np.argsort(-np.asarray(scores), kind="stable")
    for i in order:
        if scores[i] <= 0:
            continue
        x, y = float(kpts[i][0]), float(kpts[i][1])
        if not (b <= x < cols - b and b <= y < rows - b):
            continue
        if any(abs(ax - x) <= r and abs(ay - y) <= r for ax, ay in accepted):
            continue
        if len(accepted) >= opts.max_number_of_detected_features:
            break
        accepted.append((x, y))
        picked.append(int(i))
    return picked
