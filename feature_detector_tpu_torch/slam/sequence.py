"""Sequences and the visual-odometry entries: trajectory IO, synthetic
sequences, track building, the incremental and batch front-ends, and the
legacy short-window VO.

Counterpart of ``feature_detector_tpu/slam/sequence.py``.  The numpy host
code (quaternions, TUM/EuRoC files, the renderer, both track graphs, the
init-pair choice, chunk-pose sanitising, the legacy VO's host loop) is a
copy of the JAX package's, so the same seed renders the same images and the
same matches give the same tracks in the same order.

Front-ends: ``scan_frontend`` is the JAX package's ``scan_frontend_jit`` and
``run_incremental_frontend`` its host-sequential form; both run one
per-frame body (``_incremental_step``: the carry step's top 4 response
peaks in a window around every feature of the previous frame with BRIEF at
each, compaction of the carried features into a prefix, and the top-up
detection after them, whose greedy selection is the CUDA kernel K2 on the
card).  ``batch_frontend`` detects every frame afresh with one greedy
selection over the whole stack (K1 on the card).

VO entries: ``run_visual_odometry_chunked`` runs the fused pipeline
(``vo_fused``) by default, and with ``legacy=True`` the short-window
sequential VO (``run_visual_odometry``) on overlapping chunks composed by
Sim(3) fits.  ``run_visual_odometry`` matches frame pairs at offsets 1-4,
gates each pair by the inlier mask of a batched two-view init, registers
frame by frame with PnP, re-triangulates and runs a windowed BA after every
frame, then a global BA, guided re-association and a second BA.  Its BA
solves in float64 (``ba.ba_solve``) where the JAX package keeps float32
state, so its trajectory parts from the JAX package's within a few frames
even from equal inputs; the stages before the first BA agree.  ``mesh``
runs the global BA over the mesh's ranks (both VOs).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import BAOptions, BriefOptions, DetectorOptions, FastOptions, MatcherOptions
from ..core.device import DeviceLike, as_tensor
from ..core.types import Features
from ..frontend.detector import detect_good_features, detect_good_features_batch
from ..kernels import detect as KD
from ..kernels.brief import brief_compute
from ..kernels.fast import fast_maps
from ..match.hamming import _popcount32, match_hamming
from ..parallel.mesh import mesh_device
from ..utils.log import report_warn
from . import geometry
from .ba import BAProblem, ba_solve, check_no_tf32, make_distributed_ba
from .camera import Pinhole
from .lie import se3_compose, se3_inverse, so3_exp, so3_log


# --------------------------------------------------------------------------
# Trajectory file formats
# --------------------------------------------------------------------------


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[..., 4] quaternion (x, y, z, w) → [..., 3, 3] rotation matrix."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = np.empty(q.shape[:-1] + (3, 3))
    r[..., 0, 0] = 1 - 2 * (y * y + z * z)
    r[..., 0, 1] = 2 * (x * y - z * w)
    r[..., 0, 2] = 2 * (x * z + y * w)
    r[..., 1, 0] = 2 * (x * y + z * w)
    r[..., 1, 1] = 1 - 2 * (x * x + z * z)
    r[..., 1, 2] = 2 * (y * z - x * w)
    r[..., 2, 0] = 2 * (x * z - y * w)
    r[..., 2, 1] = 2 * (y * z + x * w)
    r[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return r.astype(np.float32)


def rot_to_quat(r: np.ndarray) -> np.ndarray:
    """[..., 3, 3] rotation → [..., 4] quaternion (x, y, z, w).

    Branches on the largest of (trace, R00, R11, R22) per matrix — the
    w-trace-only formula degenerates (divides by w → 0) for rotations at or
    near 180°, which are routine camera attitudes in real EuRoC/TUM
    trajectories."""
    r = np.asarray(r, np.float64)
    shape = r.shape[:-2]
    rf = r.reshape(-1, 3, 3)
    q = np.empty((len(rf), 4))
    t = np.trace(rf, axis1=-2, axis2=-1)
    cands = np.stack([t, rf[:, 0, 0], rf[:, 1, 1], rf[:, 2, 2]], axis=1)
    case = np.argmax(cands, axis=1)
    for i, m in enumerate(rf):
        if case[i] == 0:
            s = 2.0 * np.sqrt(max(1.0 + t[i], 1e-12))
            q[i] = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                    (m[1, 0] - m[0, 1]) / s, 0.25 * s]
        elif case[i] == 1:
            s = 2.0 * np.sqrt(max(1.0 + m[0, 0] - m[1, 1] - m[2, 2], 1e-12))
            q[i] = [0.25 * s, (m[0, 1] + m[1, 0]) / s,
                    (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s]
        elif case[i] == 2:
            s = 2.0 * np.sqrt(max(1.0 + m[1, 1] - m[0, 0] - m[2, 2], 1e-12))
            q[i] = [(m[0, 1] + m[1, 0]) / s, 0.25 * s,
                    (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s]
        else:
            s = 2.0 * np.sqrt(max(1.0 + m[2, 2] - m[0, 0] - m[1, 1], 1e-12))
            q[i] = [(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s,
                    0.25 * s, (m[1, 0] - m[0, 1]) / s]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.reshape(*shape, 4).astype(np.float32)


@dataclasses.dataclass
class Trajectory:
    """World-from-body poses sampled at timestamps."""

    timestamps: np.ndarray  # [N] float64 seconds
    rotations: np.ndarray  # [N, 3, 3] world-from-body
    positions: np.ndarray  # [N, 3]

    def __len__(self) -> int:
        return len(self.timestamps)


def load_tum_trajectory(path: str) -> Trajectory:
    """TUM-RGBD format: `timestamp tx ty tz qx qy qz qw` per line, '#' comments."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.replace(",", " ").split()])
    data = np.asarray(rows, np.float64)
    return Trajectory(
        timestamps=data[:, 0],
        rotations=quat_to_rot(data[:, 4:8]),
        positions=data[:, 1:4].astype(np.float32),
    )


def save_tum_trajectory(path: str, traj: Trajectory) -> None:
    q = rot_to_quat(traj.rotations)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(len(traj)):
            p = traj.positions[i]
            f.write(
                f"{traj.timestamps[i]:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[i, 0]:.6f} {q[i, 1]:.6f} {q[i, 2]:.6f} {q[i, 3]:.6f}\n"
            )


def load_euroc_groundtruth(path: str) -> Trajectory:
    """EuRoC ASL `state_groundtruth_estimate0/data.csv`:
    `#timestamp[ns], p_x, p_y, p_z, q_w, q_x, q_y, q_z, ...`."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split(",")])
    data = np.asarray(rows, np.float64)
    q_wxyz = data[:, 4:8]
    q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
    return Trajectory(
        timestamps=data[:, 0] * 1e-9,
        rotations=quat_to_rot(q_xyzw),
        positions=data[:, 1:4].astype(np.float32),
    )


def save_euroc_groundtruth(path: str, traj: Trajectory) -> None:
    """Write the EuRoC ASL state-groundtruth csv header + rows (the format
    `load_euroc_groundtruth` parses): nanosecond timestamps, position,
    w-first quaternion."""
    q_xyzw = rot_to_quat(traj.rotations)
    with open(path, "w") as f:
        f.write(
            "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
            "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n"
        )
        for i in range(len(traj)):
            p = traj.positions[i]
            q = q_xyzw[i]
            f.write(
                f"{int(round(traj.timestamps[i] * 1e9))},"
                f"{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                f"{q[3]:.6f},{q[0]:.6f},{q[1]:.6f},{q[2]:.6f}\n"
            )


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association (TUM protocol); returns index pairs."""
    j = np.searchsorted(ts_b, ts_a)
    j = np.clip(j, 1, len(ts_b) - 1)
    left = np.abs(ts_b[j - 1] - ts_a) < np.abs(ts_b[j] - ts_a)
    j = np.where(left, j - 1, j)
    ok = np.abs(ts_b[j] - ts_a) <= max_dt
    return np.nonzero(ok)[0], j[ok]


# --------------------------------------------------------------------------
# Synthetic sequence (a seeded stand-in for EuRoC/TUM)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SyntheticSequence:
    images: np.ndarray  # [F, H, W] uint8
    trajectory: Trajectory  # ground truth, world-from-camera inverse poses
    rotations_wc: np.ndarray  # [F, 3, 3] world→camera (p_cam = R p + t)
    translations_wc: np.ndarray  # [F, 3]
    landmarks: np.ndarray  # [L, 3]
    cam: Pinhole


def make_synthetic_sequence(
    n_frames: int = 6,
    n_landmarks: int = 160,
    rows: int = 240,
    cols: int = 320,
    seed: int = 0,
    blob_radius: int = 2,
    angle_step: float = 0.05,
    motion: str = "arc",
) -> SyntheticSequence:
    """Render a camera arc over a random landmark field as real uint8 images.

    Each landmark is a textured 3D planar patch of FIXED WORLD SIZE (normal
    +z), rendered per frame through a local affine approximation of the
    projection — so the patch's corners are geometrically consistent 3D
    points across views.  (A first version stamped fixed-PIXEL-size patterns,
    which put every detected corner ~3 px off any consistent 3D point and
    capped BA at ~2.6 px² mean residual; perspective-correct patches let BA
    converge to sub-pixel.)  FAST fires on the pattern corners and BRIEF
    descriptors are distinctive enough for reliable cross-frame matching.
    The arc baseline is a few tenths of the scene depth so the two-view
    geometry is well conditioned.
    """
    rng = np.random.default_rng(seed)
    cam = Pinhole(
        fx=0.9 * cols, fy=0.9 * cols, cx=cols / 2.0, cy=rows / 2.0
    )
    # "lateral": a sideways tracking shot along a long landmark corridor —
    # constant healthy per-frame baseline, continuous landmark handover, no
    # FOV starvation; the geometry that makes 30+-frame monocular sequences
    # well-posed (the "arc" couples yaw to translation and starves parallax /
    # visibility as it lengthens).
    lateral_step = 6.0 * np.sin(angle_step)
    span = lateral_step * n_frames
    pts = np.empty((n_landmarks, 3), np.float32)
    if motion == "lateral":
        x_lo, x_hi = -2.6, 2.6 + span
    else:
        # Long arcs yaw the camera off the original field: extend the
        # landmark slab to cover the full gaze sweep (camera center swing
        # plus the look-at offset at the far depth) so every frame still
        # sees a dense field.
        max_angle = angle_step * n_frames / 2.0
        reach = 6.0 * np.sin(max_angle) + 9.0 * np.tan(min(max_angle, 1.2))
        x_hi = 2.6 + max(0.0, reach - 2.6)
        x_lo = -x_hi
    pts[:, 0] = rng.uniform(x_lo, x_hi, n_landmarks)
    pts[:, 1] = rng.uniform(-1.8, 1.8, n_landmarks)
    pts[:, 2] = rng.uniform(5.0, 9.0, n_landmarks)

    rots, trans = [], []
    for i in range(n_frames):
        if motion == "lateral":
            r = np.eye(3, dtype=np.float32)
            center = np.array(
                [lateral_step * i, 0.03 * np.sin(0.7 * i), 0.15 * np.sin(0.4 * i)],
                np.float32,
            )
        else:
            angle = angle_step * (i - n_frames / 2)
            r = so3_exp(torch.tensor([0.0, angle, 0.0], dtype=torch.float32)).numpy()
            center = np.array(
                [6.0 * np.sin(angle), 0.05 * i, 1.2 - 1.2 * np.cos(angle)], np.float32
            )
        rots.append(r)
        trans.append(-r @ center)
    rots = np.stack(rots)
    trans = np.stack(trans)

    # Low-frequency background texture (shared across frames; keeps BRIEF
    # patches distinctive without creating spurious FAST corners).  NOTE: a
    # screen-fixed background is physically inconsistent (it does not move
    # with the camera) and costs some BRIEF stability on patch borders, but a
    # world-fixed-plane variant measurably shifted the per-seed difficulty of
    # the flagship ATE tests without improving descriptor repeatability, so
    # the simple deterministic version stays.
    yy, xx = np.mgrid[0:rows, 0:cols]
    background = (
        28.0
        + 10.0 * np.sin(xx / 23.0)
        + 10.0 * np.cos(yy / 31.0)
    )

    # Per-landmark texture: a unique binary pattern on a 3D planar patch of
    # fixed world size (a texture cell subtends ~2.5 px at the mean scene
    # depth — sub-2px cells alias badly and destroy FAST repeatability;
    # larger 4px cells were tried and made patches overlap-corrupt at the
    # test densities without improving BRIEF stability).
    stamp_cells = 2 * blob_radius + 3
    stamps = rng.uniform(0, 1, (n_landmarks, stamp_cells, stamp_cells))
    stamps = np.where(
        stamps > 0.45, rng.uniform(150, 255, stamps.shape), 40.0
    ).astype(np.float32)
    mid_depth = 7.0
    patch_world = stamp_cells * 2.5 * mid_depth / cam.fx

    images = np.empty((n_frames, rows, cols), np.uint8)
    for f in range(n_frames):
        r_wc, t_wc = rots[f], trans[f]
        img = background.copy()

        def proj(p3):
            pc = p3 @ r_wc.T + t_wc
            return (
                np.stack(
                    [cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                     cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], axis=-1
                ),
                pc[..., 2],
            )

        centers_uv, z = proj(pts)
        # Local affine frame of each patch: columns are the image-space
        # derivatives along the patch's world x/y axes.
        eps = 1e-3
        du, _ = proj(pts + np.array([eps, 0.0, 0.0], np.float32))
        dv, _ = proj(pts + np.array([0.0, eps, 0.0], np.float32))
        ja = np.stack([(du - centers_uv) / eps, (dv - centers_uv) / eps], axis=-1)
        # [L, 2, 2]; patch-local (a, b) in world units -> pixel offset.
        half_px = np.abs(ja).sum(axis=2).max(axis=1) * patch_world / 2.0 + 1.0
        vis = (
            (z > 0.1)
            & (centers_uv[:, 0] >= half_px + 1)
            & (centers_uv[:, 0] < cols - half_px - 1)
            & (centers_uv[:, 1] >= half_px + 1)
            & (centers_uv[:, 1] < rows - half_px - 1)
        )
        for l in np.nonzero(vis)[0]:
            cu, cv = centers_uv[l]
            r = int(np.ceil(half_px[l]))
            u0, u1 = int(np.floor(cu)) - r, int(np.floor(cu)) + r + 1
            v0, v1 = int(np.floor(cv)) - r, int(np.floor(cv)) + r + 1
            uu, vv_ = np.meshgrid(np.arange(u0, u1), np.arange(v0, v1), indexing="xy")
            d_uv = np.stack([uu - cu, vv_ - cv], axis=-1).astype(np.float32)
            ab = d_uv @ np.linalg.inv(ja[l]).T.astype(np.float32)  # world units
            # Bilinear texture interpolation: nearest sampling makes rendered
            # edges jump a whole pixel as the subpixel projection phase
            # shifts, injecting ~1.5 px of view-dependent corner error that no
            # solver can explain; bilinear keeps corners on their true rays.
            tex = (ab / patch_world + 0.5) * stamp_cells - 0.5  # texel coords
            inside = (
                (tex[..., 0] >= 0) & (tex[..., 0] < stamp_cells - 1)
                & (tex[..., 1] >= 0) & (tex[..., 1] < stamp_cells - 1)
            )
            t0_ = np.clip(np.floor(tex).astype(np.int32), 0, stamp_cells - 2)
            w_ = tex - t0_
            st = stamps[l]
            v00 = st[t0_[..., 1], t0_[..., 0]]
            v01 = st[t0_[..., 1], t0_[..., 0] + 1]
            v10 = st[t0_[..., 1] + 1, t0_[..., 0]]
            v11 = st[t0_[..., 1] + 1, t0_[..., 0] + 1]
            vals = (
                v00 * (1 - w_[..., 1]) * (1 - w_[..., 0])
                + v01 * (1 - w_[..., 1]) * w_[..., 0]
                + v10 * w_[..., 1] * (1 - w_[..., 0])
                + v11 * w_[..., 1] * w_[..., 0]
            )
            region = img[v0:v1, u0:u1]
            region[inside] = vals[inside]
        images[f] = np.clip(img, 0, 255).astype(np.uint8)

    # Ground-truth trajectory = camera centers in world frame.
    centers = -np.einsum("fji,fj->fi", rots, trans)
    traj = Trajectory(
        timestamps=np.arange(n_frames, dtype=np.float64) * 0.1,
        rotations=np.transpose(rots, (0, 2, 1)),
        positions=centers.astype(np.float32),
    )
    return SyntheticSequence(
        images=images,
        trajectory=traj,
        rotations_wc=rots,
        translations_wc=trans,
        landmarks=pts,
        cam=cam,
    )


# --------------------------------------------------------------------------
# Visual-odometry results and tracks
# --------------------------------------------------------------------------


@dataclasses.dataclass
class VOResult:
    trajectory: Trajectory  # estimated (world-from-camera)
    rotations_wc: np.ndarray  # [F, 3, 3] world->camera
    translations_wc: np.ndarray  # [F, 3]
    points: np.ndarray  # [L, 3] triangulated landmarks (world)
    num_tracks: int
    mean_track_length: float = 0.0  # mean observations per mapped track
    problem: Optional[BAProblem] = None  # pre-BA problem (diagnostics)
    solved: Optional[BAProblem] = None  # post-BA problem (diagnostics)


def _build_tracks(
    pair_matches: List[Tuple[int, int, np.ndarray]],
    n_frames: int,
    n_feats: int,
    min_length: int = 2,
) -> List[List[Tuple[int, int]]]:
    """Union-find over (frame, feature) nodes across all matched pairs.

    pair_matches is a list of (fa, fb, idx) with idx[i] = feature index in
    frame fb matched to feature i of frame fa (or -1).  Skip-frame pairs
    bridge single-frame detection dropouts.  A component holding two
    different features of the same frame is contradictory and dropped.
    Tracks come out in the iteration order of the touched-node set and the
    component dict, as in the JAX package: the init-pair choice, PnP's
    point order and the BA problem's track order all follow it.
    """
    parent = np.arange(n_frames * n_feats, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for fa, fb, idx in pair_matches:
        for i, j in enumerate(idx):
            if j >= 0:
                ra, rb = find(fa * n_feats + i), find(fb * n_feats + int(j))
                if ra != rb:
                    parent[rb] = ra

    groups: dict = {}
    touched = set()
    for fa, fb, idx in pair_matches:
        for i, j in enumerate(idx):
            if j >= 0:
                touched.add(fa * n_feats + i)
                touched.add(fb * n_feats + int(j))
    for node in touched:
        groups.setdefault(find(node), []).append(node)

    tracks: List[List[Tuple[int, int]]] = []
    for nodes in groups.values():
        obs = sorted((n // n_feats, n % n_feats) for n in nodes)
        frames = [f for f, _ in obs]
        if len(set(frames)) != len(frames):
            continue  # same-frame conflict: contradictory merge, drop
        if len(obs) >= min_length:
            tracks.append(obs)
    return tracks


def build_tracks_conflict_free(
    pair_matches: List[Tuple[int, int, np.ndarray]],
    n_frames: int,
    n_feats: int,
    min_length: int = 2,
) -> List[List[Tuple[int, int]]]:
    """Conflict-REJECTING union-find over (frame, feature) nodes.

    `_build_tracks` drops any component that ends up holding two features of
    the same frame — but with edges from 4 match offsets plus carry links,
    ONE wrong match merges two real tracks and destroys both, and the longest
    tracks (most edges) are the most exposed: on a 30-frame sequence the
    track-length p50 collapsed to 2 and no track spanned a 10-frame chunk,
    starving both the init-pair choice and the cross-chunk constraints the
    global BA needs.

    Here each root carries a frame-occupancy BITMASK (arbitrary-precision
    int); a union that would put two observations in the same frame is
    REJECTED — the (likely wrong) edge is dropped and both tracks survive.
    Callers order ``pair_matches`` most-trustworthy-first (carry links, then
    ascending match offset): earlier edges claim the merge, later
    contradicting edges bounce off.
    """
    parent = np.arange(n_frames * n_feats, dtype=np.int64)
    fmask: dict = {}

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    touched = set()
    for fa, fb, idx in pair_matches:
        base_a = fa * n_feats
        base_b = fb * n_feats
        for i, j in enumerate(idx):
            if j < 0:
                continue
            na = base_a + i
            nb = base_b + int(j)
            touched.add(na)
            touched.add(nb)
            ra, rb = find(na), find(nb)
            if ra == rb:
                continue
            ma = fmask.get(ra, 1 << fa)
            mb = fmask.get(rb, 1 << fb)
            if ma & mb:
                continue  # would place two features in one frame: reject edge
            parent[rb] = ra
            fmask[ra] = ma | mb
            fmask.pop(rb, None)

    groups: dict = {}
    for node in touched:
        groups.setdefault(find(node), []).append(node)
    tracks: List[List[Tuple[int, int]]] = []
    for nodes in groups.values():
        if len(nodes) >= min_length:
            tracks.append(sorted((n // n_feats, n % n_feats) for n in nodes))
    return tracks


def _pick_init_pair(tracks, uv_np, cam: Pinhole, n_frames: int, max_features: int, min_inliers: int = 15,
                    device: DeviceLike = None):
    """The two-view initialisation pair (0, j): the widest j, from the last
    frame down, whose correspondences (tracks spanning frames 0 and j) give
    ``two_view_init`` at least ``min_inliers`` RANSAC inliers.  The
    correspondences pad to ``max_features`` slots (the first
    ``max_features`` tracks in track order), as in the JAX package.

    Returns (j, rot_j, trans_j, seed_pairs [(track id, uv0, uvj)] of the
    inliers); raises ``ValueError`` when no pair has enough inliers.
    """
    track_frames = [dict(tr) for tr in tracks]
    for j in range(n_frames - 1, 0, -1):
        corr = [
            (t_id, uv_np[0, fr[0]], uv_np[j, fr[j]])
            for t_id, fr in enumerate(track_frames)
            if 0 in fr and j in fr
        ]
        if len(corr) < min_inliers:
            continue
        n = min(len(corr), max_features)
        uv0 = np.zeros((max_features, 2), np.float32)
        uvj = np.zeros((max_features, 2), np.float32)
        pv = np.zeros(max_features, bool)
        uv0[:n] = np.stack([c[1] for c in corr[:n]])
        uvj[:n] = np.stack([c[2] for c in corr[:n]])
        pv[:n] = True
        r, t, _, inl = geometry.two_view_init(as_tensor(uv0, device), as_tensor(uvj, device), as_tensor(pv, device), cam)
        inl = inl.cpu().numpy()
        if inl.sum() >= min_inliers:
            seed_pairs = [corr[i] for i in np.nonzero(inl[:n])[0]]
            return j, r.cpu().numpy().astype(np.float32), t.cpu().numpy().astype(np.float32), seed_pairs
    raise ValueError("two-view initialization failed: no pair with enough inliers")


def sanitize_chunk_poses(
    rot_l: np.ndarray, tr_l: np.ndarray, chunk_start: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Replace non-finite chunk poses by holding the last finite pose.

    A chunk solve may emit non-finite poses outright (degenerate
    registration); the Sim(3) composition must never see NaNs (the chordal-
    mean SVD throws LinAlgError and kills the whole sequence).  Frames with
    no finite predecessor fall back to identity."""
    rot_l = np.array(rot_l, np.float32)
    tr_l = np.array(tr_l, np.float32)
    bad = ~(
        np.isfinite(rot_l).all(axis=(1, 2)) & np.isfinite(tr_l).all(axis=1)
    )
    if bad.any():
        report_warn(
            "chunked VO: %d non-finite chunk poses at chunk start %d — "
            "holding last finite pose", int(bad.sum()), chunk_start,
        )
        for f in range(len(rot_l)):
            if bad[f]:
                src = f - 1
                while src >= 0 and bad[src]:
                    src -= 1
                if src >= 0:
                    rot_l[f], tr_l[f] = rot_l[src], tr_l[src]
                else:
                    rot_l[f] = np.eye(3, dtype=np.float32)
                    tr_l[f] = 0.0
    return rot_l, tr_l


def run_visual_odometry_chunked(
    images,
    cam: Pinhole,
    chunk: int = 12,
    overlap: int = 5,
    legacy: bool = False,
    device: DeviceLike = None,
    **kwargs,
) -> VOResult:
    """Long-sequence VO by submapping: the fused pipeline of
    ``vo_fused.run_visual_odometry_fused`` (scan front-end, global track
    graph, all chunk solves as one batch, Sim(3) composition, pose graph,
    global BA).  Runs on ``device`` (``cuda`` by default; ``"cpu"`` on the
    CPU), or with ``mesh=`` on every rank of a mesh (chunk solves and the
    global BA split across ranks, see ``vo_fused``).  Keyword arguments the
    fused path does not take are ignored with a warning.

    ``legacy=True`` selects the host-sequential submapping path: each chunk
    solved by ``run_visual_odometry``, composed by Sim(3) overlap fits only;
    for ``len(images) <= chunk`` one ``run_visual_odometry`` call with the
    keyword arguments it takes.
    """
    import inspect

    if legacy:
        if len(images) <= chunk:
            allowed = set(inspect.signature(run_visual_odometry).parameters)
            return run_visual_odometry(images, cam, device=device,
                                       **{k: v for k, v in kwargs.items() if k in allowed})
        return _run_visual_odometry_chunked_legacy(images, cam, chunk=chunk, overlap=overlap, device=device, **kwargs)
    from .vo_fused import run_visual_odometry_fused

    allowed = set(inspect.signature(run_visual_odometry_fused).parameters)
    fused_kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    dropped = sorted(set(kwargs) - set(fused_kwargs))
    if dropped:
        report_warn("chunked VO: legacy-only kwargs ignored by fused path: %s", ", ".join(dropped))
    return run_visual_odometry_fused(images, cam, chunk=chunk, overlap=overlap, device=device, **fused_kwargs)


def _run_visual_odometry_chunked_legacy(
    images,
    cam: Pinhole,
    chunk: int = 10,
    overlap: int = 4,
    **kwargs,
) -> VOResult:
    """Long-sequence VO by submapping: overlapping chunks, each solved
    independently by ``run_visual_odometry``, composed with a Sim(3)
    alignment over the shared frames (rotation: chordal mean of the shared
    frames' R_glob^T R_loc; scale: ratio of summed consecutive-center
    distances, the previous handoff's when the overlap motion has collapsed
    on either side; translation: residual mean).  Returns a VOResult whose
    trajectory covers every input frame; the chunks' landmarks are
    concatenated in the composed frame."""
    n = len(images)
    step = max(1, chunk - overlap)
    if overlap < 3:
        raise ValueError("Sim3 alignment needs >= 3 shared frames")

    rots_g = np.zeros((n, 3, 3), np.float32)
    trans_g = np.zeros((n, 3), np.float32)
    centers_g = np.zeros((n, 3), np.float32)
    have = np.zeros(n, bool)
    all_points = []
    total_tracks = 0
    lens = []

    s = 0
    while True:
        e = min(s + chunk, n)
        r = run_visual_odometry(images[s:e], cam, **kwargs)
        total_tracks += r.num_tracks
        if r.mean_track_length:
            lens.append(r.mean_track_length)
        rot_l, tr_l = sanitize_chunk_poses(r.rotations_wc, r.translations_wc, s)
        c_loc = -np.einsum("fji,fj->fi", rot_l, tr_l)
        if s == 0:
            rot_a, t_a, sc_a = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0
            prev_sc = 1.0
        else:
            shared = [f for f in range(s, min(s + overlap, n)) if have[f]]
            M = np.zeros((3, 3), np.float64)
            for f in shared:
                M += rots_g[f].T @ rot_l[f - s]
            if np.isfinite(M).all() and np.linalg.norm(M) > 1e-9:
                U, _, Vt = np.linalg.svd(M)
                rot_a = (U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt).astype(np.float32)
            else:
                report_warn("chunked VO: degenerate overlap rotation at chunk start %d — using identity alignment", s)
                rot_a = np.eye(3, dtype=np.float32)
            cl = np.stack([c_loc[f - s] for f in shared])
            cgl = centers_g[shared]
            d_loc = np.linalg.norm(np.diff(cl, axis=0), axis=1).sum()
            d_glob = np.linalg.norm(np.diff(cgl, axis=0), axis=1).sum()
            sc_a = float(d_glob / max(d_loc, 1e-9))
            # Degeneracy guard, not a range clamp: each chunk carries its own
            # monocular scale, so a legitimate handoff ratio may sit far from 1.
            n_int = max(len(shared) - 1, 1)
            typ_loc = float(np.median(np.linalg.norm(np.diff(c_loc, axis=0), axis=1)))
            g_lo = max(0, s - chunk)
            g_steps = np.linalg.norm(np.diff(centers_g[g_lo:s + 1], axis=0), axis=1)
            typ_glob = float(np.median(g_steps)) if len(g_steps) else 0.0
            bad_loc = d_loc < 0.2 * typ_loc * n_int
            bad_glob = typ_glob > 0 and d_glob < 0.2 * typ_glob * n_int
            if not np.isfinite(sc_a) or bad_loc or bad_glob:
                report_warn(
                    "chunked VO: degenerate overlap (d_loc=%.3g/typ %.3g, d_glob=%.3g/typ %.3g) at chunk start %d — "
                    "reusing previous scale %.3g", d_loc, typ_loc, d_glob, typ_glob, s, prev_sc,
                )
                sc_a = prev_sc
            prev_sc = sc_a
            t_a = (cgl - sc_a * cl @ rot_a.T).mean(0).astype(np.float32)
        for f in range(s, e):
            if have[f]:
                continue
            c = sc_a * rot_a @ c_loc[f - s] + t_a
            rw = rot_l[f - s] @ rot_a.T
            rots_g[f] = rw
            trans_g[f] = -rw @ c
            centers_g[f] = c
            have[f] = True
        if len(r.points):
            all_points.append(r.points * sc_a @ rot_a.T + t_a)
        if e == n:
            break
        s += step

    traj = Trajectory(
        timestamps=np.arange(n, dtype=np.float64) * 0.1,
        rotations=np.transpose(rots_g, (0, 2, 1)),
        positions=centers_g,
    )
    return VOResult(
        trajectory=traj,
        rotations_wc=rots_g,
        translations_wc=trans_g,
        points=np.concatenate(all_points) if all_points else np.zeros((0, 3), np.float32),
        num_tracks=total_tracks,
        mean_track_length=float(np.mean(lens)) if lens else 0.0,
    )


# --------------------------------------------------------------------------
# Scan front-end: carry, compact, top up
# --------------------------------------------------------------------------

# uint32 popcount by a byte table, for host-side descriptor gates.
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint16)


def popcount_u32(x: np.ndarray) -> np.ndarray:
    """Per-element set-bit count of a uint32 array (any shape)."""
    b = np.ascontiguousarray(x, dtype=np.uint32).view(np.uint8)
    return _POP8[b].reshape(*x.shape, 4).sum(-1)


_N_PEAKS = 4  # response peaks tried per carried feature


def _response(img: torch.Tensor, kind: str, det_opts: DetectorOptions) -> torch.Tensor:
    """The gated response map of ``kind`` over the whole frame."""
    if kind == "fast":
        # K6 writes the candidate map too, unread here: one float32 map a
        # frame, accepted rather than a second variant of the kernel.
        return fast_maps(img, None, FastOptions(), det_opts.min_valid_response, want_response=True)[1]
    full = torch.ones(img.shape, dtype=torch.int32, device=img.device)
    if kind == "harris":
        return KD.harris_response(img, full, det_opts)
    if kind == "shi_tomasi":
        return KD.shi_tomasi_response(img, full, det_opts)
    raise ValueError(f"unsupported detector kind {kind!r}; expected one of ['fast', 'harris', 'shi_tomasi']")


def _window_peaks(resp: torch.Tensor, uv: torch.Tensor, search_radius: int):
    """Top-4 response peaks, 5x5-suppressed, in the (2r+1)^2 window around
    every slot's integer position (clipped into the frame), all slots at
    once.  Returns (uv [N, 4, 2], response [N, 4])."""
    h, w = resp.shape
    win = 2 * search_radius + 1
    dev = resp.device
    r0 = torch.clamp(uv[:, 1].to(torch.int32) - search_radius, 0, h - win).to(torch.int64)
    c0 = torch.clamp(uv[:, 0].to(torch.int32) - search_radius, 0, w - win).to(torch.int64)
    k = torch.arange(win * win, device=dev)
    rr, cc = k // win, k % win
    patch = resp.reshape(-1)[(r0[:, None] + rr) * w + (c0[:, None] + cc)]  # [N, win*win]
    uvs, vals = [], []
    for _ in range(_N_PEAKS):
        best = torch.argmax(patch, dim=1)  # the first maximum, as jnp.argmax
        pr, pc = rr[best], cc[best]
        uvs.append(torch.stack([(c0 + pc).to(torch.float32), (r0 + pr).to(torch.float32)], -1))
        vals.append(patch.gather(1, best[:, None])[:, 0])
        near = ((rr - pr[:, None]).abs() <= 2) & ((cc - pc[:, None]).abs() <= 2)
        patch = torch.where(near, float("-inf"), patch)
    return torch.stack(uvs, 1), torch.stack(vals, 1)


def _carry_step(prev_words, img, prev: Features, kind, det_opts, brief_opts, search_radius, max_carry_hamming,
                carry_margin):
    """Re-locate every feature of the previous frame in ``img``: of the
    top-4 peaks in its window, the one whose BRIEF is nearest the old
    descriptor, accepted when it clearly beats the runner-up.  Returns
    (uv [N, 2], response [N], carried_ok [N])."""
    resp = _response(img, kind, det_opts)
    peak_uv, peak_resp = _window_peaks(resp, prev.uv, search_radius)
    n = peak_uv.shape[0]
    cand_words, cand_ok = brief_compute(img, peak_uv.reshape(n * _N_PEAKS, 2),
                                        prev.valid.repeat_interleave(_N_PEAKS), brief_opts)
    x = (cand_words.reshape(n, _N_PEAKS, -1) ^ prev_words[:, None, :]).to(torch.int64)
    ham = _popcount32(x).sum(-1)
    big = torch.full_like(ham, 1 << 15)
    ham = torch.where(cand_ok.reshape(n, _N_PEAKS), ham, big)
    best = torch.argmin(ham, dim=1)
    best_uv = peak_uv.gather(1, best[:, None, None].expand(n, 1, 2))[:, 0]
    best_resp = peak_resp.gather(1, best[:, None])[:, 0]
    best_ham = ham.gather(1, best[:, None])[:, 0]
    second_ham = torch.where(torch.arange(_N_PEAKS, device=ham.device) == best[:, None], big, ham).amin(1)
    carried_ok = (
        prev.valid
        & (best_resp > det_opts.min_valid_response)
        & (best_ham <= max_carry_hamming)
        & (best_ham + carry_margin <= second_ham)
    )
    if det_opts.subpixel:
        best_uv = KD.subpixel_refine(resp, best_uv, carried_ok)
    return best_uv, best_resp, carried_ok


def _top_up(img, existing: Features, kind, needed_features, det_opts, brief_opts):
    """``detect_good_features`` after the existing prefix (one greedy
    selection, two kernel launches on the card), then BRIEF."""
    feats = detect_good_features(img, existing, kind, needed_features, det_opts)
    words, dvalid = brief_compute(img, feats.uv, feats.valid, brief_opts)
    return feats, words, dvalid


def _incremental_step(img, prev: Features, prev_words, kind, needed_features, det_opts, brief_opts, search_radius,
                      max_carry_hamming, carry_margin):
    """One frame of the incremental front-end: carry the previous frame's
    features, compact the carried ones into a prefix (in slot order), top
    them up and describe.  Returns (feats, words, dvalid, link [N] int32:
    link[i] = the slot of previous feature i in this frame, or -1)."""
    uv, resp, ok = _carry_step(prev_words, img, prev, kind, det_opts, brief_opts, search_radius, max_carry_hamming,
                               carry_margin)
    order = torch.argsort((~ok).to(torch.int8), stable=True)  # carried slots first, in order
    prefix = Features(uv=uv[order], response=resp[order] * ok[order], valid=ok[order])
    feats, words, dvalid = _top_up(img, prefix, kind, needed_features, det_opts, brief_opts)
    slots = torch.arange(ok.shape[0], dtype=torch.int32, device=ok.device)
    new_slot_of = torch.empty_like(slots).scatter_(0, order, slots)
    return feats, words, dvalid, torch.where(ok, new_slot_of, -1)


def scan_frontend(
    images,
    detector_kind: str,
    needed_features: int,
    det_opts: DetectorOptions,
    brief_opts: BriefOptions,
    search_radius: int = 16,
    max_carry_hamming: int = 64,
    carry_margin: int = 16,
    device: DeviceLike = None,
):
    """The whole-sequence incremental front-end (the JAX package's
    ``scan_frontend_jit``): frame 0 detects afresh; every later frame runs
    ``_incremental_step``.

    images [F, H, W] uint8 (on ``device``, ``cuda`` by default).  Returns
    (feats Features stacked [F, N], words [F, N, W] int32, dvalid [F, N],
    links [F-1, N] int32: links[f, i] = slot of frame-f feature i carried to
    frame f+1, or -1).
    """
    imgs = as_tensor(images, device)
    capacity = det_opts.max_features
    feats, words, dvalid = _top_up(imgs[0], Features.empty(capacity, imgs.device), detector_kind, needed_features,
                                   det_opts, brief_opts)
    out = [(feats, words, dvalid)]
    links = []
    for f in range(1, imgs.shape[0]):
        feats, words, dvalid, link = _incremental_step(imgs[f], feats, words, detector_kind, needed_features,
                                                       det_opts, brief_opts, search_radius, max_carry_hamming,
                                                       carry_margin)
        links.append(link)
        out.append((feats, words, dvalid))
    stacked = Features(
        uv=torch.stack([o[0].uv for o in out]),
        response=torch.stack([o[0].response for o in out]),
        valid=torch.stack([o[0].valid for o in out]),
    )
    link_t = torch.stack(links) if links else torch.zeros((0, capacity), dtype=torch.int32, device=imgs.device)
    return stacked, torch.stack([o[1] for o in out]), torch.stack([o[2] for o in out]), link_t


def run_incremental_frontend(
    images,
    detector_kind: str,
    needed_features: int,
    det_opts: DetectorOptions,
    brief_opts: BriefOptions,
    search_radius: int = 16,
    max_carry_hamming: int = 64,
    carry_margin: int = 16,
    device: DeviceLike = None,
):
    """The incremental front-end with the JAX package's host-side link
    list: frame-to-frame carrying plus existing-seeded top-up detection
    (the reference's incremental re-detection, quirk Q9), the same per-frame
    body as ``scan_frontend``.

    Returns (feats [F] Features, words [F, N, W] int32, dvalid [F, N],
    carry_links: list of (f-1, f, m) with m [N] int64, m[prev_slot] =
    new_slot or -1).
    """
    feats, words, dvalid, links = scan_frontend(images, detector_kind, needed_features, det_opts, brief_opts,
                                                search_radius, max_carry_hamming, carry_margin, device)
    links_np = links.cpu().numpy().astype(np.int64)
    return feats, words, dvalid, [(f, f + 1, links_np[f]) for f in range(len(links_np))]


def batch_frontend(images, detector_kind: str, needed_features: int, det_opts: DetectorOptions,
                   brief_opts: BriefOptions, device: DeviceLike = None):
    """Every frame detected afresh (the JAX package's ``_batch_frontend_jit``):
    one ``detect_good_features_batch`` over the stack (one greedy selection,
    two kernel launches on the card), then BRIEF over the stack.  Returns
    (feats [F, N], words [F, N, W] int32, dvalid [F, N])."""
    imgs = as_tensor(images, device)
    feats = detect_good_features_batch(imgs, detector_kind, needed_features, det_opts)
    words, dvalid = brief_compute(imgs, feats.uv, feats.valid, brief_opts)
    return feats, words, dvalid


# --------------------------------------------------------------------------
# The legacy short-window VO
# --------------------------------------------------------------------------


def _gate_pairs(fa_idx, fb_idx, midx, uv_np, valid_np, cam: Pinhole, device) -> List[Tuple[int, int, np.ndarray]]:
    """Matches midx [P, N] of the frame pairs (fa_idx[p], fb_idx[p]), each
    kept where it is an inlier of the pair's two-view init: one batched
    ``two_view_init(..., cheirality_gate=False)`` over all pairs, every pair
    drawing its hypotheses from the same noise (seed 0), as the JAX package
    draws every pair's from one key.  The full init's inlier mask, not the
    cheaper ``epipolar_inlier_gate``: the legacy VO's thresholds were set
    against these inlier sets."""
    sel = np.clip(midx, 0, None)
    uv_b = uv_np[fb_idx][np.arange(len(fa_idx))[:, None], sel]
    pair_valid = (midx >= 0) & valid_np[fa_idx]
    inlier = geometry.two_view_init(as_tensor(uv_np[fa_idx], device), as_tensor(uv_b, device),
                                    as_tensor(pair_valid, device), cam, cheirality_gate=False)[3].cpu().numpy()
    return [(int(fa), int(fb), np.where(inlier[k], midx[k], -1)) for k, (fa, fb) in enumerate(zip(fa_idx, fb_idx))]


def _pair_matches(words, dvalid, uv_np, valid_np, carry_links, cam: Pinhole, match_opts: MatcherOptions
                  ) -> List[Tuple[int, int, np.ndarray]]:
    """The legacy VO's gated frame pairs: Hamming matches at offsets 1..4
    (each offset one batched ``match_hamming``; every extra offset
    lengthens tracks, and track length couples the inter-frame scale along
    the monocular chain), then the carry links, each gated by
    ``_gate_pairs``.  Returns [(fa, fb, index [N] or -1)] in that order."""
    n_frames = uv_np.shape[0]
    dev = words.device
    pairs: List[Tuple[int, int, np.ndarray]] = []
    for off in (1, 2, 3, 4):
        if n_frames <= off:
            continue
        m = match_hamming(words[:-off], dvalid[:-off], words[off:], dvalid[off:], match_opts)
        midx = torch.where(m.valid, m.index, -1).cpu().numpy()
        pairs += _gate_pairs(np.arange(n_frames - off), np.arange(off, n_frames), midx, uv_np, valid_np, cam, dev)
    if carry_links:
        pairs += _gate_pairs(np.asarray([fa for fa, _, _ in carry_links]), np.asarray([fb for _, fb, _ in carry_links]),
                             np.stack([m for _, _, m in carry_links]), uv_np, valid_np, cam, dev)
    return pairs


def run_visual_odometry(
    images,
    cam: Pinhole,
    detector_kind: str = "harris",
    needed_features: int = 200,
    det_opts: Optional[DetectorOptions] = None,
    # Steered descriptors: this path's carry gates and thresholds were set
    # against them (the fused VO defaults to upright ones).
    brief_opts: BriefOptions = BriefOptions(),
    match_opts: MatcherOptions = MatcherOptions(ratio=0.85),
    ba_opts: BAOptions = BAOptions(max_iterations=12, huber_delta=2.0, gate_px=3.0, gate_rounds=2),
    mesh=None,
    max_track_obs: int = 6,
    max_reproj_px: float = 3.0,
    incremental: bool = True,
    local_ba_window: int = 12,
    device: DeviceLike = None,
    stage_seconds: Optional[dict] = None,
) -> VOResult:
    """Monocular VO over a short frame stack, frame by frame.

    1. front-end: ``run_incremental_frontend`` (default; K2 once a frame on
       the card) or ``batch_frontend`` (``incremental=False``; K1 once);
    2. Hamming matching at frame offsets 1-4, each offset one batched call,
       and each pair (the carry links too) gated by the inlier mask of a
       batched two-view RANSAC;
    3. tracks (``_build_tracks``), the init pair (0, j) and its seed points;
    4. per frame: robust PnP from a motion prior (interpolated towards the
       init pose, or constant velocity), two safety nets (keep the prior if
       it explains the points better; snap the center to the prior when the
       step length is off by more than 4x), re-triangulation of new tracks
       on their widest baseline, and a windowed BA over every camera so far
       with the pre-window poses frozen;
    5. global BA (over ``mesh`` if given), guided re-association of missed
       observations (within ``max_reproj_px`` and 80 Hamming bits), and a
       second BA when any was added.

    Runs on ``device`` (``cuda`` unless ``images`` is a CPU tensor or
    ``device="cpu"``); raises without a card.  The host drives every frame,
    and each stage ends by copying its result to the host.  The motion
    prior's 3x3 Lie algebra runs on CPU tensors whatever the device.
    ``stage_seconds``, when given, receives each stage's host seconds.
    """
    if mesh is not None and device is None:
        device = mesh_device(mesh)
    imgs = as_tensor(images, device)
    dev = imgs.device
    check_no_tf32(dev)
    t_mark = [time.perf_counter()]

    def mark(stage):
        now = time.perf_counter()
        if stage_seconds is not None:
            stage_seconds[stage] = stage_seconds.get(stage, 0.0) + now - t_mark[0]
        t_mark[0] = now

    if det_opts is None:
        # Harris with subpixel refinement: about 0.1 px corner localisation.
        det_opts = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    n_frames = imgs.shape[0]
    capacity = det_opts.max_features

    carry_links: List[Tuple[int, int, np.ndarray]] = []
    if incremental:
        feats, words, dvalid, carry_links = run_incremental_frontend(imgs, detector_kind, needed_features, det_opts,
                                                                     brief_opts)
    else:
        feats, words, dvalid = batch_frontend(imgs, detector_kind, needed_features, det_opts, brief_opts)
    uv_np = feats.uv.cpu().numpy()
    valid_np = feats.valid.cpu().numpy()
    mark("frontend")

    pair_matches = _pair_matches(words, dvalid, uv_np, valid_np, carry_links, cam, match_opts)
    mark("match_gate")

    tracks = _build_tracks(pair_matches, n_frames, capacity)
    mark("tracks")

    # Two-view initialisation on the widest reliable pair (0, j*).
    j_init, r_init, t_init, init_seed_pairs = _pick_init_pair(tracks, uv_np, cam, n_frames, capacity, device=dev)

    rots = [np.eye(3, dtype=np.float32) for _ in range(n_frames)]
    trans = [np.zeros(3, np.float32) for _ in range(n_frames)]
    track_pt = np.full((len(tracks), 3), np.nan, np.float32)
    obs_by_frame: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(n_frames)]
    for t_id, tr in enumerate(tracks):
        for f, i in tr:
            obs_by_frame[f].append((t_id, uv_np[f, i]))
    on_dev = lambda x: as_tensor(np.ascontiguousarray(x, np.float32), dev)

    def _reproj_err(pts, rot, tr, uv):
        pc = pts @ np.asarray(rot).T + np.asarray(tr)
        z = np.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        return np.hypot(u - uv[:, 0], v - uv[:, 1])

    def triangulate_frame_pair(fa, fb, pairs):
        if not pairs:
            return
        uva_np = np.stack([p[1] for p in pairs])
        uvb_np = np.stack([p[2] for p in pairs])
        pts, ok = geometry.triangulate(on_dev(rots[fa]), on_dev(trans[fa]), on_dev(rots[fb]), on_dev(trans[fb]),
                                       on_dev(uva_np), on_dev(uvb_np), cam)
        pts = pts.cpu().numpy()
        # Cheirality and reprojection in both views: a wrong match or a
        # low-parallax pair gives a point that cannot explain its own
        # observations.
        ok = (
            ok.cpu().numpy()
            & (_reproj_err(pts, rots[fa], trans[fa], uva_np) < max_reproj_px)
            & (_reproj_err(pts, rots[fb], trans[fb], uvb_np) < max_reproj_px)
        )
        for k, (t_id, _, _) in enumerate(pairs):
            if ok[k] and np.isnan(track_pt[t_id, 0]):
                track_pt[t_id] = pts[k]

    def _collect_good(f_max: int, f_min: int = 0):
        """Tracks with a 3D point and >= 2 observations in frames [f_min, f_max]."""
        out = []
        for t_id, tr in enumerate(tracks):
            if np.isnan(track_pt[t_id, 0]):
                continue
            obs = [(fr, i) for fr, i in tr if f_min <= fr <= f_max]
            if len(obs) >= 2:
                out.append((t_id, obs))
        return out

    def _build_problem(rots_arr, trans_arr, good_tracks, pts_override=None, pad_to=None):
        L = len(good_tracks) if pad_to is None else max(pad_to, len(good_tracks))
        obs_cam = np.full((L, max_track_obs), -1, np.int32)  # -1: an empty slot
        obs_uv = np.zeros((L, max_track_obs, 2), np.float32)
        pts0 = np.zeros((L, 3), np.float32)
        for k, (t_id, tr) in enumerate(good_tracks):
            pts0[k] = track_pt[t_id] if pts_override is None else pts_override[k]
            for d, (fr, i) in enumerate(tr[:max_track_obs]):
                obs_cam[k, d] = fr
                obs_uv[k, d] = uv_np[fr, i]
        return BAProblem(rot=on_dev(rots_arr), trans=on_dev(trans_arr), points=on_dev(pts0),
                         obs_cam=as_tensor(obs_cam, dev), obs_uv=on_dev(obs_uv))

    def local_ba(f: int):
        """Windowed BA after registering frame f: every camera up to f in
        the problem, those before the last ``local_ba_window`` frozen, so old
        landmarks stay anchored and only the trailing window moves.  Cameras
        pad to multiples of 8 and landmarks to multiples of 32, as in the
        JAX package (there to bound recompiles), so both pose the same
        problem; a padded camera has no observations and does not move."""
        good_now = _collect_good(f)
        if len(good_now) < 8:
            return
        pad = ((len(good_now) + 31) // 32) * 32
        n_cams = f + 1
        c_pad = ((n_cams + 7) // 8) * 8
        rots_pad = np.concatenate([np.stack(rots[:n_cams]),
                                   np.broadcast_to(np.eye(3, dtype=np.float32), (c_pad - n_cams, 3, 3))])
        trans_pad = np.concatenate([np.stack(trans[:n_cams]), np.zeros((c_pad - n_cams, 3), np.float32)])
        prob = _build_problem(rots_pad, trans_pad, good_now, pad_to=pad)
        opts_local = dataclasses.replace(ba_opts, max_iterations=10, gate_rounds=1)
        n_fixed = max(1, n_cams - local_ba_window)
        solved = ba_solve(prob, cam, opts_local, num_fixed=n_fixed)
        r_s = solved.rot.cpu().numpy()
        t_s = solved.trans.cpu().numpy()
        p_s = solved.points.cpu().numpy()
        if not (np.isfinite(r_s[:n_cams]).all() and np.isfinite(t_s[:n_cams]).all()):
            return
        for fr in range(n_fixed, n_cams):
            rots[fr], trans[fr] = r_s[fr], t_s[fr]
        for k, (t_id, _) in enumerate(good_now):
            if np.isfinite(p_s[k]).all():
                track_pt[t_id] = p_s[k]

    # Seed the map from the init pair's RANSAC-inlier correspondences.
    rots[j_init], trans[j_init] = r_init, t_init
    triangulate_frame_pair(0, j_init, init_seed_pairs)
    mark("init")

    host = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def _pose_prior(f: int) -> Tuple[np.ndarray, np.ndarray]:
        """Motion prior for frame f's PnP: the init pose itself at j*; before
        it, the geodesic interpolation from identity towards the init pose
        (centers linear); after it, constant velocity from the last two
        registered frames."""
        if f == j_init:
            return rots[j_init], trans[j_init]
        if f < j_init:
            a = f / float(j_init)
            w_full = so3_log(host(rots[j_init])).numpy()
            r = so3_exp(host(a * w_full)).numpy()
            c_full = -rots[j_init].T @ trans[j_init]
            c = a * c_full
            return r, (-r @ c).astype(np.float32)
        # Constant velocity: T_f = dT T_{f-1} with dT = T_{f-1} T_{f-2}^-1.
        r_prev, t_prev = rots[f - 1], trans[f - 1]
        if f < 2:
            return r_prev, t_prev
        ri, ti = se3_inverse(host(rots[f - 2]), host(trans[f - 2]))
        dr, dt = se3_compose(host(r_prev), host(t_prev), ri, ti)
        rf, tf = se3_compose(dr, dt, host(r_prev), host(t_prev))
        return rf.numpy(), tf.numpy()

    max_known = capacity
    for f in range(1, n_frames):
        # Register frame f against the known track points: robust PnP from
        # the motion prior, padded to a fixed size.  With fewer than 6
        # points the prior stands (BA refines it through its tracks).
        known = [(t_id, uv) for t_id, uv in obs_by_frame[f] if not np.isnan(track_pt[t_id, 0])]
        r0_np, t0_np = _pose_prior(f)
        r, t = r0_np, t0_np
        if len(known) >= 6:
            k = min(len(known), max_known)
            pts_np = np.zeros((max_known, 3), np.float32)
            uvs_np = np.zeros((max_known, 2), np.float32)
            valid = np.zeros(max_known, bool)
            pts_np[:k] = np.stack([track_pt[t_id] for t_id, _ in known[:k]])
            uvs_np[:k] = np.stack([uv for _, uv in known[:k]])
            valid[:k] = True
            r_d, t_d = geometry.pnp_solve(on_dev(r0_np), on_dev(t0_np), on_dev(pts_np), on_dev(uvs_np),
                                          as_tensor(valid, dev), cam, iters=20, gate_px=max_reproj_px)
            r, t = r_d.cpu().numpy(), t_d.cpu().numpy()
            # Keep whichever of prior and solve explains the points better.
            e0 = np.median(_reproj_err(pts_np[:k], r0_np, t0_np, uvs_np[:k]))
            e1 = np.median(_reproj_err(pts_np[:k], r, t, uvs_np[:k]))
            if not np.isfinite(r).all() or not np.isfinite(t).all() or e1 > e0:
                r, t = r0_np, t0_np
            elif f >= 2:
                # Motion-model gate: at low parallax PnP has a near-flat
                # valley where a small yaw absorbs the baseline; keep the
                # rotation but snap the center back to the constant-velocity
                # prediction when the step length is off by more than 4x.
                c_prev = -rots[f - 1].T @ trans[f - 1]
                c_prior = -r0_np.T @ t0_np
                c_est = -r.T @ t
                sp = float(np.linalg.norm(c_prior - c_prev))
                se = float(np.linalg.norm(c_est - c_prev))
                if sp > 1e-9 and not (0.25 <= se / sp <= 4.0):
                    t = -r @ c_prior
        rots[f] = np.asarray(r, np.float32)
        trans[f] = np.asarray(t, np.float32)
        mark("pnp")

        # Triangulate every untriangulated track seen in frame f on its
        # widest baseline (first frame <-> f).
        by_first = {}
        for t_id, tr in enumerate(tracks):
            if not np.isnan(track_pt[t_id, 0]):
                continue
            fr = dict(tr)
            if f not in fr:
                continue
            fa = min(fr)
            by_first.setdefault(fa, []).append((t_id, uv_np[fa, fr[fa]], uv_np[f, fr[f]]))
        for fa, new_pairs in by_first.items():
            triangulate_frame_pair(fa, f, new_pairs)
        mark("triangulate")

        local_ba(f)
        mark("local_ba")

    rots_np = np.stack(rots)
    trans_np = np.stack(trans)

    # Global BA over every track with >= 2 observations and a point.
    good = _collect_good(n_frames - 1)

    def solve(problem):
        if mesh is not None:
            return make_distributed_ba(mesh, cam, ba_opts)(problem)
        return ba_solve(problem, cam, ba_opts)

    if good:
        problem = _build_problem(rots_np, trans_np, good)
        solved = solve(problem)

        # Guided re-association: project each track's point into every frame
        # it lacks and claim the nearest unclaimed detection within
        # max_reproj_px whose descriptor is within 80 bits of the track's
        # first; a second BA when any was added.
        words_np = words.cpu().numpy().view(np.uint32)  # the int32 words' bits as uint32
        rsolved = solved.rot.cpu().numpy()
        tsolved = solved.trans.cpu().numpy()
        psolved = solved.points.cpu().numpy()
        occupied = np.full((n_frames, capacity), -1, np.int64)
        for t_id, tr in enumerate(tracks):
            for f, i in tr:
                occupied[f, i] = t_id
        added = 0
        new_good = []
        for k, (t_id, tr) in enumerate(good):
            have = {f for f, _ in tr}
            ref_words = words_np[tr[0][0], tr[0][1]]
            obs = list(tr)
            for f in range(n_frames):
                if f in have or len(obs) >= max_track_obs:
                    continue
                pc = rsolved[f] @ psolved[k] + tsolved[f]
                if pc[2] < 1e-3:
                    continue
                u = cam.fx * pc[0] / pc[2] + cam.cx
                v = cam.fy * pc[1] / pc[2] + cam.cy
                d2 = np.hypot(uv_np[f, :, 0] - u, uv_np[f, :, 1] - v)
                d2[~valid_np[f]] = np.inf
                d2[occupied[f] >= 0] = np.inf
                i_best = int(np.argmin(d2))
                if d2[i_best] > max_reproj_px:
                    continue
                if popcount_u32(ref_words ^ words_np[f, i_best]).sum() > 80:
                    continue
                obs.append((f, i_best))
                occupied[f, i_best] = t_id
                added += 1
            new_good.append((t_id, sorted(obs)))

        if added:
            solved = solve(_build_problem(rsolved, tsolved, new_good, pts_override=psolved))
        rots_np = solved.rot.cpu().numpy()
        trans_np = solved.trans.cpu().numpy()
        points = solved.points.cpu().numpy()
        mean_len = float(np.mean([len(tr) for _, tr in new_good])) if new_good else 0.0
    else:
        problem = solved = None
        points = np.zeros((0, 3), np.float32)
        mean_len = 0.0
    mark("global_ba")

    centers = -np.einsum("fji,fj->fi", rots_np, trans_np)
    traj = Trajectory(
        timestamps=np.arange(n_frames, dtype=np.float64) * 0.1,
        rotations=np.transpose(rots_np, (0, 2, 1)),
        positions=centers.astype(np.float32),
    )
    return VOResult(
        trajectory=traj,
        rotations_wc=rots_np,
        translations_wc=trans_np,
        points=points,
        num_tracks=len(tracks),
        mean_track_length=mean_len,
        problem=problem,
        solved=solved,
    )
