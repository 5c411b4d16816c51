"""Sequences and the visual-odometry entry: trajectory IO, synthetic
sequences, track building and the whole-sequence scan front-end.

Counterpart of ``feature_detector_tpu/slam/sequence.py`` for the fused
chunked VO (``run_visual_odometry_chunked`` and what it runs).  The numpy
host code (quaternions, TUM/EuRoC files, the renderer, the conflict-free
track graph, chunk-pose sanitising) is a copy of the JAX package's, so the
same seed renders the same images.  ``scan_frontend`` is the JAX package's
``scan_frontend_jit``: a loop over frames, each running the carry step (the
top 4 response peaks in a window around every feature of the previous
frame, BRIEF at each, the best by Hamming distance), compaction of the
carried features into a prefix, and the top-up detection after them, whose
greedy selection is the CUDA kernel (K2) on the card.

Not ported yet: the legacy short-window VO (``run_visual_odometry``,
``legacy=True``) and the host-sequential ``run_incremental_frontend``.
``mesh`` passes through to the fused path, which splits its chunk solves
and global BA over the mesh's ranks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import BriefOptions, DetectorOptions
from ..core.device import DeviceLike, as_tensor
from ..core.types import Features
from ..frontend.detector import detect_good_features
from ..kernels import detect as KD
from ..kernels.brief import brief_compute
from ..match.hamming import _popcount32
from ..utils.log import report_warn
from .ba import BAProblem
from .camera import Pinhole
from .lie import so3_exp


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
    fused path does not take are ignored with a warning.  ``legacy=True`` (the short-window sequential VO) is not
    ported yet and raises.
    """
    if legacy:
        raise NotImplementedError("the legacy VO (legacy=True) is not ported yet; use the fused path")
    import inspect

    from .vo_fused import run_visual_odometry_fused

    allowed = set(inspect.signature(run_visual_odometry_fused).parameters)
    fused_kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    dropped = sorted(set(kwargs) - set(fused_kwargs))
    if dropped:
        report_warn("chunked VO: legacy-only kwargs ignored by fused path: %s", ", ".join(dropped))
    return run_visual_odometry_fused(images, cam, chunk=chunk, overlap=overlap, device=device, **fused_kwargs)


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
    full = torch.ones(img.shape, dtype=torch.int32, device=img.device)
    if kind == "harris":
        return KD.harris_response(img, full, det_opts)
    if kind == "shi_tomasi":
        return KD.shi_tomasi_response(img, full, det_opts)
    if kind == "fast":
        return KD.fast_response(img, full)
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
    ``scan_frontend_jit``): frame 0 detects afresh; every later frame
    carries the previous frame's features, compacts the carried ones into a
    prefix, tops them up with ``detect_good_features`` (one greedy selection,
    two kernel launches on the card) and describes them.

    images [F, H, W] uint8 (on ``device``, ``cuda`` by default).  Returns
    (feats Features stacked [F, N], words [F, N, W] int32, dvalid [F, N],
    links [F-1, N] int32: links[f, i] = slot of frame-f feature i carried to
    frame f+1, or -1).
    """
    imgs = as_tensor(images, device)
    dev = imgs.device
    capacity = det_opts.max_features
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)

    def top_up(img, existing):
        feats = detect_good_features(img, existing, detector_kind, needed_features, det_opts)
        words, dvalid = brief_compute(img, feats.uv, feats.valid, brief_opts)
        return feats, words, dvalid

    feats, words, dvalid = top_up(imgs[0], Features.empty(capacity, dev))
    out = [(feats, words, dvalid)]
    links = []
    for f in range(1, imgs.shape[0]):
        img = imgs[f]
        uv, resp, ok = _carry_step(words, img, feats, detector_kind, det_opts, brief_opts, search_radius,
                                   max_carry_hamming, carry_margin)
        order = torch.argsort((~ok).to(torch.int8), stable=True)  # carried slots first, in order
        prefix = Features(uv=uv[order], response=resp[order] * ok[order], valid=ok[order])
        feats, words, dvalid = top_up(img, prefix)
        new_slot_of = torch.empty_like(slots).scatter_(0, order, slots)
        links.append(torch.where(ok, new_slot_of, -1))
        out.append((feats, words, dvalid))

    stacked = Features(
        uv=torch.stack([o[0].uv for o in out]),
        response=torch.stack([o[0].response for o in out]),
        valid=torch.stack([o[0].valid for o in out]),
    )
    link_t = torch.stack(links) if links else torch.zeros((0, capacity), dtype=torch.int32, device=dev)
    return stacked, torch.stack([o[1] for o in out]), torch.stack([o[2] for o in out]), link_t
