"""The reference's run.sh demo executables, on the port.

Counterpart of ``feature_detector_tpu/app/demo.py``: detection three ways
plus incremental re-detection, detection with BRIEF and matching, LSD lines
with their intermediate maps, the NN detectors, and the chunked visual
odometry on a synthetic sequence.  Each demo draws its results to PNG
files, prints its counts and times (TickTock's measurement points, on the
card between synchronisations) and returns them with the paths it wrote.

Usage:
    python -m feature_detector_tpu_torch.app.demo --image A.png --image2 B.png
        [--out DIR] [--device cpu] [--demo all|points|descriptor|lines|nn|vo] [--show]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..core.config import BriefOptions, DetectorOptions, MatcherOptions, NNDetectorOptions, NNModelType
from ..core.device import DeviceLike, as_tensor, resolve_device
from ..core.types import Features
from ..frontend.descriptor import compute_descriptors
from ..frontend.detector import detect_good_features
from ..frontend.line_detector import detect_good_lines, detect_good_lines_with_state
from ..frontend.nn_detector import NNFeaturePointDetector
from ..io.images import CYAN, GREEN, RED, YELLOW, draw_line, draw_solid_circle, load_gray, save_image, to_rgb
from ..match.hamming import match_hamming
from ..slam.evaluate import umeyama_alignment
from ..slam.sequence import make_synthetic_sequence, run_visual_odometry_chunked
from ..utils.timer import TickTock


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev: torch.device, fn):
    """(fn(), its milliseconds), the card synchronised at both ends."""
    _sync(dev)
    timer = TickTock()
    out = fn()
    _sync(dev)
    return out, timer.tock_in_millisecond()


def _save(out_dir: str, name: str, image, written: list) -> None:
    path = os.path.join(out_dir, name)
    save_image(path, image)
    written.append(path)


def demo_points(img: np.ndarray, out_dir: str, device: DeviceLike = None) -> dict:
    """test_feature_point_detector.cpp's flow: FAST, Harris and Shi-Tomasi at
    the demo's settings, then incremental re-detection around a 9x9 seeded
    grid."""
    dev = resolve_device(device)
    timg = as_tensor(np.ascontiguousarray(img), dev)
    out = {"counts": {}, "ms": {}, "written": []}
    for kind, resp in (("fast", 10.0), ("harris", 30.0), ("shi_tomasi", 40.0)):
        opts = DetectorOptions(min_feature_distance=20, min_valid_response=resp, max_features=256)
        fn = lambda: detect_good_features(timg, Features.empty(256, dev), kind, 200, opts)
        fn()  # warm-up
        feats, ms = _timed(dev, fn)
        uv, _ = feats.to_numpy()
        print(f"{kind} detected {len(uv)} | time cost {ms:.2f} ms")
        out["counts"][kind], out["ms"][kind] = len(uv), ms
        rgb = to_rgb(img)
        for x, y in uv:
            draw_solid_circle(rgb, int(x), int(y), 4, CYAN)
        _save(out_dir, f"{kind}_features.png", rgb, out["written"])

    # Incremental re-detection (test_feature_point_detector.cpp:44-65).
    opts = DetectorOptions(min_feature_distance=20, min_valid_response=30.0, max_features=256)
    seed = np.array([[i * 15.0, j * 15.0] for i in range(1, 10) for j in range(1, 10)], np.float32)
    existing = Features.from_numpy(seed, 256, device=dev)
    fn = lambda: detect_good_features(timg, existing, "harris", 200, opts)
    fn()
    feats, ms = _timed(dev, fn)
    uv, _ = feats.to_numpy()
    print(f"harris incremental: {len(seed)} seeded -> {len(uv)} total | {ms:.2f} ms")
    out["counts"]["harris_incremental"], out["ms"]["harris_incremental"] = len(uv), ms
    rgb = to_rgb(img)
    for x, y in uv[: len(seed)]:
        draw_solid_circle(rgb, int(x), int(y), 4, GREEN)
    for x, y in uv[len(seed):]:
        draw_solid_circle(rgb, int(x), int(y), 4, CYAN)
    _save(out_dir, "harris_incremental.png", rgb, out["written"])
    return out


def demo_descriptor(img: np.ndarray, out_dir: str, device: DeviceLike = None) -> dict:
    """test_feature_descriptor.cpp's flow (Harris and BRIEF-128), plus the
    matcher the reference lacks, on the image and a copy shifted 4 px."""
    dev = resolve_device(device)
    opts = DetectorOptions(min_feature_distance=20, min_valid_response=20.0, max_features=64)
    bopts = BriefOptions(length=128)
    timg = as_tensor(np.ascontiguousarray(img), dev)
    feats = detect_good_features(timg, Features.empty(64, dev), "harris", 10, opts)
    fn = lambda: compute_descriptors(timg, feats, bopts)
    fn()
    desc, ms = _timed(dev, fn)
    uv, _ = feats.to_numpy()
    print(f"brief: {len(uv)} features described | time cost {ms:.2f} ms")

    shifted = as_tensor(np.roll(img, 4, axis=1), dev)
    feats2 = detect_good_features(shifted, Features.empty(64, dev), "harris", 10, opts)
    desc2 = compute_descriptors(shifted, feats2, bopts)
    m = match_hamming(desc.words, desc.valid, desc2.words, desc2.valid, MatcherOptions())
    n_match = int(m.count)
    uv2, _ = feats2.to_numpy()
    print(f"matcher: {n_match} cross-checked matches")
    out = {"counts": {"described": len(uv), "matches": n_match}, "ms": {"brief": ms}, "written": []}
    rgb = to_rgb(img)
    idx = m.index.cpu().numpy()
    for i, (x, y) in enumerate(uv):
        draw_solid_circle(rgb, int(x), int(y), 4, RED)
        j = idx[i] if i < len(idx) else -1
        if 0 <= j < len(uv2):
            draw_line(rgb, x, y, uv2[j][0], uv2[j][1], YELLOW)
    _save(out_dir, "brief_matches.png", rgb, out["written"])
    return out


def demo_lines(img: np.ndarray, out_dir: str, device: DeviceLike = None) -> dict:
    """test_feature_line_detector.cpp's flow, with the five intermediate
    maps the reference demo opens: gradient norm, validity, angle, regions
    and fitted rectangles."""
    dev = resolve_device(device)
    timg = as_tensor(np.ascontiguousarray(img), dev)
    fn = lambda: detect_good_lines(timg, 100)
    fn()
    lines, ms = _timed(dev, fn)
    segs = lines.to_numpy()
    print(f"lsd detected {len(segs)} lines | time cost {ms:.2f} ms")
    out = {"counts": {"lines": len(segs)}, "ms": {"lsd": ms}, "written": []}
    rgb = to_rgb(img)
    for x1, y1, x2, y2 in segs:
        draw_line(rgb, x1, y1, x2, y2, GREEN)
    _save(out_dir, "lsd_lines.png", rgb, out["written"])

    state = detect_good_lines_with_state(timg)
    norm = state.norm.cpu().numpy()
    _save(out_dir, "lsd_norm.png", (255.0 * norm / max(norm.max(), 1e-6)).astype(np.uint8), out["written"])
    _save(out_dir, "lsd_validity.png", (state.valid.cpu().numpy() * 255).astype(np.uint8), out["written"])
    angle = state.angle.cpu().numpy()
    _save(out_dir, "lsd_angle.png", ((angle + np.pi) * (255.0 / (2 * np.pi))).astype(np.uint8), out["written"])
    labels = state.labels.cpu().numpy()
    # Region map: labels hashed to gray levels, invalid pixels black.
    lab_vis = np.where(labels >= 0, (labels.astype(np.int64) * 2654435761) % 200 + 55, 0).astype(np.uint8)
    _save(out_dir, "lsd_regions.png", lab_vis, out["written"])
    rects = {k: v.cpu().numpy() for k, v in state.rectangles().items()}
    rect_rgb = to_rgb(img)
    for i in np.nonzero(rects["valid"])[0]:
        cx, cy = rects["center"][i]
        a, length, width = rects["angle"][i], rects["length"][i], rects["width"][i]
        du, dv = np.cos(a), np.sin(a)
        nu, nv = -dv, du
        corners = [
            (cx - 0.5 * length * du - 0.5 * width * nu, cy - 0.5 * length * dv - 0.5 * width * nv),
            (cx + 0.5 * length * du - 0.5 * width * nu, cy + 0.5 * length * dv - 0.5 * width * nv),
            (cx + 0.5 * length * du + 0.5 * width * nu, cy + 0.5 * length * dv + 0.5 * width * nv),
            (cx - 0.5 * length * du + 0.5 * width * nu, cy - 0.5 * length * dv + 0.5 * width * nv),
        ]
        for j in range(4):
            draw_line(rect_rgb, *corners[j], *corners[(j + 1) % 4], RED)
    _save(out_dir, "lsd_rectangles.png", rect_rgb, out["written"])
    out["counts"]["rectangles"] = int(rects["valid"].sum())
    return out


def demo_nn(img2: np.ndarray, out_dir: str, device: DeviceLike = None) -> dict:
    """test_nn_feature_point_detector.cpp's flow, SuperPoint and DISK on the
    packaged trained weights, around a seeded 4x4 grid of existing
    features."""
    dev = resolve_device(device)
    # A 16-divisible crop: SuperPoint needs /8, the DISK U-Net /16.
    rows, cols = (img2.shape[0] // 16) * 16, (img2.shape[1] // 16) * 16
    img2 = np.ascontiguousarray(img2[:rows, :cols])
    timg = as_tensor(img2, dev)
    out = {"counts": {}, "ms": {}, "written": []}
    for mt in (NNModelType.SUPERPOINT_HEATMAP, NNModelType.DISK_HEATMAP):
        opts = NNDetectorOptions(max_image_rows=rows, max_image_cols=cols, model_type=mt)
        det = NNFeaturePointDetector(opts, device=dev)
        det.initialize()
        seed = np.array([[100.0 * i + 50, 100.0 * j + 50] for i in range(4) for j in range(4)], np.float32)
        seed = seed[(seed[:, 0] < cols - 1) & (seed[:, 1] < rows - 1)]
        existing = Features.from_numpy(seed, opts.max_number_of_detected_features, device=dev)
        (feats, _), ms = _timed(dev, lambda: det.detect(timg, existing))
        uv, _ = feats.to_numpy()
        name = mt.name.lower()
        print(f"{name} detected {len(uv)} | time cost {ms:.2f} ms")
        out["counts"][name], out["ms"][name] = len(uv), ms
        rgb = to_rgb(img2)
        for x, y in uv:
            draw_solid_circle(rgb, int(x), int(y), 4, CYAN)
        _save(out_dir, f"{name}_features.png", rgb, out["written"])
    return out


def demo_vo(out_dir: str, n_frames: int = 30, seed: int = 3, device: DeviceLike = None) -> dict:
    """Monocular VO: the fused chunked pipeline on a synthetic lateral
    sequence; a top-down plot of the estimate against ground truth, and
    the ATE."""
    dev = resolve_device(device)
    seq = make_synthetic_sequence(n_frames=n_frames, n_landmarks=500, seed=seed, motion="lateral", angle_step=0.03)
    t0 = time.perf_counter()
    res = run_visual_odometry_chunked(seq.images, seq.cam, device=dev)
    wall = time.perf_counter() - t0
    gt = seq.trajectory.positions
    a = umeyama_alignment(res.trajectory.positions, gt, with_scale=True)
    est = float(a.scale) * res.trajectory.positions @ a.rotation.cpu().numpy().T + a.translation.cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    print(f"vo: {n_frames} frames in {wall:.1f} s ({n_frames / wall:.1f} fps) | ATE {ate:.3f} m "
          f"({100 * ate / span:.2f}% of {span:.1f} m span) | {res.num_tracks} tracks")

    # Top-down (x, z) plot: ground truth green, estimate cyan.
    h, w = 480, 640
    canvas = np.full((h, w, 3), 24, np.uint8)
    allp = np.concatenate([gt, est])
    lo, hi = allp.min(0), allp.max(0)
    scale = 0.9 * min(w / max(hi[0] - lo[0], 1e-6), h / max(hi[2] - lo[2] + 1.0, 1e-6))

    def to_px(p):
        return int((p[0] - lo[0]) * scale + 0.05 * w), int((p[2] - lo[2]) * scale + 0.5 * h)

    for traj, color in ((gt, GREEN), (est, CYAN)):
        for i in range(len(traj) - 1):
            draw_line(canvas, *to_px(traj[i]), *to_px(traj[i + 1]), color)
        for p in traj:
            draw_solid_circle(canvas, *to_px(p), 2, color)
    out = {"counts": {"frames": n_frames, "tracks": int(res.num_tracks)},
           "ms": {"vo": wall * 1e3}, "ate_m": ate, "span_m": span, "written": []}
    _save(out_dir, "vo_trajectory.png", canvas, out["written"])
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "fd_demo"))
    parser.add_argument("--image", required=True, help="the points, descriptor and lines demos' image")
    parser.add_argument("--image2", required=True, help="the NN demo's image")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--demo", default="all", choices=["all", "points", "descriptor", "lines", "nn", "vo"])
    parser.add_argument(
        "--show", action="store_true",
        help="open a window for every image this run wrote and block on a keypress, like the reference demos "
        "(Visualizor2D ShowImage + WaitKey(0)); a headless host only registers them",
    )
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    img = load_gray(args.image)
    img2 = load_gray(args.image2)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    results = {}
    if args.demo in ("all", "points"):
        results["points"] = demo_points(img, args.out, dev)
    if args.demo in ("all", "descriptor"):
        results["descriptor"] = demo_descriptor(img, args.out, dev)
    if args.demo in ("all", "lines"):
        results["lines"] = demo_lines(img, args.out, dev)
    if args.demo in ("all", "nn"):
        results["nn"] = demo_nn(img2, args.out, dev)
    if args.demo in ("all", "vo"):
        results["vo"] = demo_vo(args.out, device=dev)
    print(f"outputs in {args.out}")
    if args.show:
        from ..io.images import load_rgb
        from ..io.visualize import interactive_available, show_image, wait_key

        for path in (p for r in results.values() for p in r["written"]):
            show_image(os.path.basename(path)[:-4].replace("_", " "), load_rgb(path))
        if interactive_available():
            print("press any key in a window to exit (WaitKey(0))")
        wait_key(0)
    return results


if __name__ == "__main__":
    main()
