"""Frozen option dataclasses of the PyTorch/CUDA front-end.

A copy of ``feature_detector_tpu/core/config.py`` with the same names, fields
and defaults (that module is pure Python, but importing it runs the JAX
package's ``__init__``, so the port keeps its own copy).  ``core/convert.py``
turns the JAX package's option objects into these through
``dataclasses.asdict``.

Every options struct in the reference maps 1:1 to a frozen dataclass here, with
identical defaults, so that a user of the reference can carry their configs over:

- ``DetectorOptions``      <- FeaturePointDetector::Options
    (reference: src/feature_point_detector/feature_point_detector.h:15-20)
- ``FastOptions``          <- FeaturePointFastDetector::SubOptions
    (reference: src/feature_point_detector/feature_point_fast_detector.h:12-15)
- ``HarrisOptions``        <- FeaturePointHarrisDetector::SubOptions
    (reference: src/feature_point_detector/feature_point_harris_detector.h:12-15)
- ``ShiTomasiOptions``     <- FeaturePointShiTomasDetector::SubOptions
    (reference: src/feature_point_detector/feature_point_shi_tomas_detector.h:12-14)
- ``BriefOptions``         <- BriefDescriptor::Options
    (reference: src/feature_descriptor/descriptor_brief.h:16-19)
- ``LineDetectorOptions``  <- FeatureLineDetector::Options
    (reference: src/feature_line_detector/feature_line_detector.h:40-45)
- ``NNDetectorOptions``    <- NNFeaturePointDetector::Options
    (reference: src/nn_feature_point_detector/nn_feature_point_detector.h:22-31)

All configs are hashable.  Shape-determining fields (``max_features`` etc.)
are part of the config, as in the JAX package, so both produce the same
fixed-capacity outputs.
"""

from __future__ import annotations

import dataclasses
import enum
import math


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class DetectorOptions:
    """Shared options of the classical point detectors.

    Mirrors FeaturePointDetector::Options (feature_point_detector.h:15-20).
    """

    min_feature_distance: int = 15
    grid_filter_row_divide_number: int = 12
    grid_filter_col_divide_number: int = 12
    min_valid_response: float = 0.1
    # --- New-framework shape controls (fixed-shape dataflow, no reference
    # counterpart: the reference uses dynamic std::vector sizes). ---
    max_features: int = 256
    # Subpixel corner localization (quadratic fit of the response map around
    # each selected corner).  No reference counterpart (the reference emits
    # integer pixels); off by default for parity, on in the VO pipeline where
    # integer quantization dominates the triangulation error budget.
    subpixel: bool = False

    def replace(self, **kw) -> "DetectorOptions":
        return dataclasses.replace(self, **kw)


@_frozen
class FastOptions:
    """FAST-N sub-options (feature_point_fast_detector.h:12-15)."""

    n: int = 12
    min_pixel_diff_value: int = 15


@_frozen
class HarrisOptions:
    """Harris sub-options (feature_point_harris_detector.h:12-15)."""

    alpha: float = 0.04
    half_patch_size: int = 1


@_frozen
class ShiTomasiOptions:
    """Shi-Tomasi sub-options (feature_point_shi_tomas_detector.h:12-14).

    NB the reference's response is the *largest* eigenvalue, not the canonical
    smallest one (feature_point_shi_tomas_detector.cpp:94-104); we preserve that.
    """

    half_patch_size: int = 1


@_frozen
class BriefOptions:
    """Steered-BRIEF options (descriptor_brief.h:16-19).

    ``length`` counts binary tests (bits); the packed descriptor is
    ``length // 32`` uint32 words.
    """

    length: int = 256
    half_patch_size: int = 8
    # Descriptor compute path: "mxu" (default; the name is the JAX package's)
    # quantizes the steering angle to ``steer_bins`` (OpenCV ORB practice: 30
    # bins of 12 deg) and rounds feature centers and rotated sample offsets to
    # integer pixels, so every bit is an exact integer comparison.  "gather"
    # is the continuous-angle bilinear reference path (decision Q1).
    method: str = "mxu"
    steer_bins: int = 30
    # Upright (unsteered) BRIEF: skip the intensity-centroid steering and
    # evaluate the pattern at angle 0.  Steering buys rotation invariance at
    # a large repeatability cost when the patch content is high-frequency —
    # the centroid angle is then nearly arbitrary, a fraction-of-a-degree
    # flicker crosses a steer bin, and the rotated pattern samples a
    # different pixel set entirely (measured on the synthetic VO sequence:
    # median true-match Hamming 86/256 steered vs ~30 upright).  For VO on
    # roughly-upright cameras the standard practice is an unsteered
    # descriptor; the reference's descriptor is always steered
    # (descriptor_brief.cpp:20-35), so the default stays False.
    upright: bool = False
    # Gaussian pre-smoothing of the image BEFORE descriptor sampling
    # (OpenCV ORB blurs with a 7x7 Gaussian for the same reason; the
    # reference samples raw pixels, so the default stays 0 for parity).
    # High-frequency texture aliases under sub-pixel keypoint shifts and
    # flips bits wholesale — measured true-pair Hamming on the synthetic VO
    # sequence: median 68 raw vs 41 at sigma 2 (upright).  The blurred
    # image is rounded back to integers, as in the JAX package.
    blur_sigma: float = 0.0

    @property
    def words(self) -> int:
        return (self.length + 31) // 32


@_frozen
class MatcherOptions:
    """Hamming matcher for packed BRIEF descriptors.

    No reference counterpart (the reference has no matcher); thresholds follow
    standard ORB matching practice.
    """

    max_distance: int = 64
    cross_check: bool = True
    ratio: float = 1.0  # Lowe ratio test; 1.0 disables.


@_frozen
class LineDetectorOptions:
    """LSD options (feature_line_detector.h:40-45)."""

    min_valid_gradient_norm: float = 20.0
    min_tolerance_angle_residual_in_rad: float = 22.5 * math.pi / 180.0
    min_valid_line_length_in_pixel: float = 20.0
    max_tolerance_inlier_ratio: float = 0.6
    # Fixed-shape controls.
    max_lines: int = 128
    # Stencil-sweep budget for the path-running-mean region flood
    # (feature_detector_tpu/kernels/lsd.py): reach = one pixel per sweep.
    # A segment longer than the budget splits rather than disappearing.
    propagation_steps: int = 256
    # Fixed fit-stage pixel budget: valid-gradient pixels compact into this
    # buffer before the per-candidate moment/extent reductions; pixels
    # beyond the cap are dropped from rectangle FITTING only.
    max_fit_pixels: int = 65536


class NNModelType(enum.Enum):
    """Mirrors NNFeaturePointDetector::ModelType (nn_feature_point_detector.h:15-20)."""

    SUPERPOINT_HEATMAP = 0
    SUPERPOINT_NMS = 1
    DISK_HEATMAP = 2
    DISK_NMS = 3


@_frozen
class NNDetectorOptions:
    """NN detector options (nn_feature_point_detector.h:22-31)."""

    invalid_boundary: int = 3
    min_feature_distance: int = 15
    max_image_rows: int = 480
    max_image_cols: int = 752
    max_number_of_detected_features: int = 240
    min_response: float = 0.1
    model_type: NNModelType = NNModelType.SUPERPOINT_HEATMAP
    compute_descriptors: bool = False

    def replace(self, **kw) -> "NNDetectorOptions":
        return dataclasses.replace(self, **kw)


@_frozen
class BAOptions:
    """Distributed Schur-complement bundle adjustment (new subsystem; the
    reference has no back-end)."""

    max_iterations: int = 10
    huber_delta: float = 1.0
    damping: float = 1e-4
    damping_up: float = 4.0
    damping_down: float = 0.5
    # Cameras frozen for gauge fixing.  Fix exactly ONE camera: monocular BA
    # also has a global-scale null direction, but LM damping regularizes it
    # harmlessly — freezing a second camera instead pins 5 spurious dof to
    # that camera's (possibly badly initialized) pose and blocks the solver
    # from ever correcting it.
    num_fixed_cameras: int = 1
    # Outlier gating (chi²-style): after each LM round, observations with a
    # residual norm beyond gate_px pixels are hard-excluded and the solve is
    # repeated (gate_rounds times).  Huber alone leaves an L1-like constant
    # pull from gross mismatches that measurably biases the optimum; gating
    # removes it.  0 disables gating.
    gate_px: float = 0.0
    gate_rounds: int = 2
    # Adaptive residual clipping (active only when gate_px > 0): at the start
    # of each LM round, observations whose residual norm exceeds
    # median + mad_clip·1.4826·MAD get zero weight for that round.  Pure
    # Huber lets gross outliers bend the cameras DURING the first round
    # (their L1 pull is constant, so the optimum trades clean residuals
    # against them — observed: clean rms drifted 0.6 → 1.5 px before gating
    # ever ran, at which point a fixed pixel gate chops clean observations).
    # The MAD rule is self-scaling and platform-insensitive.  0 disables.
    mad_clip: float = 5.0


@_frozen
class FrontendConfig:
    """One config pytree covering the whole front-end."""

    detector: DetectorOptions = DetectorOptions()
    fast: FastOptions = FastOptions()
    harris: HarrisOptions = HarrisOptions()
    shi_tomasi: ShiTomasiOptions = ShiTomasiOptions()
    brief: BriefOptions = BriefOptions()
    matcher: MatcherOptions = MatcherOptions()
    line: LineDetectorOptions = LineDetectorOptions()
    nn: NNDetectorOptions = NNDetectorOptions()
    ba: BAOptions = BAOptions()
