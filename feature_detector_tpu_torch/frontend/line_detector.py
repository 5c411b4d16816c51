"""Line-detector front-end (FeatureLineDetector::DetectGoodFeatures
equivalent, feature_line_detector.h:51).

Counterpart of ``feature_detector_tpu/frontend/line_detector.py``.  Like the
reference, ``needed_feature_num`` does not cap the number of returned lines
(quirk Q8; only the fixed capacity ``opts.max_lines`` does); a zero budget
returns an empty set.  The region flood goes through the CUDA kernel of
``kernels/lsd_flood.py`` for images on the card, its plain version for CPU
images.

Entry points run on ``cuda`` unless handed CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import LineDetectorOptions
from ..core.device import DeviceLike, as_tensor
from ..core.types import Lines
from ..kernels import lsd as K


def detect_good_lines(
    image,
    needed_feature_num: int = 1,
    opts: LineDetectorOptions = LineDetectorOptions(),
    device: DeviceLike = None,
) -> Lines:
    """Line segments of one [H, W] uint8 image (tensor or numpy array):
    endpoints [max_lines, 4] (x1, y1, x2, y2) and valid [max_lines], by
    descending region weight."""
    image = as_tensor(image, device)
    if needed_feature_num == 0:
        return Lines.empty(opts.max_lines, device=image.device)
    norm, angle, valid = K.line_level_angle_map(image, opts)
    endpoints, line_valid = K.detect_lines_from_maps(norm, angle, valid, tuple(image.shape), opts)
    return Lines(endpoints=endpoints, valid=line_valid)


@dataclasses.dataclass(frozen=True)
class LineDetectorState:
    """Introspection mirror of the reference's accessors
    (feature_line_detector.h:54-63): the gradient-norm map, validity map,
    angle map, region map and fitted rectangles that the reference demo draws
    (test_feature_line_detector.cpp:15-85)."""

    lines: Lines
    norm: torch.Tensor    # [rows-1, cols-1] gradient norm ("pixels" field)
    angle: torch.Tensor   # level-line angle map
    valid: torch.Tensor   # validity map
    labels: torch.Tensor  # region map (seed flat index; -1 invalid)
    rects: dict           # per-line center/angle/length/width/inlier_ratio/...

    def pixels(self):
        """(norm, angle, valid) grids: PixelParam fields
        (feature_line_detector.h:14-20)."""
        return self.norm, self.angle, self.valid

    def sorted_pixels(self) -> np.ndarray:
        """Valid pixel (row, col) coords sorted by descending gradient norm
        (feature_line_detector.cpp:92-94's seed order), as numpy."""
        norm = self.norm.cpu().numpy()
        rr, cc = np.nonzero(self.valid.cpu().numpy())
        order = np.argsort(-norm[rr, cc], kind="stable")
        return np.stack([rr[order], cc[order]], -1)

    def rectangles(self) -> dict:
        """Fitted rectangle params of the selected lines (RectangleParam,
        feature_line_detector.h:27-38) as a dict of tensors."""
        return self.rects


def detect_good_lines_with_state(
    image, opts: LineDetectorOptions = LineDetectorOptions(), device: DeviceLike = None
) -> LineDetectorState:
    """Detection plus every intermediate map the reference demo visualizes."""
    image = as_tensor(image, device)
    norm, angle, valid = K.line_level_angle_map(image, opts)
    endpoints, line_valid, labels, rects = K.detect_lines_with_state(
        norm, angle, valid, tuple(image.shape), opts
    )
    return LineDetectorState(
        lines=Lines(endpoints=endpoints, valid=line_valid),
        norm=norm, angle=angle, valid=valid, labels=labels, rects=rects,
    )
