"""PyTorch/CUDA port of the feature front-end, for NVIDIA Hopper (H100).

A second package beside the JAX reference ``feature_detector_tpu``: the same
public names, argument order and layouts, written in PyTorch, with each of
the reference's Pallas TPU kernels on the ported path replaced by a
hand-written CUDA kernel (``kernels/csrc``); ``slam/`` holds the SLAM
back-end, the fused chunked visual odometry and the legacy short-window VO
(``slam/sequence.py: run_visual_odometry``, ``legacy=True``), ``parallel/``
multi-device execution on ``torch.distributed``, and ``oracle/`` the numpy
re-encodings of the reference's behaviour that the port is held against.
It imports neither JAX nor the JAX package.  Entry points run on ``cuda``
unless handed CPU tensors or ``device="cpu"``.
"""

__version__ = "0.1.0"

from .core.config import (
    BriefOptions,
    DetectorOptions,
    FastOptions,
    HarrisOptions,
    LineDetectorOptions,
    MatcherOptions,
    NNDetectorOptions,
    NNModelType,
    ShiTomasiOptions,
)
from .core.device import resolve_device
from .core.types import Descriptors, Features, Lines, Matches
from .frontend.descriptor import compute_descriptors, compute_descriptors_float, describe_and_match
from .frontend.detector import detect_good_features, detect_good_features_batch, sparsify_features
from .frontend.line_detector import LineDetectorState, detect_good_lines, detect_good_lines_with_state
from .frontend.nn_detector import NNFeaturePointDetector
from .kernels.greedy import greedy_select
from .match.float_matcher import FloatMatcherOptions, match_float
from .match.hamming import match_hamming

__all__ = [
    "BriefOptions", "DetectorOptions", "FastOptions", "HarrisOptions", "LineDetectorOptions",
    "MatcherOptions", "NNDetectorOptions", "NNModelType", "ShiTomasiOptions", "resolve_device",
    "Descriptors", "Features", "Lines", "Matches", "compute_descriptors", "compute_descriptors_float", "describe_and_match",
    "detect_good_features", "detect_good_features_batch", "sparsify_features",
    "LineDetectorState", "detect_good_lines", "detect_good_lines_with_state",
    "greedy_select", "match_hamming", "NNFeaturePointDetector", "FloatMatcherOptions",
    "match_float",
]
