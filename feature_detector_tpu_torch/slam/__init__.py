"""SLAM back-end of the PyTorch/CUDA port: Lie groups, two-view geometry,
PnP, bundle adjustment, pose graph, trajectory IO and evaluation, the scan
front-end and the fused chunked visual odometry.

Counterpart of ``feature_detector_tpu/slam``, with the multi-device BA
(``ba.make_distributed_ba``) and the VO's ``mesh`` argument on
``torch.distributed``.  Functions take tensors with leading batch
dimensions where the JAX package vmaps.
"""
