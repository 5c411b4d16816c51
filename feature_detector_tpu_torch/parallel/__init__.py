"""Multi-device execution of the PyTorch port on ``torch.distributed``:
one rank per device (SPMD), meshes with named dimensions, halo exchange,
and the data-parallel and row-sharded front-ends.  Counterpart of
``feature_detector_tpu/parallel``."""
