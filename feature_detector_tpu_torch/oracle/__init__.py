"""NumPy oracles of the reference's behaviour: the independent references
the port is held against (copies of ``feature_detector_tpu/oracle``).
Nothing on a main path calls them."""
