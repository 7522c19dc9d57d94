"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
PyTorch versions, and the int64 oracle."""
