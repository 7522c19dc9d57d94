"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
PyTorch versions, the execution seam (``ops``), the int64 oracle, and an
A/B timing tool (``compare``)."""
