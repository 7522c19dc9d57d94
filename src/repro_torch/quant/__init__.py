"""Symmetric quantizer, per-layer precision policy and the quantized
matmul over the fused KMM kernel."""
