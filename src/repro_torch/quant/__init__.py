"""Symmetric quantizer, per-layer precision policy, pre-quantized weight
records and the quantized matmul over the fused KMM kernel."""
