"""repro_torch: the PyTorch / CUDA port of :mod:`repro`.

Subpackages mirror ``repro``'s names (``core``, ``quant``, ``kernels``,
``models``, ``configs``, ``serve``, ``launch``) so each module's reference
counterpart is found by path.  The port imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro``.  Every quantized GEMM on the serve
path runs through one hand-written CUDA kernel
(``kernels/csrc/fused_gemm.cu``), the Hopper counterpart of the fused Pallas
KMM kernel.
"""
__version__ = "0.1.0"
