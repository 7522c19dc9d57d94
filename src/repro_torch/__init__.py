"""repro_torch: the PyTorch / CUDA port of :mod:`repro`.

Subpackages mirror ``repro``'s names (``core``, ``quant``, ``kernels``,
``models``, ``configs``, ``serve``, ``launch``, ``tune``) so each module's
reference counterpart is found by path.  The port imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro``.  Every quantized GEMM
on the serve path runs through hand-written CUDA kernels: the fused KMM
kernels (``kernels/csrc/fused_mm1.cu`` and ``fused_split.cu``), or under
a tuning table the staged digit-plane kernels it may pick
(``kernels/csrc/staged_pipe.cu`` for MM1, KMM2 and MM2), the Hopper
counterparts of the Pallas kernels.
"""
__version__ = "0.1.0"
