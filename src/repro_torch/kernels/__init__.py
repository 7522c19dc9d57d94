"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
PyTorch versions, the execution seam (``ops``), the int64 oracle, and an
A/B timing tool (``compare``)."""


def records_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (``None`` entries,
    an absent bias, say, are skipped)."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_grad_fn(out, what: str):
    """On CUDA an output whose inputs require grad must carry a
    ``grad_fn``: a kernel's output filled through ctypes has none, and
    gradients would stop there without an error."""
    if out.is_cuda and out.grad_fn is None:
        raise RuntimeError(f"{what}: the output lost its grad_fn")
    return out


def launch_counts():
    """Every kernel wrapper's launch count, by kernel: the fused GEMM per
    mode (``dense_<mode>``, ``grouped_<mode>``), the staged kernels, the
    WKV recurrence, the row-invariant matmul and norm and the selective
    scan."""
    from repro_torch.kernels import (fused_gemm, kmm_gemm, mm1_gemm,
                                     mm2_gemm, rowinv, ssm_scan, wkv_gemm)
    out = {f"dense_{m}": n for m, n in fused_gemm.launches.items()}
    out.update({f"grouped_{m}": n
                for m, n in fused_gemm.grouped_launches.items()})
    for mod in (mm1_gemm, kmm_gemm, mm2_gemm, wkv_gemm, rowinv, ssm_scan):
        out.update(mod.launches)
    return out
