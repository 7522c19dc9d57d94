"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
PyTorch versions, the execution seam (``ops``), the int64 oracle, and an
A/B timing tool (``compare``)."""


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
