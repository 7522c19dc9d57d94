"""Fused single-pass integer GEMM (modes mm1, kmm2, mm2 and kmm4), dense and
grouped: wrappers, plain PyTorch versions and launch counts.

Port of ``repro.kernels.fused_gemm.fused_gemm`` and ``fused_gemm_grouped``.
On CUDA tensors :func:`fused_gemm` and :func:`fused_gemm_grouped` launch a
hand-written Hopper kernel — ``csrc/fused_mm1.cu`` in mode mm1 and
``csrc/fused_split.cu`` in modes kmm2, mm2 and kmm4 (pipelined 16-byte
copies, the digit split from shared memory, exact split-K, both planned by
:mod:`.mm1_plan`) — or raise; on CPU
tensors they run :func:`fused_gemm_reference` and
:func:`fused_gemm_grouped_reference`, the plain PyTorch versions of the
same functions.  There is no other route and no fallback.

The grouped GEMM is ragged when it gets ``counts`` (E, S) and a static
``seg``: row ``r`` of expert ``e`` is live iff ``r // seg < S`` and
``r % seg < counts[e, r // seg]`` (:func:`ragged_row_mask`).  Dead rows are
exact zeros; live rows equal a dense :func:`fused_gemm` of that expert.

Numerics are the reference's, bit for bit: the centered digit split at
``h = ceil(w/2)`` with ``z = 2^(h-1)`` (kmm4 re-splits each branch plainly
at ``h2 = ceil((h+1)/2)``), the padded contraction length
``kp = ceil(K / block_k) * block_k`` (padding positions split as (0, -z) and
``kp`` enters the Section IV-D correction), the int32 row and column sums
(which wrap modulo 2^32 as the reference's scratch does, visible at kmm4
widths for rows that lean one way), and the fp32 operation order of the
mode's combine, correction and dequant epilogue.  Of the reference's tile
arguments only ``block_k`` is taken, because it fixes ``kp``; the CUDA
kernel picks its own tiles.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, mm1_plan

MODES = ("mm1", "kmm2", "mm2", "kmm4")

# Launches of the CUDA kernel per mode, dense and grouped; each wrapper adds
# one where it launches and nowhere else (CPU calls run the plain version
# and count 0).
launches: Dict[str, int] = {mode: 0 for mode in MODES}
grouped_launches: Dict[str, int] = {mode: 0 for mode in MODES}

_MODE_ID = {"mm1": 1, "kmm2": 2, "mm2": 3, "kmm4": 4}
# Widths (lo, hi] at which mm2's and kmm4's digits fit the card's s8 MMAs
# (kmm2's window is (m, 14]).  kmm4 at w <= 16 is a tuner-only alternative
# (the analytic plan runs it from w = 17).
_WINDOWS = {"mm2": (8, 16), "kmm4": (8, 26)}
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    for counts in (launches, grouped_launches):
        for mode in counts:
            counts[mode] = 0


def resolve(w: int, m: int = 8, mode: str = "auto"):
    """(mode, h, z, carrier dtype) for a w-bit GEMM, as the reference's
    ``_resolve``: int8 carrier in the MM1 window, int16 through w = 16,
    int32 above and for kmm4 at any width (its kernel reads int32).  kmm4's
    level-2 split point is ``h2 = ceil((h+1)/2)``."""
    if mode == "auto":
        mode = "mm1" if w <= m else "kmm2"
    if mode not in MODES:
        raise ValueError(f"unknown fused mode {mode!r}; choices {MODES}")
    split = mode != "mm1"
    if split:
        lo, hi = (m, 14) if mode == "kmm2" else _WINDOWS[mode]
        if not lo < w <= hi:
            raise ValueError(f"{mode} digits fit s8 only for {lo} < w <= "
                             f"{hi}, got w={w}")
    h = -(-w // 2) if split else 0
    z = (1 << (h - 1)) if split else 0
    carrier = (torch.int8 if not split else
               torch.int16 if w <= 16 and mode != "kmm4" else torch.int32)
    return mode, h, z, carrier


def padded_k(k: int, block_k: int) -> int:
    return -(-k // block_k) * block_k


def _out_dtype(mode: str, dequant: bool, combine_int32: bool, out_dtype):
    if out_dtype is None:
        out_dtype = (torch.float32 if dequant else
                     torch.int32 if (combine_int32 or mode == "mm1") else
                     torch.float32)
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    int_val = mode == "mm1" or combine_int32
    if out_dtype == torch.int32 and (dequant or not int_val):
        raise ValueError("int32 output needs an exact integer plan without "
                         "dequant")
    return out_dtype


def _check_devices(tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_gemm runs on cuda or cpu, not {device}")


def fused_gemm(a: torch.Tensor, b: torch.Tensor,
               sx: Optional[torch.Tensor] = None,
               sw: Optional[torch.Tensor] = None, *,
               w: int, m: int = 8, mode: str = "auto", block_k: int = 256,
               combine_int32: bool = False, out_dtype=None) -> torch.Tensor:
    """Fused integer GEMM on the original (M, K) x (K, N) operands.

    ``a``/``b`` hold signed ``w``-bit values in any integer dtype (cast to
    the mode's carrier); with ``sx`` (M, 1) and ``sw`` (1, N) fp32 scales the
    dequant epilogue ``acc * (sx * sw)`` runs in the kernel.  Without scales
    the output is int32 for exact plans, fp32 otherwise.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need (M, K) x (K, N) operands, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    a, b, sx, sw, kw = _prepare(a, b, sx, sw, w=w, m=m, mode=mode,
                                block_k=block_k, combine_int32=combine_int32,
                                out_dtype=out_dtype)
    if a.device.type == "cpu":
        return fused_gemm_reference(a, b, sx, sw, **kw)
    return _launch(a, b, sx, sw, None, seg=0, **kw)


def fused_gemm_grouped(a: torch.Tensor, b: torch.Tensor,
                       sx: Optional[torch.Tensor] = None,
                       sw: Optional[torch.Tensor] = None,
                       counts: Optional[torch.Tensor] = None, *,
                       w: int, m: int = 8, mode: str = "auto",
                       seg: Optional[int] = None, block_k: int = 256,
                       combine_int32: bool = False,
                       out_dtype=None) -> torch.Tensor:
    """Grouped :func:`fused_gemm`: (E, C, K) x (E, K, N) -> (E, C, N) in one
    launch, each group equal to a dense call on its slices.

    Scales, when given, are (E, C, 1) and (E, 1, N).  ``counts`` (E, S)
    integer with a static positive ``seg`` makes the launch ragged: the C
    rows of expert ``e`` are S segments of ``seg`` rows, of which the first
    ``counts[e, s]`` are live; dead rows come out as exact zeros.  The MoE
    dispatch passes S = batch and seg = capacity.  ``counts`` stays on the
    device: the kernel reads it, the host never does.
    """
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"need (E, C, K) x (E, K, N) operands, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if counts is not None:
        if seg is None or seg <= 0:
            raise ValueError("ragged counts need a positive static seg")
        if counts.dim() != 2 or counts.shape[0] != a.shape[0] \
                or counts.shape[1] == 0:
            raise ValueError(f"counts must be (E, S) with S > 0, got "
                             f"{tuple(counts.shape)}")
        if counts.dtype.is_floating_point:
            raise TypeError("counts must be integer")
    a, b, sx, sw, kw = _prepare(a, b, sx, sw, w=w, m=m, mode=mode,
                                block_k=block_k, combine_int32=combine_int32,
                                out_dtype=out_dtype, extra=counts)
    if counts is not None:
        counts = counts.to(torch.int32)
    if a.device.type == "cpu":
        return fused_gemm_grouped_reference(a, b, sx, sw, counts, seg=seg,
                                            **kw)
    return _launch(a, b, sx, sw, counts, seg=seg or 0, **kw)


def _prepare(a, b, sx, sw, *, w, m, mode, block_k, combine_int32, out_dtype,
             extra=None):
    """Shared checks and casts: operands in the mode's carrier, scales in
    fp32 shaped (..., M, 1) / (..., 1, N), and the plain version's
    keyword arguments (which the launch takes too)."""
    if (sx is None) != (sw is None):
        raise ValueError("pass both sx and sw for the dequant epilogue")
    dequant = sx is not None
    mode, h, z, carrier = resolve(w, m, mode)
    out_dtype = _out_dtype(mode, dequant, combine_int32, out_dtype)
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        raise TypeError("fused_gemm takes integer operands")
    _check_devices([a, b, sx, sw, extra])
    lead = tuple(a.shape[:-2])
    m_dim, k_dim = a.shape[-2:]
    n_dim = b.shape[-1]
    if dequant:
        sx = sx.to(torch.float32).reshape(lead + (m_dim, 1))
        sw = sw.to(torch.float32).reshape(lead + (1, n_dim))
    kw = dict(mode=mode, h=h, z=z, kp=padded_k(k_dim, block_k),
              combine_int32=combine_int32, out_dtype=out_dtype)
    return a.to(carrier), b.to(carrier), sx, sw, kw


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _launch(a, b, sx, sw, counts, *, seg, mode, h, z, kp, combine_int32,
            out_dtype):
    """One launch of the CUDA kernel: dense for 2-D operands, grouped (and
    ragged with ``counts``) for 3-D ones."""
    for name, t in (("a", a), ("b", b), ("sx", sx), ("sw", sw),
                    ("counts", counts)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_gemm: {name} must be contiguous "
                             f"(got strides {t.stride()})")
    grouped = a.dim() == 3
    lead = tuple(a.shape[:-2])
    m_dim, k_dim = a.shape[-2:]
    n_dim = b.shape[-1]
    if max(m_dim, k_dim, n_dim, kp) >= 2 ** 31:
        raise ValueError("fused_gemm: dimensions must fit int32")
    out = torch.empty(lead + (m_dim, n_dim), dtype=out_dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if mode == "mm1":
            err = _launch_mm1(a, b, sx, sw, counts, out, seg, stream)
        else:
            err = _launch_split(a, b, sx, sw, counts, out, seg, stream,
                                mode=mode, h=h, z=z, kp=kp,
                                combine_int32=combine_int32)
    if err != 0:
        raise RuntimeError(f"fused_gemm kernel launch failed: CUDA error "
                           f"{err}")
    (grouped_launches if grouped else launches)[mode] += 1
    return out


def _launch_mm1(a, b, sx, sw, counts, out, seg, stream, *,
                kernel=None) -> int:
    """One launch of the mm1 kernel on the plan for this shape and card;
    the CUDA error code.  ``kernel`` maps a C entry's name to its function
    (this checkout's library by default)."""
    kernel = kernel or _kernel
    grouped = a.dim() == 3
    groups = a.shape[0] if grouped else 1
    m_dim, k_dim = a.shape[-2:]
    n_dim = b.shape[-1]
    plan = mm1_plan.plan_mm1(groups, m_dim, k_dim, n_dim,
                             _sm_count(a.device.index))
    ws, counters = _workspace(a.device, stream, plan)
    # 16-byte copies need every row 16-byte aligned; the kernel checks too
    vec_a = int(k_dim % 16 == 0 and a.data_ptr() % 16 == 0)
    vec_b = int(n_dim % 16 == 0 and b.data_ptr() % 16 == 0)
    tail = (plan.bm, plan.split, plan.k_split, vec_a, vec_b,
            _OUT_KIND[out.dtype], stream)
    if grouped:
        return kernel("fused_mm1_grouped_launch")(
            a.data_ptr(), b.data_ptr(), _ptr(sx), _ptr(sw), _ptr(counts),
            out.data_ptr(), _ptr(ws), _ptr(counters), groups, m_dim, k_dim,
            n_dim, seg, counts.shape[1] if counts is not None else 0, *tail)
    return kernel("fused_mm1_launch")(
        a.data_ptr(), b.data_ptr(), _ptr(sx), _ptr(sw), out.data_ptr(),
        _ptr(ws), _ptr(counters), m_dim, k_dim, n_dim, *tail)


def _launch_split(a, b, sx, sw, counts, out, seg, stream, *, mode, h, z,
                  kp, combine_int32, kernel=None) -> int:
    """One launch of the split modes' kernel (kmm2, mm2, kmm4) on the plan
    for this shape, its padded K and the card; the CUDA error code.
    ``kernel`` as in :func:`_launch_mm1`."""
    kernel = kernel or _kernel
    grouped = a.dim() == 3
    groups = a.shape[0] if grouped else 1
    m_dim, k_dim = a.shape[-2:]
    n_dim = b.shape[-1]
    plan = mm1_plan.plan_split(mode, groups, m_dim, kp, n_dim,
                               _sm_count(a.device.index),
                               ragged=counts is not None)
    ws, counters = _workspace(a.device, stream, plan)
    # 16-byte copies (8 int16, 4 int32) need every row 16-byte aligned; the
    # kernel checks too
    vals = 16 // mm1_plan.SPLIT_CARRIER[mode]
    vec_a = int(k_dim % vals == 0 and a.data_ptr() % 16 == 0)
    vec_b = int(n_dim % vals == 0 and b.data_ptr() % 16 == 0)
    tail = (_MODE_ID[mode], h, z, int(combine_int32), _OUT_KIND[out.dtype],
            plan.bm, plan.split, plan.k_split, vec_a, vec_b, stream)
    if grouped:
        return kernel("fused_split_grouped_launch")(
            a.data_ptr(), b.data_ptr(), _ptr(sx), _ptr(sw), _ptr(counts),
            out.data_ptr(), _ptr(ws), _ptr(counters), groups, m_dim, k_dim,
            n_dim, kp, seg, counts.shape[1] if counts is not None else 0,
            *tail)
    return kernel("fused_split_launch")(
        a.data_ptr(), b.data_ptr(), _ptr(sx), _ptr(sw), out.data_ptr(),
        _ptr(ws), _ptr(counters), m_dim, k_dim, n_dim, kp, *tail)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# Split-K workspace of the pipelined kernels (mm1; kmm2, mm2, kmm4), one
# (partials, counters) pair per (device, stream), shared by both kernels:
# each leaves the counters at 0, and launches on one stream run in order,
# so each launch finds them at 0.  Two streams must not share a pair
# (their launches could interleave on the counters), hence the key.  Both
# grow, zeroed, when a plan needs more.
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, plan: mm1_plan.SplitKPlan):
    if plan.split == 1:
        return None, None
    key = (device.index, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < plan.ws_ints:
        ws = torch.zeros(plan.ws_ints, dtype=torch.int32, device=device)
    if counters is None or counters.numel() < plan.n_counters:
        counters = torch.zeros(plan.n_counters, dtype=torch.int32,
                               device=device)
    _WORKSPACE[key] = (ws, counters)
    return ws, counters


def workspace_tensors(device, stream: int) -> Tuple[torch.Tensor, ...]:
    """The split-K workspace tensors held now for (``device``, ``stream``):
    a CUDA graph that captured launches on that stream must keep them
    alive, and a capture that finds them replaced captured a freed one.
    ``device`` is a tensor's device: the workspace is keyed by its index,
    which a bare ``torch.device("cuda")`` lacks."""
    if device.type == "cuda" and device.index is None:
        raise ValueError("workspace_tensors needs an indexed CUDA device "
                         "(a tensor's .device), got 'cuda'")
    return tuple(t for t in _WORKSPACE.get((device.index, stream), ())
                 if t is not None)


# C entry points: library, pointer arguments, then int ones, then the
# stream.
_SIGNATURES = {"fused_mm1_launch": ("fused_mm1", 7, 9),
               "fused_mm1_grouped_launch": ("fused_mm1", 8, 12),
               "fused_split_launch": ("fused_split", 7, 14),
               "fused_split_grouped_launch": ("fused_split", 8, 17)}


def _kernel(entry: str):
    """A C entry point of its built library, with its signature."""
    lib, n_ptr, n_int = _SIGNATURES[entry]
    return build.entry(lib, entry, n_ptr, n_int)


def fused_gemm_reference(a: torch.Tensor, b: torch.Tensor,
                         sx: Optional[torch.Tensor],
                         sw: Optional[torch.Tensor], *, mode: str, h: int,
                         z: int, kp: int, combine_int32: bool,
                         out_dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device), on (M, K) x (K, N)
    or, batched over leading dimensions, on (E, M, K) x (E, K, N).

    Digit products run as float64 matmuls, which are exact here: every
    digit entering a product is below 2^8 in magnitude (kmm4's nested
    pre-adder reaches 189 at w = 26), so every partial sum is an integer
    below K * 2^16 << 2^53.  Digit products and the row and column sums are
    then taken modulo 2^32, as the reference's int32 scratch holds them.
    The epilogue repeats the kernel's fp32 operation order one rounded op
    at a time.
    """
    k_dim = a.shape[-1]
    a = a.to(torch.int64)
    b = b.to(torch.int64)

    def dot(x, y):
        return _wrap_int32(torch.matmul(x.to(torch.float64),
                                        y.to(torch.float64)).to(torch.int64))

    if mode == "mm1":
        val = dot(a, b)
    else:
        pad = kp - k_dim
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        mask = (1 << h) - 1
        a1, a0 = a >> h, (a & mask) - z
        b1, b0 = b >> h, (b & mask) - z
        if mode == "kmm2":
            accs = [dot(a1, b1), dot(a1 + a0, b1 + b0), dot(a0, b0)]
        elif mode == "mm2":
            accs = [dot(a1, b1), dot(a1, b0), dot(a0, b1), dot(a0, b0)]
        else:                   # kmm4: plain re-split of each branch at h2
            h2 = -(-(h + 1) // 2)
            mask2 = (1 << h2) - 1
            accs = []
            for av, bv in ((a1, b1), (a1 + a0, b1 + b0), (a0, b0)):
                av1, av0 = av >> h2, av & mask2
                bv1, bv0 = bv >> h2, bv & mask2
                accs += [dot(av1, bv1), dot(av1 + av0, bv1 + bv0),
                         dot(av0, bv0)]
        row = _wrap_int32(a.sum(dim=-1, keepdim=True) - kp * z)
        col = _wrap_int32(b.sum(dim=-2, keepdim=True) - kp * z)
        if combine_int32:
            val = _wrap_int32(_combine_int(mode, accs, h)
                              + (z * row.to(torch.int64)
                                 + z * col.to(torch.int64) + z * z * kp))
        else:
            f32 = torch.float32
            core = _combine_f32(mode, accs, h)
            corr = ((row.to(f32) * float(z) + col.to(f32) * float(z))
                    + float(z) * float(z) * float(kp))
            val = core + corr
    if sx is not None:
        val = val.to(torch.float32) * (sx * sw)
    if out_dtype == torch.int32:
        return val
    return val.to(out_dtype)


def _kmm2_f32(c1, cs, c0, h: int):
    """Fig. 9 post-adder in fp32, the reference's ``_combine_kmm2`` order on
    int32 digit products (and ``_combine_kmm2_wide``'s on fp32 branch
    values, for which the casts are no-ops)."""
    c1, cs, c0 = (c.to(torch.float32) for c in (c1, cs, c0))
    mid = (cs - c1) - c0
    return (c1 * float(2 ** (2 * h)) + mid * float(2 ** h)) + c0


def _combine_f32(mode: str, accs, h: int) -> torch.Tensor:
    """The mode's fp32 combine of its int32 digit products."""
    if mode == "kmm2":
        return _kmm2_f32(*accs, h)
    if mode == "mm2":
        c1, c10, c01, c0 = (c.to(torch.float32) for c in accs)
        mid = c10 + c01
        return (c1 * float(2 ** (2 * h)) + mid * float(2 ** h)) + c0
    h2 = -(-(h + 1) // 2)
    branches = [_kmm2_f32(*accs[i:i + 3], h2) for i in (0, 3, 6)]
    return _kmm2_f32(*branches, h)


def _combine_int(mode: str, accs, h: int) -> torch.Tensor:
    """The mode's int32-ring combine (int64 values, wrapped per level)."""
    def kmm2(c1, cs, c0, shift):
        c1, cs, c0 = (c.to(torch.int64) for c in (c1, cs, c0))
        return _wrap_int32((c1 << (2 * shift)) + ((cs - c1 - c0) << shift)
                           + c0).to(torch.int64)

    if mode == "kmm2":
        return kmm2(*accs, h)
    if mode == "mm2":
        c1, c10, c01, c0 = (c.to(torch.int64) for c in accs)
        return (c1 << (2 * h)) + ((c10 + c01) << h) + c0
    h2 = -(-(h + 1) // 2)
    return kmm2(*(kmm2(*accs[i:i + 3], h2) for i in (0, 3, 6)), h)


def fused_gemm_grouped_reference(a: torch.Tensor, b: torch.Tensor,
                                 sx: Optional[torch.Tensor],
                                 sw: Optional[torch.Tensor],
                                 counts: Optional[torch.Tensor], *,
                                 seg: Optional[int], **kw) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel (any device): the
    batched :func:`fused_gemm_reference`, dead rows set to exact zeros."""
    out = fused_gemm_reference(a, b, sx, sw, **kw)
    if counts is None:
        return out
    live = ragged_row_mask(counts, seg, out.shape[1])
    return torch.where(live, out, torch.zeros_like(out))


def ragged_row_mask(counts: torch.Tensor, seg: int,
                    c_dim: int) -> torch.Tensor:
    """(E, C, 1) liveness of capacity-bucketed expert rows: row ``r`` is
    live iff ``r // seg < S`` and ``r % seg < counts[e, r // seg]`` — the
    predicate the kernel evaluates per row (port of
    ``repro.quant.qmatmul._ragged_row_mask``)."""
    rows = torch.arange(c_dim, device=counts.device)
    seg_ids = rows // seg
    n_seg = counts.shape[-1]
    limit = counts.to(torch.int64)[:, seg_ids.clamp(0, n_seg - 1)]   # (E, C)
    live = (rows - seg_ids * seg < limit) & (seg_ids < n_seg)
    return live[..., None]


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the int32 ring the kernel computes in)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
