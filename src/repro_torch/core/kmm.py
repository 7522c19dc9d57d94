"""Karatsuba matrix multiplication (KMM): tensor forms of the paper's
Algorithms 1-4 on PyTorch integer tensors (port of ``repro.core.kmm``).

  * ``sm_n``   — Algorithm 1, conventional n-digit scalar multiplication
                 (elementwise);
  * ``ksm_n``  — Algorithm 2, n-digit Karatsuba scalar multiplication
                 (elementwise);
  * ``mm_n``   — Algorithm 3, conventional n-digit matrix multiplication
                 (4 digit-plane products a level);
  * ``kmm_n``  — Algorithm 4, n-digit Karatsuba matrix multiplication
                 (3 digit-plane products a level);
  * ``ksmm``   — KSM inside a conventional matmul (the KSMM baseline).

The digit convention is the reference's, not the fused kernel's centered
one: a ``w``-bit integer splits at ``h = ceil(w/2)`` into
``x = x1 * 2**h + x0`` with ``x0`` the unsigned low ``h`` bits and ``x1``
the arithmetically shifted (signed) rest, exact in two's complement.

The leaf product (``MM_1``, lines 15/16 of Algorithms 3/4) is the exact
integer product reduced modulo 2^32, the int32 that XLA's
``dot_general(..., preferred_element_type=int32)`` gives: on the CPU an
int64 ``torch.matmul``; on the card (ATen has no integer matmul on CUDA) a
float64 ``torch.matmul``, exact while ``K * 2**(2 * bits) <= 2**53``, where
every operand of a level of width ``w`` is at most ``2**w`` in magnitude
(the digit widths the recursion passes down).  A leaf outside that bound
raises.  The leaf is injectable (``mm1=``): a hook takes ``(a, b,
dimension_numbers, *, bits)``.  With ``combine_dtype=torch.float32`` each
leaf is cast to fp32 before the shift-combine, which runs in the
reference's order: ``c1 * 2**(2h)``, then ``+ (cs - c1 - c0) * 2**h``,
then ``+ c0``.

Dimension numbers are ``dot_general``'s: ``((lhs_contract, rhs_contract),
(lhs_batch, rhs_batch))``; the output holds the batch dimensions, then
the lhs free ones, then the rhs free ones.

The bounds of the integer GEMM (``max_exact_k`` and the accumulator
headroom of a plan) live here too.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.dispatch import ExecPlan

Dims = Tuple[Tuple[Sequence[int], Sequence[int]],
             Tuple[Sequence[int], Sequence[int]]]
Mm1Fn = Callable[..., torch.Tensor]

# Canonical dimension numbers for a plain (M, K) x (K, N) matmul.
MATMUL_DIMS: Dims = (((1,), (0,)), ((), ()))

# A float64 sum of integer products is exact while every partial sum is.
_F64_EXACT = 1 << 53


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the int32 ring XLA's dot computes in)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _dtype_bits(dtype: torch.dtype) -> int:
    """A magnitude bound (bits) of any value of an integer dtype."""
    return {torch.int8: 7, torch.uint8: 8, torch.int16: 15,
            torch.int32: 31}.get(dtype, 63)


def exact_dot(a: torch.Tensor, b: torch.Tensor, *,
              bits: Optional[int] = None,
              accum_dtype=torch.int32) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) integer product, exact, then reduced to
    ``accum_dtype`` (int32: modulo 2^32).  ``bits`` bounds every operand's
    magnitude by ``2**bits`` (default: the dtypes' own range); on the card
    the float64 product must stay exact for that bound, or this raises."""
    if a.device.type == "cpu":
        out = torch.matmul(a.to(torch.int64), b.to(torch.int64))
    else:
        k = a.shape[-1]
        ab = bits if bits is not None else _dtype_bits(a.dtype)
        bb = bits if bits is not None else _dtype_bits(b.dtype)
        if k * (1 << (ab + bb)) > _F64_EXACT:
            raise ValueError(
                f"leaf product outside the float64 bound: K={k} operands "
                f"of {ab} and {bb} bits need K * 2^{ab + bb} <= 2^53")
        out = torch.matmul(a.to(torch.float64),
                           b.to(torch.float64)).to(torch.int64)
    if accum_dtype == torch.int32:
        return _wrap_int32(out)
    if accum_dtype == torch.int64:
        return out
    raise ValueError(f"integer accumulation is int32 or int64, not "
                     f"{accum_dtype}")


def dot_general(a: torch.Tensor, b: torch.Tensor, dims: Dims,
                product: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """``lax.dot_general`` layout on top of a batched (B, M, K) x (B, K, N)
    ``product``: batch dims, then lhs free dims, then rhs free dims."""
    lc, rc, lb, rb = (tuple(x) for x in (*dims[0], *dims[1]))
    lf = [i for i in range(a.dim()) if i not in lc and i not in lb]
    rf = [i for i in range(b.dim()) if i not in rc and i not in rb]
    bshape = [a.shape[i] for i in lb]
    mshape = [a.shape[i] for i in lf]
    nshape = [b.shape[i] for i in rf]
    k = math.prod(a.shape[i] for i in lc)
    a3 = a.permute(*lb, *lf, *lc).reshape(math.prod(bshape),
                                          math.prod(mshape), k)
    b3 = b.permute(*rb, *rc, *rf).reshape(math.prod(bshape), k,
                                          math.prod(nshape))
    return product(a3, b3).reshape(*bshape, *mshape, *nshape)


def default_mm1(accum_dtype=torch.int32) -> Mm1Fn:
    """The base-case MM_1: one ``dot_general`` with exact integer
    accumulation (:func:`exact_dot`)."""

    def mm1(a: torch.Tensor, b: torch.Tensor, dims: Dims, *,
            bits: Optional[int] = None) -> torch.Tensor:
        return dot_general(a, b, dims, lambda x, y: exact_dot(
            x, y, bits=bits, accum_dtype=accum_dtype))

    return mm1


def digit_split(x: torch.Tensor, h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split integers into (high, low) digits at bit ``h``: ``low`` the
    unsigned low ``h`` bits, ``high`` the arithmetically shifted rest, so
    ``x == (high << h) + low`` in two's complement."""
    if h <= 0:
        raise ValueError(f"digit width must be positive, got {h}")
    return x >> h, x & ((1 << h) - 1)


def _shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    if not x.dtype.is_floating_point:
        return x << s
    return x * float(2.0 ** s)


def _split_widths(w: int) -> Tuple[int, int, int]:
    """(w_hi, w_lo, h): bit widths of the high and low digits and the
    split point."""
    h = -(-w // 2)
    return w - h, h, h


def _check_n(n: int) -> None:
    if n < 1 or (n & (n - 1)) != 0:
        raise ValueError(f"digit count n must be a positive power of two, "
                         f"got {n}")


# ---------------------------------------------------------------------------
# Algorithms 1 / 2: scalar (elementwise) n-digit multiplication.
# ---------------------------------------------------------------------------


def sm_n(a: torch.Tensor, b: torch.Tensor, *, w: int, n: int
         ) -> torch.Tensor:
    """Algorithm 1: conventional n-digit scalar multiplication,
    elementwise."""
    _check_n(n)
    if n == 1:
        return a * b
    w_hi, w_lo, h = _split_widths(w)
    a1, a0 = digit_split(a, h)
    b1, b0 = digit_split(b, h)
    c1 = sm_n(a1, b1, w=max(w_hi, 1), n=n // 2)
    c10 = sm_n(a1, b0, w=w_lo, n=n // 2)
    c01 = sm_n(a0, b1, w=w_lo, n=n // 2)
    c0 = sm_n(a0, b0, w=w_lo, n=n // 2)
    c = _shift_left(c1, 2 * h)
    c = c + _shift_left(c10 + c01, h)
    return c + c0


def ksm_n(a: torch.Tensor, b: torch.Tensor, *, w: int, n: int
          ) -> torch.Tensor:
    """Algorithm 2: n-digit Karatsuba scalar multiplication,
    elementwise."""
    _check_n(n)
    if n == 1:
        return a * b
    w_hi, w_lo, h = _split_widths(w)
    a1, a0 = digit_split(a, h)
    b1, b0 = digit_split(b, h)
    c1 = ksm_n(a1, b1, w=max(w_hi, 1), n=n // 2)
    cs = ksm_n(a1 + a0, b1 + b0, w=w_lo + 1, n=n // 2)
    c0 = ksm_n(a0, b0, w=w_lo, n=n // 2)
    c = _shift_left(c1, 2 * h)
    c = c + _shift_left(cs - c1 - c0, h)
    return c + c0


# ---------------------------------------------------------------------------
# Algorithms 3 / 4: n-digit matrix multiplication.
# ---------------------------------------------------------------------------


def _leaf(mm1: Mm1Fn, a, b, dims: Dims, w: int, combine_dtype):
    out = mm1(a, b, dims, bits=w)
    return out if combine_dtype is None else out.to(combine_dtype)


def mm_n(a: torch.Tensor, b: torch.Tensor, *, w: int, n: int,
         dimension_numbers: Dims = MATMUL_DIMS,
         mm1: Optional[Mm1Fn] = None, combine_dtype=None) -> torch.Tensor:
    """Algorithm 3: conventional n-digit matrix multiplication (4
    products a level)."""
    _check_n(n)
    mm1 = mm1 or default_mm1()
    if n == 1:
        return _leaf(mm1, a, b, dimension_numbers, w, combine_dtype)
    w_hi, w_lo, h = _split_widths(w)
    a1, a0 = digit_split(a, h)
    b1, b0 = digit_split(b, h)
    kw = dict(dimension_numbers=dimension_numbers, mm1=mm1,
              combine_dtype=combine_dtype)
    c1 = mm_n(a1, b1, w=max(w_hi, 1), n=n // 2, **kw)
    c10 = mm_n(a1, b0, w=w_lo, n=n // 2, **kw)
    c01 = mm_n(a0, b1, w=w_lo, n=n // 2, **kw)
    c0 = mm_n(a0, b0, w=w_lo, n=n // 2, **kw)
    c = _shift_left(c1, 2 * h)
    c = c + _shift_left(c10 + c01, h)
    return c + c0


def kmm_n(a: torch.Tensor, b: torch.Tensor, *, w: int, n: int,
          dimension_numbers: Dims = MATMUL_DIMS,
          mm1: Optional[Mm1Fn] = None, combine_dtype=None) -> torch.Tensor:
    """Algorithm 4: n-digit Karatsuba matrix multiplication (3 products a
    level).  ``combine_dtype`` (optional) casts each digit-plane product
    before the shift-combine: the quantized path passes ``torch.float32``,
    every leaf an exact int32 and only the recombination in fp32."""
    _check_n(n)
    mm1 = mm1 or default_mm1()
    if n == 1:
        return _leaf(mm1, a, b, dimension_numbers, w, combine_dtype)
    w_hi, w_lo, h = _split_widths(w)
    a1, a0 = digit_split(a, h)
    b1, b0 = digit_split(b, h)
    kw = dict(dimension_numbers=dimension_numbers, mm1=mm1,
              combine_dtype=combine_dtype)
    c1 = kmm_n(a1, b1, w=max(w_hi, 1), n=n // 2, **kw)
    cs = kmm_n(a1 + a0, b1 + b0, w=w_lo + 1, n=n // 2, **kw)
    c0 = kmm_n(a0, b0, w=w_lo, n=n // 2, **kw)
    c = _shift_left(c1, 2 * h)
    c = c + _shift_left(cs - c1 - c0, h)
    return c + c0


def ksmm(a: torch.Tensor, b: torch.Tensor, *, w: int, n: int
         ) -> torch.Tensor:
    """KSMM baseline: a conventional matmul with KSM per scalar product.
    Materializes the (M, K, N) products: small shapes only."""
    prod = ksm_n(a[..., :, :, None], b[..., None, :, :], w=w, n=n)
    out = prod.sum(dim=-2)
    return _wrap_int32(out) if prod.dtype == torch.int32 else \
        out.to(prod.dtype)


def matmul_dims_for(lhs_ndim: int, rhs_ndim: int) -> Dims:
    """Dimension numbers contracting lhs[-1] with rhs[-2]; no batch dims."""
    return (((lhs_ndim - 1,), (rhs_ndim - 2,)), ((), ()))


def kmm_matmul(a: torch.Tensor, b: torch.Tensor, w: int, n: int = 2,
               combine_dtype=None) -> torch.Tensor:
    """KMM on stacked matrices: a[..., M, K] @ b[K, N], or with b[..., K, N]
    the leading dimensions matched as batch."""
    if b.dim() == 2:
        dims = matmul_dims_for(a.dim(), 2)
    else:
        nbatch = b.dim() - 2
        dims = (((a.dim() - 1,), (nbatch,)),
                (tuple(range(nbatch)), tuple(range(nbatch))))
    return kmm_n(a, b, w=w, n=n, dimension_numbers=dims,
                 combine_dtype=combine_dtype)


# ---------------------------------------------------------------------------
# Exactness bounds.
# ---------------------------------------------------------------------------


def max_exact_k(w: int, carrier_bits: int = 31) -> int:
    """Largest K for which a w-bit product sum is exact in int32: the
    recombined value ``K * (2**w - 1)**2`` must fit, so
    ``K <= 2**(carrier_bits - 2w)`` (a power-of-two under-approximation)."""
    head = carrier_bits - 2 * w
    return max(1 << head, 1) if head > 0 else 0


def leaf_mag_bits(mode: str, w: int) -> int:
    """ceil(log2) bound on the largest digit magnitude entering a product
    pass: kmm2 pre-adder 2^h, mm2 digits 2^(h-1), kmm4 nested leaves."""
    h = -(-w // 2)
    if mode == "kmm2":
        return h
    if mode == "mm2":
        return max(h - 1, 1)
    if mode == "kmm4":
        w1 = h + 1
        h2 = -(-w1 // 2)
        mag = (1 << max(w1 - h2 - 1, 0)) + (1 << h2)
        return max(mag.bit_length(), 1)
    raise ValueError(f"no digit magnitude for mode {mode!r}")


def digit_accum_k_bound(w: int) -> int:
    """Largest padded K for which each KMM2 digit-plane product accumulates
    exactly in int32 (digit magnitudes ~ 2**(w/2): K up to 2**(31 - w - 2))."""
    head = 31 - w - 2
    return 1 << head if head > 0 else 1


def plan_accum_k_bound(plan: ExecPlan) -> Optional[int]:
    """Per-digit int32 accumulator headroom of a plan: the largest padded K
    for which every digit accumulator stays exact.  None for the
    single-accumulator variants (mm1, xla_ref, ffip, the fused MM1 window),
    bounded by ``max_exact_k`` instead; for the strassen variants the
    composed full-problem bound (``tune.space.strassen_k_bound``)."""
    if plan.variant in ("mm1", "xla_ref", "ffip") or (
            plan.variant == "fused" and plan.w <= plan.m):
        return None
    if plan.variant in ("strassen", "strassen+kmm2"):
        from repro_torch.tune.space import strassen_k_bound  # tune -> core
        return strassen_k_bound(plan)
    if plan.variant in ("mm2", "fused_mm2"):
        mode = "mm2"
    elif plan.depth == 2:
        mode = "kmm4"
    else:
        return digit_accum_k_bound(plan.w)
    head = 30 - 2 * leaf_mag_bits(mode, plan.w)
    return 1 << head if head > 0 else 1
