"""Mamba selective scan (``csrc/ssm_scan.cu``), port-only.

The reference runs the recurrence as jnp ops: a chunked associative scan
and an einsum over the state (``repro.models.ssm.mamba_apply_stateful``),
and one update in ``mamba_decode``.  Their fp32 order depends on how the
sequence is cut, and ATen's reductions pick their algorithm by the row
count, so the port runs a sequential recurrence whose order is fixed: per
(row, channel) and step t, each fp32 operation separately rounded,

    da[s] = exp(delta_t a[s]);  h[s] = da[s] h[s] + (delta_t x_t) b_t[s]
    y_t = sum_s h[s] c_t[s] (s in order);  y_t += x_t d_skip;  y_t *= silu(z_t)

with the state frozen where ``mask`` is false.  Prefill in chunks, a
single-shot prefill and decode (S = 1) then give the same state bit for
bit.

:func:`ssm_scan` launches the kernel on CUDA tensors or raises; on CPU
tensors it runs :func:`ssm_scan_reference`, the same order in PyTorch,
which the tests hold to the reference.  The kernel agrees with it to fp32
rounding (``expf`` and the division in SiLU are not ATen's), not bit for
bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# State sizes the kernel is instantiated for (the configs use 8 and 16).
SUPPORTED_DS = (4, 8, 16)

# Launches of the CUDA kernel; the wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"ssm_scan": 0}


def reset_launches() -> None:
    launches["ssm_scan"] = 0


def ssm_scan_reference(x, delta, b, c, z, a, d_skip, h,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's order in PyTorch, a loop over t and the
    sum over s as an explicit loop.  Returns (y (B, S, di) fp32, the final
    state (B, di, ds)); ``h`` is not written."""
    f32 = torch.float32
    ds = a.shape[1]
    ys = []
    for t in range(x.shape[1]):
        dt, xt = delta[:, t, :, None], x[:, t]
        da = torch.exp(dt * a)                               # (B, di, ds)
        dbx = (delta[:, t] * xt)[..., None] * b[:, t, None, :]
        if mask is not None:
            m = mask[:, t, None, None]
            da = torch.where(m, da, torch.ones_like(da))
            dbx = torch.where(m, dbx, torch.zeros_like(dbx))
        h = da * h + dbx
        ct = c[:, t]
        y = h[..., 0] * ct[:, None, 0]
        for s in range(1, ds):
            y = y + h[..., s] * ct[:, None, s]
        y = y + xt * d_skip
        ys.append(y * F.silu(z[:, t].to(f32)))
    return torch.stack(ys, dim=1), h


def _check(x, delta, b, c, z, a, d_skip, h, mask) -> None:
    """fp32 x, delta (B, S, di) and b, c (B, S, ds), z (B, S, di) fp32 or
    bf16, each with its last axis contiguous; contiguous fp32 a (di, ds),
    d_skip (di,) and h (B, di, ds); mask (B, S) bool or None; ds
    supported; all on one cpu or cuda device (the contract is the kernel's
    on both devices)."""
    if x.dim() != 3:
        raise ValueError(f"ssm_scan: x must be (B, S, di), got "
                         f"{tuple(x.shape)}")
    bsz, s, di = x.shape
    ds = a.shape[-1] if a.dim() == 2 else -1
    if ds not in SUPPORTED_DS:
        raise ValueError(f"ssm_scan: d_state {ds} not in {SUPPORTED_DS}")
    want = {"x": (x, (bsz, s, di)), "delta": (delta, (bsz, s, di)),
            "b": (b, (bsz, s, ds)), "c": (c, (bsz, s, ds)),
            "z": (z, (bsz, s, di)), "a": (a, (di, ds)),
            "d_skip": (d_skip, (di,)), "h": (h, (bsz, di, ds))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32 and not (
                name == "z" and t.dtype == torch.bfloat16):
            raise TypeError(f"ssm_scan: {name} must be float32"
                            + (" or bfloat16" if name == "z" else "")
                            + f", got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name}'s last axis must be "
                             f"contiguous, got strides {t.stride()}")
    for name in ("a", "d_skip", "h"):
        if not want[name][0].is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    if s < 1:
        raise ValueError("ssm_scan: need at least one time step")
    tensors = [t for t, _ in want.values()]
    if mask is not None:
        if tuple(mask.shape) != (bsz, s) or mask.dtype != torch.bool:
            raise ValueError(f"ssm_scan: mask must be bool (B, S) = "
                             f"{(bsz, s)}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        tensors.append(mask)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or devices.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: operands on one cpu or cuda device, "
                         f"got {[t.device for t in tensors]}")


def _launch(x, delta, b, c, z, a, d_skip, h, mask) -> torch.Tensor:
    """One launch of the CUDA kernel on operands that passed
    :func:`_check`; returns y (B, S, di) fp32 and leaves the final state
    in ``h``."""
    bsz, s, di = x.shape
    strides = [t.stride(i) for t in (x, delta, z, b, c) for i in (0, 1)]
    if bsz > 65535 or max(strides + [s * di]) >= 2 ** 31:
        raise ValueError("ssm_scan: sizes and strides must fit the "
                         "kernel's int arguments")
    if mask is not None:
        mask = mask.contiguous()
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    fn = build.entry("ssm_scan", "ssm_scan_launch", 10, 15)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), delta.data_ptr(), b.data_ptr(), c.data_ptr(),
                 z.data_ptr(), a.data_ptr(), d_skip.data_ptr(), h.data_ptr(),
                 mask.data_ptr() if mask is not None else None, y.data_ptr(),
                 bsz, s, di, a.shape[1], int(z.dtype == torch.bfloat16),
                 *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err}")
    launches["ssm_scan"] += 1
    return y


def ssm_scan(x: torch.Tensor, delta: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, z: torch.Tensor, a: torch.Tensor,
             d_skip: torch.Tensor, h: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The selective scan from the state ``h`` (B, di, ds), which is
    updated in place to the final state; returns y (B, S, di) fp32, SiLU
    gate applied.  ``a`` is ``-exp(a_log)``; ``mask`` (B, S) freezes the
    state on false steps."""
    _check(x, delta, b, c, z, a, d_skip, h, mask)
    if x.device.type == "cpu":
        y, state = ssm_scan_reference(x, delta, b, c, z, a, d_skip, h, mask)
        h.copy_(state)
        return y
    return _launch(x, delta, b, c, z, a, d_skip, h, mask)
