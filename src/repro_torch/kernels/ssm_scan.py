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
bit.  It is forward only: on CUDA it raises where autograd would record
it (the kernel's output, filled through ctypes, has no ``grad_fn``).

Training runs :func:`ssm_scan_train`: from a zero state, no mask, writing
no state, and where autograd records a ``torch.autograd.Function`` whose
backward is the kernel ``ssm_scan_bwd_launch`` (port-only, as the forward)
with :func:`ssm_scan_vjp_reference`, an explicit reverse sweep, as its
plain version.  It gives dx, d(delta), db, dc, dz (in z's dtype), da (for
``a``; the model's ``a = -exp(a_log)`` is differentiated by autograd) and
d(d_skip).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, check_grad_fn, records_grad

# State sizes the kernel is instantiated for (the configs use 8 and 16).
SUPPORTED_DS = (4, 8, 16)

# Launches of the CUDA kernel; the wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"ssm_scan": 0, "ssm_scan_bwd": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


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


def ssm_scan_vjp_reference(x, delta, b, c, z, a, d_skip, dy):
    """Plain version of the backward: (dx, d delta, db, dc, dz, da,
    d d_skip) of ``y = ssm_scan_reference(x, delta, b, c, z, a, d_skip,
    0)[0]`` for the cotangent ``dy``, by an explicit reverse sweep over the
    states of a forward one.  With y'_t = sum_s h_t[s] c_t[s] + x_t d_skip,
    g_t = dy_t silu(z_t) and G_t = dL/dh_t (``gh`` the part from later
    steps):

        G_t = gh + g_t c_t;  gh <- exp(delta_t a) G_t
        dz_t = dy_t y'_t silu'(z_t);  dc_t = sum_d g_t h_t
        dx_t = sum_s G_t delta_t b_t + g_t d_skip
        db_t = sum_d G_t delta_t x_t
        d delta_t = sum_s G_t (a exp(delta_t a) h_{t-1} + x_t b_t)
        da = sum_{b, t} G_t exp(delta_t a) h_{t-1} delta_t
        d d_skip = sum_{b, t} g_t x_t"""
    f32 = torch.float32
    bsz, s, di = x.shape
    zf = z.to(f32)
    sig = torch.sigmoid(zf)
    states = [x.new_zeros((bsz, di, a.shape[1]))]
    for t in range(s):
        da = torch.exp(delta[:, t, :, None] * a)
        states.append(da * states[-1] + (delta[:, t] * x[:, t])[..., None]
                      * b[:, t, None, :])
    gh = torch.zeros_like(states[0])
    da_sum = torch.zeros_like(a)
    dd_sum = torch.zeros_like(d_skip)
    grads = [[None] * s for _ in range(5)]
    for t in reversed(range(s)):
        xt, dt, bt, ct = x[:, t], delta[:, t], b[:, t, None, :], c[:, t]
        h, prev = states[t + 1], states[t]
        yp = (h * ct[:, None, :]).sum(-1) + xt * d_skip
        g = dy[:, t] * zf[:, t] * sig[:, t]
        grads[4][t] = (dy[:, t] * yp * sig[:, t]
                       * (1 + zf[:, t] * (1 - sig[:, t])))
        big = gh + g[..., None] * ct[:, None, :]
        decay = torch.exp(dt[..., None] * a)
        q = big * prev * decay
        grads[0][t] = (big * bt).sum(-1) * dt + g * d_skip
        grads[1][t] = (q * a).sum(-1) + (big * bt).sum(-1) * xt
        grads[2][t] = (big * (dt * xt)[..., None]).sum(1)
        grads[3][t] = (g[..., None] * h).sum(1)
        da_sum = da_sum + (q * dt[..., None]).sum(0)
        dd_sum = dd_sum + (g * xt).sum(0)
        gh = decay * big
    dx, ddelta, db, dc, dz = (torch.stack(gr, dim=1) for gr in grads)
    return dx, ddelta, db, dc, dz.to(z.dtype), da_sum, dd_sum


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


def _bwd_launch(x, delta, b, c, z, a, d_skip, dy):
    """One launch of the backward kernel on operands that passed
    :func:`_check` (no mask; dy contiguous (B, S, di) fp32); returns the
    gradients in :func:`ssm_scan_vjp_reference`'s order.  The kernel
    re-runs the forward from a zero state, writing every h_t to a scratch
    of B S di DS floats (freed on return), then sweeps t backwards; db and
    dc come back as one partial sum per block of channels (as many as the
    source's ``ssm_scan_bwd_parts`` says), da and d_skip as one per batch
    row, summed here in a fixed order (no float atomics: a run repeats
    itself bit for bit)."""
    bsz, s, di = x.shape
    ds = a.shape[1]
    strides = [t.stride(i) for t in (x, delta, z, b, c) for i in (0, 1)]
    if bsz > 65535 or max(strides + [s * di]) >= 2 ** 31:
        raise ValueError("ssm_scan_bwd: sizes and strides must fit the "
                         "kernel's int arguments")
    f32, dev = torch.float32, x.device
    nbd = build.ask("ssm_scan", "ssm_scan_bwd_parts", di)
    hs = torch.empty((bsz, s, ds, di), dtype=f32, device=dev)
    dx = torch.empty((bsz, s, di), dtype=f32, device=dev)
    ddelta = torch.empty_like(dx)
    dz = torch.empty((bsz, s, di), dtype=z.dtype, device=dev)
    dbc = torch.empty((2, nbd, bsz, s, ds), dtype=f32, device=dev)
    da = torch.empty((bsz, di, ds), dtype=f32, device=dev)
    dd = torch.empty((bsz, di), dtype=f32, device=dev)
    fn = build.entry("ssm_scan", "ssm_scan_bwd_launch", 16, 15)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), delta.data_ptr(), b.data_ptr(), c.data_ptr(),
                 z.data_ptr(), a.data_ptr(), d_skip.data_ptr(), dy.data_ptr(),
                 hs.data_ptr(), dx.data_ptr(), ddelta.data_ptr(),
                 dbc[0].data_ptr(), dbc[1].data_ptr(), dz.data_ptr(),
                 da.data_ptr(), dd.data_ptr(), bsz, s, di, ds,
                 int(z.dtype == torch.bfloat16), *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd launch failed: CUDA error {err}")
    launches["ssm_scan_bwd"] += 1
    db, dc = dbc.sum(1)
    return dx, ddelta, db, dc, dz, da.sum(0), dd.sum(0)


def _train_forward(x, delta, b, c, z, a, d_skip) -> torch.Tensor:
    """y of the scan from a zero state, the state dropped: the kernel on
    CUDA tensors, the plain version on CPU ones."""
    h = x.new_zeros((x.shape[0], x.shape[2], a.shape[1]))
    if x.device.type == "cpu":
        return ssm_scan_reference(x, delta, b, c, z, a, d_skip, h)[0]
    return _launch(x, delta, b, c, z, a, d_skip, h, None)


def _train_backward(x, delta, b, c, z, a, d_skip, dy):
    if x.device.type == "cpu":
        return ssm_scan_vjp_reference(x, delta, b, c, z, a, d_skip, dy)
    return _bwd_launch(x, delta, b, c, z, a, d_skip, dy.contiguous())


class _ScanFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, b, c, z, a, d_skip):
        ctx.save_for_backward(x, delta, b, c, z, a, d_skip)
        return _train_forward(x, delta, b, c, z, a, d_skip)

    @staticmethod
    def backward(ctx, dy):
        return _train_backward(*ctx.saved_tensors, dy)


def ssm_scan_train(x: torch.Tensor, delta: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, z: torch.Tensor, a: torch.Tensor,
                   d_skip: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training's scan: :func:`ssm_scan`'s operands from a zero state;
    returns y (B, S, di) fp32 and writes no state.  Training has no pad
    mask, so a mask is refused.  Where autograd records, differentiable in
    every operand through :class:`_ScanFunction` (the backward kernel on
    CUDA, :func:`ssm_scan_vjp_reference` on the CPU)."""
    if mask is not None:
        raise ValueError("ssm_scan_train: training has no pad mask")
    bsz, _, di = x.shape
    _check(x, delta, b, c, z, a, d_skip,
           x.new_empty((bsz, di, a.shape[-1])), None)
    if not records_grad(x, delta, b, c, z, a, d_skip):
        return _train_forward(x, delta, b, c, z, a, d_skip)
    return check_grad_fn(_ScanFunction.apply(x, delta, b, c, z, a, d_skip),
                         "ssm_scan_train")


def ssm_scan(x: torch.Tensor, delta: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, z: torch.Tensor, a: torch.Tensor,
             d_skip: torch.Tensor, h: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The selective scan from the state ``h`` (B, di, ds), which is
    updated in place to the final state; returns y (B, S, di) fp32, SiLU
    gate applied.  ``a`` is ``-exp(a_log)``; ``mask`` (B, S) freezes the
    state on false steps."""
    _check(x, delta, b, c, z, a, d_skip, h, mask)
    if x.device.type == "cuda" and records_grad(x, delta, b, c, z, a,
                                                d_skip, h):
        raise RuntimeError("ssm_scan is forward only on CUDA (its output "
                           "carries no grad_fn): train through "
                           "ssm_scan_train")
    if x.device.type == "cpu":
        y, state = ssm_scan_reference(x, delta, b, c, z, a, d_skip, h, mask)
        h.copy_(state)
        return y
    return _launch(x, delta, b, c, z, a, d_skip, h, mask)
