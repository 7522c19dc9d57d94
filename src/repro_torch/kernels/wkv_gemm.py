"""RWKV6 WKV recurrence (port of ``repro.kernels.wkv_gemm``).

Per (batch row, head), with a D x D fp32 state S:
``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``, ``S_t = diag(w_t) S_{t-1} +
k_t^T v_t``.  Three entries over one hand-written Hopper source
(``csrc/wkv.cu``: a one-step kernel for decode, a chunked one for longer
sequences, chosen by S behind one C entry point, and a backward kernel):

  * :func:`wkv_apply` — the reference's signature: (BH, S, D) streams, a
    (BH, D) bonus, zero initial state, returns y.
  * :func:`wkv_stateful` — the model's layout: (B, S, H, D) streams, the
    (H, D) bonus, the state carried in (B, H, D, D) and the final state
    out (in place when the caller allows), which serving needs for decode.
  * :func:`wkv_train` — training's: the model's layout from a zero state,
    differentiable in r, k, v, w and u.  Where autograd records it runs as
    a ``torch.autograd.Function`` whose backward is the kernel
    ``wkv_bwd_launch`` (port-only: the TPU kernel has no backward, the
    reference differentiates its jnp scan), with :func:`wkv_vjp_reference`,
    an explicit reverse sweep, as its plain version.

On CUDA tensors every entry launches its kernel or raises; on CPU tensors
they run the plain versions beside them, :func:`wkv_reference` (the
reference's oracle) and :func:`wkv_stateful_reference` (the model's
per-step einsum).  The kernel keeps the state on chip for the whole
sequence, so ``chunk`` does not change the result; it is accepted for the
reference's signature.  :func:`wkv_stateful` and :func:`wkv_apply` are
forward only: on CUDA they raise where autograd would record them, since
the kernel's output, filled through ctypes, carries no ``grad_fn``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, check_grad_fn, records_grad

# Head sizes the kernel is instantiated for: the configs' (16 smoke, 64
# full width) and the reference tests' smaller ones.
SUPPORTED_D = (4, 8, 16, 64)

# Launches of the CUDA kernel; the wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"wkv": 0, "wkv_bwd": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def wkv_stateful_reference(r, k, v, w, u, state0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`wkv_stateful`: the model's step
    (``repro.models.rwkv``), one einsum a time step.  ``u`` is (H, D) or
    (B, H, D)."""
    b, s, h, d = r.shape
    ub = u.expand(b, h, d)[..., None]
    state = state0
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], state + ub * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def wkv_reference(r, k, v, w, u) -> torch.Tensor:
    """Plain version of :func:`wkv_apply` (the reference's oracle,
    ``wkv_gemm.py:82``): (BH, S, D) streams, (BH, D) bonus, zero state."""
    bh, _, d = r.shape
    y, _ = wkv_stateful_reference(
        r[:, :, None], k[:, :, None], v[:, :, None], w[:, :, None],
        u[:, None], r.new_zeros((bh, 1, d, d)))
    return y[:, :, 0]


def wkv_vjp_reference(r, k, v, w, u, dy):
    """Plain version of the backward: (dr, dk, dv, dw, du) of
    ``y = wkv_stateful_reference(r, k, v, w, u, 0)[0]`` for the cotangent
    ``dy``, by an explicit reverse sweep over the states of a forward one.
    With dS_t the gradient reaching S_t from later steps:

        dr_t[i] = sum_j dy_t[j] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
        dk_t[i] = sum_j v_t[j] (dS_t[i, j] + r_t[i] u[i] dy_t[j])
        dv_t[j] = sum_i k_t[i] (dS_t[i, j] + r_t[i] u[i] dy_t[j])
        dw_t[i] = sum_j dS_t[i, j] S_{t-1}[i, j]
        du[i] = sum_{b, t} r_t[i] k_t[i] sum_j dy_t[j] v_t[j]
        dS_{t-1} = w_t (.)rows dS_t + r_t dy_t^T

    Streams (B, S, H, D), ``u`` (H, D)."""
    b, s, h, d = r.shape
    state = r.new_zeros((b, h, d, d))
    states = []
    for t in range(s):
        states.append(state)
        state = (w[:, t, :, :, None] * state
                 + k[:, t, :, :, None] * v[:, t, :, None, :])
    ds = torch.zeros_like(state)
    ub = u[None]
    grads = [[None] * s for _ in range(4)]
    du = torch.zeros_like(u)
    for t in reversed(range(s)):
        rt, kt, vt, wt, gt = (x[:, t] for x in (r, k, v, w, dy))
        prev = states[t]
        ukv = (ub * kt)[..., :, None] * vt[..., None, :]
        e = ds + (rt * ub)[..., :, None] * gt[..., None, :]
        grads[0][t] = torch.einsum("bhij,bhj->bhi", prev + ukv, gt)
        grads[1][t] = torch.einsum("bhij,bhj->bhi", e, vt)
        grads[2][t] = torch.einsum("bhij,bhi->bhj", e, kt)
        grads[3][t] = (ds * prev).sum(-1)
        du = du + (rt * kt * (gt * vt).sum(-1, keepdim=True)).sum(0)
        ds = wt[..., :, None] * ds + rt[..., :, None] * gt[..., None, :]
    dr, dk, dv, dw = (torch.stack(g, dim=1) for g in grads)
    return dr, dk, dv, dw, du


def _check(name: str, streams, u: torch.Tensor,
           state0: Optional[torch.Tensor]) -> None:
    """fp32 (B, S, H, D) streams of one shape and strides, D contiguous
    and supported; u (H, D) or (B, H, D) with D contiguous; state0
    contiguous (B, H, D, D); all on one cpu or cuda device (the contract is
    the kernel's on both devices)."""
    r = streams[0]
    if r.dim() != 4 or any(t.shape != r.shape for t in streams):
        raise ValueError(f"{name}: need four (B, S, H, D) streams, got "
                         f"{[tuple(t.shape) for t in streams]}")
    b, s, h, d = r.shape
    if d not in SUPPORTED_D:
        raise ValueError(f"{name}: head size D={d} not in {SUPPORTED_D}")
    if s < 1:
        raise ValueError(f"{name}: need at least one time step")
    tensors = list(streams) + [u] + ([state0] if state0 is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: every operand must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.stride() != r.stride() for t in streams) or r.stride(3) != 1:
        raise ValueError(f"{name}: the streams must share strides with D "
                         f"contiguous, got {[t.stride() for t in streams]}")
    if u.shape not in ((h, d), (b, h, d)) or u.stride(-1) != 1:
        raise ValueError(f"{name}: u must be (H, D) or (B, H, D) with D "
                         f"contiguous, got {tuple(u.shape)} {u.stride()}")
    if state0 is not None and (state0.shape != (b, h, d, d)
                               or not state0.is_contiguous()):
        raise ValueError(f"{name}: state must be contiguous (B, H, D, D) = "
                         f"{(b, h, d, d)}, got {tuple(state0.shape)}")
    devices = {t.device for t in tensors}
    if len(devices) != 1 or devices.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: operands on one cpu or cuda device, got "
                         f"{[t.device for t in tensors]}")


def _launch(r, k, v, w, u, state0: Optional[torch.Tensor],
            state_out: Optional[torch.Tensor], kernel=None) -> torch.Tensor:
    """One launch of the CUDA kernel on operands that passed
    :func:`_check`; returns y (B, S, H, D), contiguous.  ``kernel`` is
    another build's ``wkv_launch`` with the same signature (the A/B of
    ``kernels.compare``; its launches are not counted)."""
    b, s, h, d = r.shape
    ub = u.expand(b, h, d)
    ints = list(r.stride()[:3]) + [ub.stride(0), ub.stride(1)]
    if max(b, h) > 65535 or max(ints) >= 2 ** 31:
        raise ValueError("wkv: sizes and strides must fit the kernel's "
                         "int arguments")
    y = torch.empty((b, s, h, d), dtype=torch.float32, device=r.device)
    ptr = (lambda t: t.data_ptr() if t is not None else None)  # noqa: E731
    fn = kernel or build.entry("wkv", "wkv_launch", 8, 9)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), ptr(state0), y.data_ptr(), ptr(state_out),
                 b, s, h, d, *ints, stream)
    if err != 0:
        raise RuntimeError(f"wkv launch failed: CUDA error {err}")
    if kernel is None:
        launches["wkv"] += 1
    return y


def _bwd_launch(r, k, v, w, u, dy):
    """One launch of the backward kernel on operands that passed
    :func:`_check` (u (H, D) contiguous, dy contiguous (B, S, H, D));
    returns (dr, dk, dv, dw, du).  The kernel re-runs the forward from a
    zero state, writing every S_{t-1} to a scratch of B H S D^2 floats
    (freed on return), then sweeps t backwards.  A block owns 16 columns
    of a head's state at D = 64 (the whole state below), so dr, dk and dw
    come back as one partial sum a column block (as many as the source's
    ``wkv_bwd_parts`` says) and du as one a column block and batch row,
    summed here in a fixed order (no float atomics: a run repeats itself
    bit for bit)."""
    b, s, h, d = r.shape
    ncb = build.ask("wkv", "wkv_bwd_parts", d)
    if max(b * h * ncb, max(r.stride()[:3])) >= 2 ** 31:
        raise ValueError("wkv_bwd: sizes and strides must fit the kernel's "
                         "int arguments")
    f32, dev = torch.float32, r.device
    states = torch.empty((b, h, s, d, d), dtype=f32, device=dev)
    parts = torch.empty((3, ncb, b, s, h, d), dtype=f32, device=dev)
    dv = torch.empty((b, s, h, d), dtype=f32, device=dev)
    du = torch.empty((ncb, b, h, d), dtype=f32, device=dev)
    fn = build.entry("wkv", "wkv_bwd_launch", 12, 7)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), dy.data_ptr(), states.data_ptr(),
                 parts[0].data_ptr(), parts[1].data_ptr(), dv.data_ptr(),
                 parts[2].data_ptr(), du.data_ptr(), b, s, h, d,
                 *r.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"wkv_bwd launch failed: CUDA error {err}")
    launches["wkv_bwd"] += 1
    dr, dk, dw = parts.sum(1) if ncb > 1 else parts[:, 0]
    return dr, dk, dv, dw, du.sum((0, 1))


def _train_forward(r, k, v, w, u) -> torch.Tensor:
    """y of the recurrence from a zero state: the kernel on CUDA tensors,
    the plain version on CPU ones."""
    if r.device.type == "cpu":
        b, _, h, d = r.shape
        return wkv_stateful_reference(r, k, v, w, u,
                                      r.new_zeros((b, h, d, d)))[0]
    return _launch(r, k, v, w, u, None, None)


def _train_backward(r, k, v, w, u, dy):
    if r.device.type == "cpu":
        return wkv_vjp_reference(r, k, v, w, u, dy)
    return _bwd_launch(r, k, v, w, u.contiguous(), dy.contiguous())


class _WKVFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _train_forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy):
        return _train_backward(*ctx.saved_tensors, dy)


def wkv_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Training's recurrence: (B, S, H, D) fp32 streams and the (H, D)
    bonus from a zero state; returns y (B, S, H, D).  Writes no state.
    Where autograd records, differentiable in every operand through
    :class:`_WKVFunction` (the backward kernel on CUDA,
    :func:`wkv_vjp_reference` on the CPU)."""
    _check("wkv_train", (r, k, v, w), u, None)
    if u.dim() != 2:
        raise ValueError(f"wkv_train: u must be (H, D), got "
                         f"{tuple(u.shape)}")
    if not records_grad(r, k, v, w, u):
        return _train_forward(r, k, v, w, u)
    return check_grad_fn(_WKVFunction.apply(r, k, v, w, u), "wkv_train")


def _forward_only(name: str, *tensors) -> None:
    """The forward entries' gradient guard: on CUDA the kernel's output
    has no ``grad_fn``, so a recorded call would cut the gradient."""
    if tensors[0].device.type == "cuda" and records_grad(*tensors):
        raise RuntimeError(f"{name} is forward only on CUDA (its output "
                           f"carries no grad_fn): train through wkv_train")


def wkv_stateful(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor, *,
                 inplace: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from ``state0`` over (B, S, H, D) fp32 streams with
    the (H, D) bonus ``u``; returns (y (B, S, H, D), final state (B, H, D,
    D)).  With ``inplace`` the final state is written into ``state0`` and
    that tensor is returned."""
    _check("wkv_stateful", (r, k, v, w), u, state0)
    _forward_only("wkv_stateful", r, k, v, w, u, state0)
    if r.device.type == "cpu":
        y, state = wkv_stateful_reference(r, k, v, w, u, state0)
        if inplace:
            return y, state0.copy_(state)
        return y, state
    state = state0 if inplace else torch.empty_like(state0)
    return _launch(r, k, v, w, u, state0, state), state


def wkv_apply(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *,
              chunk: int = 128) -> torch.Tensor:
    """r/k/v/w: (BH, S, D) fp32 streams (flattened batch*heads); u: (BH, D)
    bonus.  Returns y: (BH, S, D) fp32, from a zero state."""
    if chunk < 1:
        raise ValueError(f"wkv_apply: chunk must be positive, got {chunk}")
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(f"wkv_apply: need (BH, S, D) streams and a (BH, D) "
                         f"bonus, got {tuple(r.shape)}, {tuple(u.shape)}")
    streams = tuple(t[:, :, None] for t in (r, k, v, w))
    _check("wkv_apply", streams, u[:, None], None)
    _forward_only("wkv_apply", r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv_reference(r, k, v, w, u)
    return _launch(*streams, u[:, None], None, None)[:, :, 0]

