"""RWKV6 WKV recurrence (port of ``repro.kernels.wkv_gemm``).

Per (batch row, head), with a D x D fp32 state S:
``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``, ``S_t = diag(w_t) S_{t-1} +
k_t^T v_t``.  Two entries over one hand-written Hopper source
(``csrc/wkv.cu``: a one-step kernel for decode, a chunked one for longer
sequences, chosen by S behind one C entry point):

  * :func:`wkv_apply` — the reference's signature: (BH, S, D) streams, a
    (BH, D) bonus, zero initial state, returns y.
  * :func:`wkv_stateful` — the model's layout: (B, S, H, D) streams, the
    (H, D) bonus, the state carried in (B, H, D, D) and the final state
    out (in place when the caller allows), which serving needs for decode.

On CUDA tensors both launch the kernel or raise; on CPU tensors they run
the plain versions beside them, :func:`wkv_reference` (the reference's
oracle) and :func:`wkv_stateful_reference` (the model's per-step einsum).
The kernel keeps the state on chip for the whole sequence, so ``chunk``
does not change the result; it is accepted for the reference's signature.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

# Head sizes the kernel is instantiated for: the configs' (16 smoke, 64
# full width) and the reference tests' smaller ones.
SUPPORTED_D = (4, 8, 16, 64)

# Launches of the CUDA kernel; the wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"wkv": 0}


def reset_launches() -> None:
    launches["wkv"] = 0


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


def wkv_stateful(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor, *,
                 inplace: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from ``state0`` over (B, S, H, D) fp32 streams with
    the (H, D) bonus ``u``; returns (y (B, S, H, D), final state (B, H, D,
    D)).  With ``inplace`` the final state is written into ``state0`` and
    that tensor is returned."""
    _check("wkv_stateful", (r, k, v, w), u, state0)
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
    if r.device.type == "cpu":
        return wkv_reference(r, k, v, w, u)
    return _launch(*streams, u[:, None], None, None)[:, :, 0]

