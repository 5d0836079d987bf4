"""RWKV6 WKV: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors, with a gradient.

Port of `repro/kernels/rwkv6/ops.py::wkv6`. The kernel runs the
recurrence token by token over chunks it stages itself, zero-filling a
ragged last chunk, so the TPU wrapper's padding of S does not carry over. As in the reference's `custom_vjp`, there is no backward kernel: the
backward recomputes a plain version from a zero state under autograd. The
reference recomputes its per-token oracle; here that is a Python loop of
small launches per token (3.3 s a layer at rwkv6-7b's training shape on an
H100), so the backward recomputes the chunked form `wkv6_chunked`, the
same function in a few large launches per 64-token chunk, with S padded to
the chunk by tokens of logw = 0 and k = v = r = 0, which leave the state
and the outputs unchanged.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.rwkv6.ref import RWKV_CHUNK, wkv6_chunked, wkv6_ref

_NAME = "wkv6"
HEAD_DIMS = (16, 32, 64)
# wkv6_fwd(r, k, v, logw, u, o, s_final, B, H, S, d, stream) in
# csrc/wkv6.cu
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    lib.wkv6_fwd.argtypes = ARGTYPES
    lib.wkv6_fwd.restype = ctypes.c_int
    return lib


def _zero_state(r):
    B, H, _, d = r.shape
    return torch.zeros((B, H, d, d), dtype=torch.float32, device=r.device)


def _chunked_from_zero(r, k, v, logw, u):
    """`wkv6_chunked` from a zero state for any S: the tail is padded to a
    whole chunk with tokens that change nothing (logw = 0, zero r, k, v)."""
    S = r.shape[2]
    pad = -S % min(RWKV_CHUNK, S)
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    o, s_final = wkv6_chunked(r, k, v, logw, u, _zero_state(r))
    return o[:, :, :S], s_final


def _launch_kernel(r, k, v, logw, u):
    _launch.check_cuda_inputs(_NAME, r=r, k=k, v=v, logw=logw, u=u)
    B, H, S, d = r.shape
    if any(t.shape != r.shape for t in (k, v, logw)) or u.shape != (H, d) \
            or S == 0:
        raise ValueError(f"{_NAME}: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}")
    if any(t.dtype != torch.float32 for t in (r, k, v, logw, u)):
        raise TypeError(f"{_NAME}: r, k, v, logw and u must be float32")
    if d not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head dim {d} not in {HEAD_DIMS}")
    o = torch.empty_like(r)
    s_final = torch.empty((B, H, d, d), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        err = lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           logw.data_ptr(), u.data_ptr(), o.data_ptr(),
                           s_final.data_ptr(), B, H, S, d,
                           _launch.stream_handle(r))
    _launch.raise_on_error(_NAME, err, lib, "wkv6_error_string")
    wkv6.launches += 1
    return o, s_final


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        if r.device.type == "cpu":
            return wkv6_ref(r, k, v, logw, u, _zero_state(r))
        return _launch_kernel(r, k, v, logw, u)

    @staticmethod
    def backward(ctx, g_o, g_s):
        # an unused output's gradient arrives as zeros (materialize_grads)
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _chunked_from_zero(*inputs)
        return torch.autograd.grad(outs, inputs, (g_o, g_s))


def wkv6(r, k, v, logw, u):
    """r, k, v, logw (B,H,S,d), u (H,d), all float32 -> (o (B,H,S,d),
    S_final (B,H,d,d)), from a zero initial state; differentiable (the
    gradient is autograd of `wkv6_chunked`).

    CPU tensors go through `wkv6_ref`; CUDA tensors launch the kernel
    (contiguous, d in 16/32/64) or raise.
    """
    return _WKV6.apply(r, k, v, logw, u)


wkv6.launches = 0
