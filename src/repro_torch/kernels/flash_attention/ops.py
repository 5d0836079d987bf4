"""Flash attention: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors, with a gradient.

Port of `repro/kernels/flash_attention/ops.py::flash_attention`. The
kernel reads the (B,S,H,d) layout in place and masks the ragged S edge
itself, so the TPU wrapper's padding of S and d does not carry over. As in
the reference's `custom_vjp`, there is no backward kernel: the backward
recomputes `flash_attention_ref` under autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_NAME = "flash_attention"
# flash_attention_fwd(q, k, v, o, B, S, H, K, d, dtype, causal, window,
#                     scale, stream) in csrc/flash_attention.cu
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    lib.flash_attention_fwd.argtypes = ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _launch_kernel(q, k, v, causal, window):
    _launch.check_cuda_inputs(_NAME, q=q, k=k, v=v)
    B, S, H, d = q.shape
    K = k.shape[2]
    if k.shape != (B, S, K, d) or v.shape != k.shape or K == 0 or H % K:
        raise ValueError(f"{_NAME}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _launch.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{_NAME}: q, k, v must share one dtype of "
                        f"{sorted(map(str, _launch.DTYPE_CODES))}")
    if window is not None and window < 1:
        raise ValueError(f"{_NAME}: window must be >= 1, got {window}")
    _launch.check_head_dim(_NAME, d)
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, K, d, _launch.DTYPE_CODES[q.dtype], int(causal),
            window or 0, 1.0 / math.sqrt(d), _launch.stream_handle(q))
    _launch.raise_on_error(_NAME, err, lib, "flash_attention_error_string")
    flash_attention.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, window=window)
        return _launch_kernel(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        causal, window = ctx.mask
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = flash_attention_ref(*inputs, causal=causal, window=window)
        return (*torch.autograd.grad(o, inputs, g), None, None)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B,S,H,d), k/v (B,S,K,d) -> (B,S,H,d) in q's dtype;
    differentiable.

    CPU tensors go through `flash_attention_ref`; CUDA tensors launch the
    kernel (float32 or bfloat16, d in 32/64/80/112/128) or raise.
    """
    return _FlashAttention.apply(q, k, v, causal, window)


flash_attention.launches = 0
