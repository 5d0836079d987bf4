"""The Mamba selective scan: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, with a gradient.

The reference has no kernel for the scan (`repro/models/layers.py::
_mamba_ssm_chunked` runs `lax.associative_scan` per chunk), so this one
replaces none. The kernel walks the sequence token by token with each
channel's states in registers (csrc/mamba_scan.cu); it needs no chunks,
but the wrapper keeps the plain form's contract that S is a whole number
of its chunks, so that both paths take the same inputs. There is no
backward kernel: as in `wkv6`, the backward recomputes autograd of the
plain form, `mamba_ssm_chunked`, from the saved inputs, h0 included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.mamba_scan.ref import chunking, mamba_ssm_chunked

_NAME = "mamba_scan"
D_STATE = 16              # the kernel's N (csrc/mamba_scan.cu)
# mamba_scan_fwd(dt, A, Bm, Cm, xin, h0, y, h_final, B, S, I, N, dtype,
# stream) in csrc/mamba_scan.cu
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    lib.mamba_scan_fwd.argtypes = ARGTYPES
    lib.mamba_scan_fwd.restype = ctypes.c_int
    return lib


def _plain(dt, A, Bm, Cm, xin, h0):
    """`mamba_ssm_chunked` on float32 copies of dt, Bm, Cm and xin."""
    return mamba_ssm_chunked(dt.float(), A, Bm.float(), Cm.float(),
                             xin.float(), h0)


def _launch_kernel(dt, A, Bm, Cm, xin, h0):
    if not all(t.dtype == torch.bfloat16 for t in (dt, Bm, Cm, xin)):
        dt, Bm, Cm, xin = (t.float() for t in (dt, Bm, Cm, xin))
    _launch.check_cuda_inputs(_NAME, dt=dt, A=A, Bm=Bm, Cm=Cm, xin=xin,
                              h0=h0)
    B, S, I = xin.shape
    N = A.shape[-1]
    if dt.shape != xin.shape or A.shape != (I, N) or \
            Bm.shape != (B, S, N) or Cm.shape != Bm.shape or \
            h0.shape != (B, I, N) or S == 0:
        raise ValueError(f"{_NAME}: shapes dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, xin {tuple(xin.shape)}, h0 "
                         f"{tuple(h0.shape)}")
    if A.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"{_NAME}: A and h0 must be float32")
    if N != D_STATE:
        raise ValueError(f"{_NAME}: d_state {N} is not the kernel's "
                         f"{D_STATE}")
    if xin.dtype == torch.bfloat16 and I % 2:
        raise ValueError(f"{_NAME}: bfloat16 inputs need an even I, not {I}")
    y = torch.empty(xin.shape, dtype=torch.float32, device=xin.device)
    h_final = torch.empty_like(h0)
    lib = _lib()
    with torch.cuda.device(xin.device):
        err = lib.mamba_scan_fwd(dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                                 Cm.data_ptr(), xin.data_ptr(),
                                 h0.data_ptr(), y.data_ptr(),
                                 h_final.data_ptr(), B, S, I, N,
                                 _launch.DTYPE_CODES[xin.dtype],
                                 _launch.stream_handle(xin))
    _launch.raise_on_error(_NAME, err, lib, "mamba_scan_error_string")
    mamba_scan.launches += 1
    return y, h_final


class _MambaScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, A, Bm, Cm, xin, h0):
        ctx.save_for_backward(dt, A, Bm, Cm, xin, h0)
        if xin.device.type == "cpu":
            return _plain(dt, A, Bm, Cm, xin, h0)
        return _launch_kernel(dt, A, Bm, Cm, xin, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        # an unused output's gradient arrives as zeros (materialize_grads)
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _plain(*inputs)
        return torch.autograd.grad(outs, inputs, (g_y, g_h))


def mamba_scan(dt, A, Bm, Cm, xin, h0):
    """dt, xin (B,S,I), Bm, Cm (B,S,N) in the model's dtype, A (I,N) and
    h0 (B,I,N) float32 -> (y (B,S,I), h_final (B,I,N)) float32: h_t =
    exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t . h_t from h0, computed
    on float32 values of dt, Bm, Cm and xin; differentiable (the gradient
    is autograd of `mamba_ssm_chunked` on their float32 copies). S must be
    a whole number of the plain form's chunks (`ref.chunking`) on both
    paths.

    CPU tensors go through `mamba_ssm_chunked`; CUDA tensors launch the
    kernel (contiguous, N = D_STATE) or raise. The kernel reads dt, Bm,
    Cm and xin in bfloat16 where all four are, and float32 copies of them
    otherwise.
    """
    chunking(xin.shape[1])
    return _MambaScan.apply(dt, A, Bm, Cm, xin, h0)


mamba_scan.launches = 0
