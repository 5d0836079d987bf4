"""Decode attention: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

Port of `repro/kernels/decode_attention/ops.py::decode_attention`. The
kernel reads q (B,1,H,d) and the cache (B,W,K,d) in place and masks the
ragged W edge itself, so the TPU wrapper's regrouping and padding do not
carry over. It splits W across blocks and merges the partials in a second
launch of the same call; `launches` counts calls, one per decode step and
layer.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_NAME = "decode_attention"
# (q dtype, cache dtype) pairs the kernel is built for
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
# decode_attention_fwd(q, k, v, bias, part_m, part_l, part_acc, out, B, W,
#                      H, K, d, q_dtype, kv_dtype, nsplit, scale, stream)
# in csrc/decode_attention.cu
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
# CH and MAXG of csrc/decode_attention.cu, checked against the library
# when it loads
SLOTS_PER_BLOCK = 128
MAX_GROUP = 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    lib.decode_attention_fwd.argtypes = ARGTYPES
    lib.decode_attention_fwd.restype = ctypes.c_int
    for name, want in (("decode_attention_slots_per_block", SLOTS_PER_BLOCK),
                       ("decode_attention_max_group", MAX_GROUP)):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{_NAME}: {name}() is {fn()} in the built "
                               f"library, {want} in ops.py")
    return lib


def decode_attention(q, k, v, bias):
    """q (B,1,H,d), k/v (B,W,K,d), bias (B,W) float32 -> (B,1,H,d) in q's
    dtype.

    CPU tensors go through `decode_attention_ref`; CUDA tensors launch the
    kernel or raise.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, bias).to(q.dtype)
    _launch.check_cuda_inputs(_NAME, q=q, k=k, v=v, bias=bias)
    B, one, H, d = q.shape
    W, K = k.shape[1], k.shape[2]
    if (one != 1 or k.shape != (B, W, K, d) or v.shape != k.shape
            or bias.shape != (B, W) or K == 0 or H % K):
        raise ValueError(f"{_NAME}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if (q.dtype, k.dtype) not in _PAIRS or v.dtype != k.dtype:
        raise TypeError(f"{_NAME}: (q, k, v) dtypes ({q.dtype}, {k.dtype}, "
                        f"{v.dtype}) not in {sorted(map(str, _PAIRS))}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{_NAME}: bias must be float32, not {bias.dtype}")
    _launch.check_head_dim(_NAME, d)
    G = H // K
    if G > MAX_GROUP:
        raise ValueError(f"{_NAME}: {G} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    lib = _lib()
    nsplit = -(-W // SLOTS_PER_BLOCK)
    # the partials in one float32 buffer: m (B,K,nsplit,G), then l of the
    # same shape, then acc (B,K,nsplit,G,d)
    n = B * K * nsplit * G
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    ptr = part.data_ptr()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            ptr, ptr + 4 * n, ptr + 8 * n,
            out.data_ptr(), B, W, H, K, d, _launch.DTYPE_CODES[q.dtype],
            _launch.DTYPE_CODES[k.dtype], nsplit, 1.0 / math.sqrt(d),
            _launch.stream_handle(q))
    _launch.raise_on_error(_NAME, err, lib, "decode_attention_error_string")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
