"""Decode attention: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

Port of `repro/kernels/decode_attention/ops.py::decode_attention`. The
kernel reads q (B,1,H,d) and the cache (B,W,K,d) in place and masks the
ragged W edge itself, so the TPU wrapper's regrouping and padding do not
carry over. It splits W across the blocks of a thread-block cluster, one
cluster per (batch, kv head), and merges their partials in the same launch;
`split_plan` sizes the split for the card. `launches` counts calls, one per
decode step and layer.
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
# decode_attention_fwd(q, k, v, bias, out, B, W, H, K, d, q_dtype,
#                      kv_dtype, chunks_per_split, scale, stream)
# in csrc/decode_attention.cu
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
# CH, MAXG and MAX_SPLITS of csrc/decode_attention.cu, checked against the
# library when it loads
SLOTS_PER_CHUNK = 128
MAX_GROUP = 16
MAX_SPLITS = 8
# blocks an SM the split plans for: the bf16 kernel's two at d <= 80
# (its `__launch_bounds__`). At h2o-danube's shape (B * K = 32 on 132
# SMs) MAX_SPLITS binds first: 8 splits, 256 blocks, for two or three.
BLOCKS_PER_SM = 2


def split_plan(W: int, B: int, K: int, n_sm: int) -> tuple[int, int]:
    """(chunks of SLOTS_PER_CHUNK slots per split, splits) for a W-slot
    cache: enough splits of each (batch, kv head) that B * K * splits
    blocks fill the card's n_sm SMs once, at most MAX_SPLITS, and no split
    left empty."""
    chunks = -(-W // SLOTS_PER_CHUNK)
    fill = -(-BLOCKS_PER_SM * n_sm // (B * K))
    want = min(MAX_SPLITS, chunks, max(1, fill))
    per = -(-chunks // want)
    return per, -(-chunks // per)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    lib.decode_attention_fwd.argtypes = ARGTYPES
    lib.decode_attention_fwd.restype = ctypes.c_int
    for name, want in (("decode_attention_slots_per_chunk", SLOTS_PER_CHUNK),
                       ("decode_attention_max_group", MAX_GROUP),
                       ("decode_attention_max_splits", MAX_SPLITS)):
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
    per, _ = split_plan(W, B, K, _sm_count(q.device.index))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, W, H, K, d, _launch.DTYPE_CODES[q.dtype],
            _launch.DTYPE_CODES[k.dtype], per, 1.0 / math.sqrt(d),
            _launch.stream_handle(q))
    _launch.raise_on_error(_NAME, err, lib, "decode_attention_error_string")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
