"""What the kernel wrappers share: input checks, dtype codes, streams and
launch errors."""
from __future__ import annotations

import ctypes

import torch

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 112, 128)


def check_cuda_inputs(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on the same device."""
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not cuda")
        if dev is not None and t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the "
                             f"other inputs on {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def check_head_dim(kernel: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {d} not in {HEAD_DIMS}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(kernel: str, err: int, lib: ctypes.CDLL,
                   error_string: str) -> None:
    """Raise if the C entry reported a CUDA error for its launch."""
    if err:
        fn = getattr(lib, error_string)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err} ({fn(err).decode()})")
