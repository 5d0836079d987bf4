"""The least time of one call of the flash-attention forward kernel on an
H100: the larger of its operations over the bf16 (or float32) peak and
its bytes over HBM bandwidth. Operations: 4*B*H*d for every (query, key)
pair the mask lets through (QK^T and PV); bytes: q and k and v read once,
the output written once. A frozen copy of `chip_smoke.py`'s `_bound` and
`_visible_pairs`."""
from __future__ import annotations

import functools

from portbench.flops import HBM_BYTES_PER_S, PEAK_FLOPS

# the kernel's names in a device trace (csrc/flash_attention.cu)
KERNEL = r"flash_fwd(_bf16)?_kernel"
# the call the traced run wraps to record each launch's shapes
WRAPS = "repro_torch.kernels.flash_attention.ops:flash_attention"


def record(q, k, v, *, causal=True, window=None) -> dict:
    return {"q": tuple(q.shape), "k": tuple(k.shape),
            "itemsize": q.element_size(),
            "dtype": str(q.dtype).removeprefix("torch."),
            "causal": bool(causal), "window": window}


@functools.cache
def visible_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    total = 0
    for i in range(S):
        lo = 0 if window is None else max(0, i - window + 1)
        hi = i + 1 if causal else S
        total += hi - lo
    return total


def cost(call: dict) -> tuple[float, float, str]:
    """(FLOPs, bytes, dtype) of one call: `call` has q (B,S,H,d) and k
    (B,S,K,d) shapes, the element size, dtype, causal and window."""
    B, S, H, d = call["q"]
    K = call["k"][2]
    flops = 4.0 * B * H * d * visible_pairs(S, call["causal"],
                                            call["window"])
    nbytes = call["itemsize"] * (2 * B * S * H * d + 2 * B * S * K * d)
    return flops, nbytes, call["dtype"]


def bound_s(call: dict) -> float:
    flops, nbytes, dtype = cost(call)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
