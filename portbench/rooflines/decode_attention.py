"""The least time of one call of the decode-attention kernel on an H100.
The call needs the cache slots that hold a position at or before the new
token (`valid`, of the W allocated): their k and v read once, their
mask entries read once, q read and the output written once. Operations:
4*B*H*d a valid slot. Slots past the newest token hold nothing the call
needs, so they are not counted, though the kernel may read them."""
from __future__ import annotations

from portbench.flops import HBM_BYTES_PER_S, PEAK_FLOPS

# the kernel's names in a device trace (csrc/decode_attention.cu)
KERNEL = r"decode_(bf16_)?kernel"
# the call the traced run wraps: the model's decode attention, one kernel
# launch a call, which knows the cache index
WRAPS = "repro_torch.models.layers:decode_attention"


def record(p, x, cfg, rules=None, *, cache, cache_index, **_) -> dict:
    B = x.shape[0]
    ck = cache["k"]
    W = ck.shape[1]
    H, d = p["wq"].shape[1], p["wq"].shape[2]
    return {"q": (B, 1, H, d), "k": tuple(ck.shape),
            "valid": min(cache_index + 1, W),
            "itemsize": ck.element_size(),
            "dtype": str(ck.dtype).removeprefix("torch.")}


def cost(call: dict) -> tuple[float, float, str]:
    B, _, H, d = call["q"]
    K = call["k"][2]
    n = call["valid"]
    flops = 4.0 * B * H * d * n
    nbytes = (call["itemsize"] * (2 * B * H * d + 2 * B * n * K * d)
              + 4 * B * n)
    return flops, nbytes, call["dtype"]


def bound_s(call: dict) -> float:
    flops, nbytes, dtype = cost(call)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
