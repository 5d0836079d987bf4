from repro_torch.kernels.rwkv6.ops import wkv6  # noqa: F401
from repro_torch.kernels.rwkv6.ref import wkv6_ref  # noqa: F401
