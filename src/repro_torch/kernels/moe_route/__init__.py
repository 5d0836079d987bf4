from repro_torch.kernels.moe_route.ops import route_positions  # noqa: F401
from repro_torch.kernels.moe_route.ref import (  # noqa: F401
    route_positions_ref)
