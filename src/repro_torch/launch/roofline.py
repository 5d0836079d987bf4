"""Roofline terms of one step on an H100 (counterpart of
`repro.launch.hlo_analysis`).

The reference reads per-device FLOPs, bytes and collective bytes from
XLA's compiled HLO and sets them against a TPU v5e. Here the dry-run
(`launch/dryrun.py`) counts them by tracing the port's step on meta
tensors, and `Roofline` sets them against one H100 SXM5 80GB at its
700 W power limit. Every constant is a datasheet number:

- PEAK_FLOPS_BF16, 989e12: dense bf16 tensor-core FLOP/s (NVIDIA H100
  Tensor Core GPU datasheet, SXM5, without sparsity);
- HBM_BW, 3.35e12 B/s: HBM3 bandwidth (the same datasheet);
- ICI_BW, 450e9 B/s: the in-pod tier, NVLink 4, 900 GB/s of a GPU's
  18 links together, 450 GB/s in each direction (the same datasheet);
- DCN_BW, 50e9 B/s: the cross-pod tier, one 400 Gb/s NDR InfiniBand NIC
  per GPU (NVIDIA ConnectX-7 datasheet), as a DGX H100 has.

The reference has two tiers, within a pod and across pods, and the
dry-run keeps them. On H100s only the 8 GPUs of one host share an NVLink
domain, so a 16 x 16 pod of 256 H100s is 32 NVLink domains joined by
the NICs, not one: pricing all in-pod traffic at NVLink's rate is an
approximation that the two tiers force, a lower bound on the in-pod
collective time.

`repro.launch.hlo_cost` and `repro.launch.reanalyze` parse XLA's HLO
text; the port has no HLO and they have no twin here.
"""
from __future__ import annotations

import dataclasses

# ---- H100 SXM5 80GB hardware constants (datasheet, 700 W) -------------------

PEAK_FLOPS_BF16 = 989e12          # per GPU, dense
HBM_BW = 3.35e12                  # bytes/s per GPU
ICI_BW = 450e9                    # NVLink 4, each direction
DCN_BW = 50e9                     # one 400 Gb/s NDR NIC per GPU
DEVICE = "H100 SXM5 80GB (datasheet)"


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    hbm_bytes: float              # per device
    ici_bytes: float
    dcn_bytes: float
    model_flops: float = 0.0      # 6*N*D useful flops, per device

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.ici_bytes / ICI_BW + self.dcn_bytes / DCN_BW

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self):          # perfectly-overlapped lower bound
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self):
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self):
        """Share of the GPU's peak spent on *useful* model flops, assuming
        perfect overlap."""
        t = self.step_time
        return (self.model_flops / t / PEAK_FLOPS_BF16) if t else 0.0

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "ici_bytes": self.ici_bytes, "dcn_bytes": self.dcn_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_per_step(cfg, shape) -> float:
    """6*N*D for train, 2*N_active per token for decode/prefill (global);
    the reference's formula, number for number."""
    total, active = cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if shape.kind == "train":
        base = 6.0 * active * tokens
    else:
        base = 2.0 * active * tokens
    # attention flops (not in param count): 2*2*S_kv*D_attn per token
    hd = cfg.head_dim_()
    n_attn = (cfg.num_layers // cfg.attn_every) if cfg.num_heads else 0
    if cfg.rwkv:
        n_attn = 0   # attention-free; wkv flops are ~included in 2*N*D
    s_kv = shape.seq_len
    if cfg.sliding_window:
        s_kv = min(s_kv, cfg.sliding_window)
    att = 4.0 * cfg.num_heads * hd * s_kv * n_attn
    if shape.kind == "train":
        att_total = 3.0 * att * tokens * 0.5     # causal halves, fwd+bwd=3x
    elif shape.kind == "prefill":
        att_total = att * tokens * 0.5
    else:
        att_total = att * tokens
    return base + att_total
