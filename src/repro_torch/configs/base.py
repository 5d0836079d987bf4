"""Model/run configuration system (the port's own copy).

A copy of `repro/configs/base.py`: the port keeps its own so that it never
imports the reference package. Every assigned architecture is a
`ModelConfig`; shapes are `ShapeConfig`s. Padding rules (TP-divisible
heads, vocab multiples) are applied here, once, explicitly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shape (workload) configs — identical across LM archs per the assignment.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden
    capacity_factor: float = 1.25
    num_shared_experts: int = 0   # always-on experts (Kimi-K2 style)
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # 'einsum': GShard one-hot dispatch (dense, MXU-friendly, O(N*E*C*D));
    # 'scatter': scatter/gather dispatch (O(N*K*D) data movement) — the
    # compute-term optimization for very large E (see EXPERIMENTS §Perf)
    dispatch: str = "einsum"
    # 'softmax': top-k of the softmax, renormalised; 'sigmoid_bias'
    # (Nemotron-H): top-k of sigmoid scores plus a correction bias (the
    # `router_bias` leaf, used only to choose), the chosen scores
    # renormalised
    router: str = "softmax"
    # the experts' FFN: 'swiglu' (gate, up, down) or 'relu2' (up, down:
    # down(relu(up x)^2), no gate)
    activation: str = "swiglu"
    routed_scaling: float = 1.0   # sigmoid_bias: the routed gates' factor
    shared_d_ff: int = 0          # shared experts' width; 0 => n * d_ff

    def shared_width(self) -> int:
        return self.shared_d_ff or self.num_shared_experts * self.d_ff


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # Mamba-2 (multi-head SSD), run by the 'M' blocks of a layer_pattern,
    # which alone selects it (n_heads > 0 asks for a pattern): n_heads
    # heads of head_dim channels (the inner width; `expand` is not read),
    # B and C of d_state shared by each of n_groups groups of heads, the
    # prefill's scan in chunks of `chunk` tokens
    n_heads: int = 0
    head_dim: int = 0
    n_groups: int = 1
    chunk: int = 128

    def conv_width(self) -> int:
        """Mamba-2's conv channels: x, B and C."""
        return self.n_heads * self.head_dim + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 => attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads

    # attention flavour
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None   # SWA width (h2o-danube)
    causal: bool = True
    # online-softmax (flash) attention over key blocks of this size; None
    # uses the naive O(S^2)-score reference path (paper-faithful baseline)
    attn_block: Optional[int] = None

    # MoE
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # apply MoE FFN every k-th layer

    # hybrid (Jamba): attention every `attn_every` layers, Mamba otherwise
    attn_every: int = 1
    mamba: Optional[MambaConfig] = None

    # ssm (RWKV6)
    rwkv: bool = False

    # Nemotron-H: one character a block, each block one mixer: 'M'
    # Mamba-2, 'E' MoE, '*' attention; "" => the periodic families above
    layer_pattern: str = ""
    use_rope: bool = True         # False: attention without positions

    # vlm: cross-attention to image tokens every k layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    # audio (whisper): encoder-decoder
    encoder_layers: int = 0       # >0 => enc-dec; num_layers is decoder depth
    num_audio_frames: int = 0     # stubbed conv frontend output length

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- derived / padded quantities (TP alignment) ----
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def padded_heads(self, tp: int) -> Tuple[int, int, int]:
        """Return (q_heads', kv_heads_stored', group') after TP alignment.

        Strategy (DESIGN.md §4): let G = H/K q-heads per kv group.
          * K >= tp              : pad K to multiple of tp; q padded G*K'.
          * K <  tp (tp%K == 0)  : pad G to multiple of r=tp/K, store each kv
                                   head repeated r times => kv_stored = tp-
                                   aligned, every shard's q block maps to a
                                   single local kv head.
        Padded q heads have zero Wq columns / zero Wo rows => exact function.
        """
        H, K = self.num_heads, self.num_kv_heads
        if H == 0:
            return 0, 0, 0
        assert H % K == 0, (self.name, H, K)
        G = H // K
        if K >= tp:
            Kp = _ceil_to(K, tp)
            return G * Kp, Kp, G
        assert tp % K == 0, f"{self.name}: tp={tp} not a multiple of kv={K}"
        r = tp // K
        Gp = _ceil_to(G, r)
        return Gp * K, tp, Gp     # kv stored with r-fold repetition

    def padded_vocab(self, multiple: int = 128) -> int:
        return _ceil_to(self.vocab_size, multiple)

    # ---- parameter counting (true, un-padded arch) ----
    def param_count(self) -> Tuple[int, int]:
        """(total_params, active_params) of the true architecture."""
        if self.layer_pattern:
            return self._pattern_param_count()
        D, V, L = self.d_model, self.vocab_size, self.num_layers
        hd = self.head_dim_()
        per_layer = 0
        active_per_layer = 0
        # attention layers
        n_attn = L // self.attn_every if self.attn_every > 1 else (
            L if self.num_heads else 0)
        attn_p = D * (self.num_heads * hd) * 2 + D * (self.num_kv_heads * hd) * 2
        # ffn
        if self.moe is not None:
            n_moe = L // self.moe_every
            n_dense_ffn = L - n_moe
            moe_p = self.moe.num_experts * 3 * D * self.moe.d_ff
            moe_active = ((self.moe.top_k + self.moe.num_shared_experts)
                          * 3 * D * self.moe.d_ff)
            shared_p = self.moe.num_shared_experts * 3 * D * self.moe.d_ff
            ffn_total = n_moe * (moe_p + shared_p) + n_dense_ffn * 3 * D * self.d_ff
            ffn_active = n_moe * moe_active + n_dense_ffn * 3 * D * self.d_ff
        else:
            mult = 3  # SwiGLU: gate, up, down
            ffn_total = L * mult * D * self.d_ff
            ffn_active = ffn_total
        if self.rwkv:
            # time-mix: r,k,v,g,o projections (+ small decay loras);
            # channel-mix: wk (D,F), wv (F,D), wr (D,D)
            attn_total = L * (5 * D * D)
            attn_active = attn_total
            ffn_total = L * (2 * D * self.d_ff + D * D)
            ffn_active = ffn_total
        elif self.attn_every > 1:
            m = self.mamba or MambaConfig()
            d_inner = m.expand * D
            mamba_p = (2 * D * d_inner + d_inner * m.d_conv
                       + d_inner * (m.d_state * 2 + 2) + d_inner * D)
            n_mamba = L - n_attn
            attn_total = n_attn * attn_p + n_mamba * mamba_p
            attn_active = attn_total
        else:
            attn_total = n_attn * attn_p
            attn_active = attn_total
        if self.cross_attn_every:
            n_x = self.num_layers // self.cross_attn_every
            attn_total += n_x * attn_p
            attn_active += n_x * attn_p
        emb = V * D * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_p + 3 * D * self.d_ff)
            # decoder cross-attention
            attn_total += self.num_layers * attn_p
            attn_active += self.num_layers * attn_p
        total = emb + attn_total + ffn_total + enc
        active = emb + attn_active + ffn_active + enc
        return int(total), int(active)

    def _pattern_param_count(self) -> Tuple[int, int]:
        """Every leaf of a layer-pattern model, norms and biases too: the
        embedding, the head, the final norm and each block's norm and
        mixer."""
        D, hd = self.d_model, self.head_dim_()
        m, e = self.mamba, self.moe
        blocks = {"*": D * hd * 2 * (self.num_heads + self.num_kv_heads)}
        if m is not None:
            I, conv = m.n_heads * m.head_dim, m.conv_width()
            # in_proj (z, xBC, dt), conv weight and bias, dt_bias, A_log,
            # D, the gated norm, out_proj
            blocks["M"] = (D * (I + conv + m.n_heads) + conv * (m.d_conv + 1)
                           + 3 * m.n_heads + I + I * D)
        if e is not None:
            mats = 2 if e.activation == "relu2" else 3    # weight matrices
            expert = mats * D * e.d_ff
            fixed = (D * e.num_experts + mats * D * e.shared_width()
                     + (e.num_experts if e.router == "sigmoid_bias" else 0))
            blocks["E"] = fixed + e.num_experts * expert
        total = active = (self.vocab_size * D * (1 if self.tie_embeddings
                                                 else 2) + D)
        reps = self.num_layers // len(self.layer_pattern)
        for c in self.layer_pattern:
            total += reps * (D + blocks[c])
            active += reps * (D + blocks[c])
            if c == "E":
                active -= reps * (e.num_experts - e.top_k) * expert
        return int(total), int(active)


# Registry --------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        from repro_torch.configs import ALL_ARCHS  # noqa: F401
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch.configs import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (1 device)."""
    kw: dict = dict(
        num_layers=max(2, cfg.attn_every, cfg.moe_every,
                       cfg.cross_attn_every or 1),
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=2 if cfg.num_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k), d_ff=64)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["num_audio_frames"] = 16
    if cfg.cross_attn_every:
        kw["num_image_tokens"] = 16
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    if cfg.layer_pattern:
        kw["layer_pattern"] = "MEM*EME*"
        kw["num_layers"] = len(kw["layer_pattern"])
        kw["mamba"] = dataclasses.replace(cfg.mamba, n_heads=4, head_dim=16,
                                          n_groups=2, d_state=16, chunk=16)
        kw["moe"] = dataclasses.replace(kw["moe"], num_experts=8,
                                        shared_d_ff=2 * kw["moe"].d_ff)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell (DESIGN.md §4 skips)."""
    sub_quadratic = (cfg.rwkv or cfg.attn_every > 1
                     or cfg.sliding_window is not None)
    if shape.name == "long_500k" and not sub_quadratic:
        return False, "full quadratic attention at 512k is infeasible (skip)"
    return True, ""
