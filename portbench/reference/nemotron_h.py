"""Plain float32 reference of Nemotron-H (nemotron-3-nano-30b-a3b): blocks of
one mixer each in the order of `layer_pattern` ('M' Mamba-2, 'E' MoE, '*'
attention), each x + mixer(rmsnorm(x)), then the final norm and the head;
with the weights the benchmark makes for both sides.

It imports nothing of the program. It follows the published equations
(transformers' modeling_nemotron_h), with the configuration as the
program states it (a configuration file's `model`):

- Mamba-2: in_proj to z (H P), xBC (H P + 2 G N) and dt (H); a causal
  depthwise conv of `d_conv` taps over xBC, with bias and SiLU; x, B and
  C split from it, head h reading group h // (H / G); dt = softplus(dt +
  dt_bias), A = -exp(A_log), one a head; the recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t, run
  here one token at a time (the program scans in chunks); y silu(z),
  RMS-normalised over groups of H P / G channels, then out_proj.
- MoE: float32 router logits, s = sigmoid(logits); the top-k of s plus
  the correction bias are chosen; the gates are the chosen s over their
  sum (plus 1e-20), times `routed_scaling`; relu² experts, down(relu(up
  x)^2), and a relu² shared expert of `shared_d_ff`.
- Attention: causal GQA (query head h reads kv head h // (H / K)), no
  positional encoding, 1/sqrt(head_dim) scores, in blocks of queries.

Departures from the published model, which the program shares:
- RMSNorms scale by (1 + scale), their weights starting at 0 (published:
  by scale, starting at 1); the same function at init.
- The MoE keeps `decoder.py`'s capacity rule: C = max(1, int(
  capacity_factor * k * N / E)) slots an expert over a routing group of N
  tokens (a served batch's prompts, then each decode step's token a row),
  a choice's place in its expert's queue counted in (k, token) order, a
  choice past C adding nothing. The published model drops none.
- The weights are drawn (`make_params`). The correction bias, which
  training's loss-free balancing sets so that each expert takes its
  share of the choices, is set so here: block by block over a float32
  forward of calibration text in the served language (`generate.
  zipf_markov`, a stream of the seed that no traffic draws), by
  `BALANCE_STEPS` updates b -= `BALANCE_RATE` (load / mean load - 1)
  from b = 0, the loads counted over the top-k of s + b.

Everything is computed in float32 with TF32 off, each layer's weights made
float32 as it runs, and the head only at the served positions. One forward
may hold several served batches (`BATCHES_A_FORWARD`), each routed as its
own: the token-by-token Mamba-2 recurrence costs the host the same for
more rows.
`quant="fp8"` and `quant="route_bf16"` are `decoder.py`'s control and
witness.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# token_gap is the driver's, as decoder.py's
from portbench.generate import zipf_markov
from portbench.reference.decoder import (F32, Ops, _put,  # noqa: F401
                                         exact_float32, rms_norm, token_gap)

QUERY_ROWS = 1024           # attention's queries a block, over all rows
# served batches a forward of `served_logits` holds, as the benchmark's
# serving driver reads them
BATCHES_A_FORWARD = 4
# the correction bias's calibration text: rows x tokens from its own stream
BALANCE_ROWS, BALANCE_LEN, BALANCE_STREAM = 2, 2048, 1 << 20
BALANCE_STEPS, BALANCE_RATE = 64, 0.01


def _softplus(x):
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# The weights' layout
# ---------------------------------------------------------------------------


def layout(m: dict) -> list[tuple]:
    """(path, shape, dtype, init) of every leaf of the program's params
    tree: `init` is ("normal", std), ("zeros",), ("full", value),
    ("a_log",) (log 1..H) or ("dt_bias",) (the inverse softplus of dt
    spaced geometrically over [1e-3, 0.1] across the heads)."""
    D, V = m["d_model"], m["vocab_size"]
    Vp = -(-V // 128) * 128
    pdt = getattr(torch, m.get("param_dtype", "bfloat16"))
    out_std = 0.02 / math.sqrt(2 * m["num_layers"])
    leaves = [(("embed",), (Vp, D), pdt, ("normal", 0.02)),
              (("final_norm",), (D,), F32, ("zeros",))]
    if not m.get("tie_embeddings"):
        leaves.append((("lm_head",), (Vp, D), pdt, ("normal", 0.02)))
    mb, mc = m["mamba"], m["moe"]
    H, P, G, N = mb["n_heads"], mb["head_dim"], mb["n_groups"], mb["d_state"]
    I, C = H * P, H * P + 2 * G * N
    E, Fe, Fs = mc["num_experts"], mc["d_ff"], mc["shared_d_ff"]
    hd, Hq, K = m["head_dim"], m["num_heads"], m["num_kv_heads"]
    for pos, kind in enumerate(m["layer_pattern"]):
        pre = ("layers", pos)
        leaves.append((pre + ("ln1",), (1, D), F32, ("zeros",)))
        if kind == "M":
            a = pre + ("mamba2",)
            leaves += [
                (a + ("in_proj",), (1, D, I + C + H), pdt, ("normal", 0.02)),
                (a + ("conv_w",), (1, mb["d_conv"], C), pdt, ("normal", 0.1)),
                (a + ("conv_b",), (1, C), pdt, ("normal", 0.02)),
                (a + ("dt_bias",), (1, H), F32, ("dt_bias",)),
                (a + ("A_log",), (1, H), F32, ("a_log",)),
                (a + ("D",), (1, H), F32, ("full", 1.0)),
                (a + ("norm",), (1, I), F32, ("zeros",)),
                (a + ("out_proj",), (1, I, D), pdt, ("normal", out_std))]
        elif kind == "E":
            a = pre + ("moe",)
            leaves += [
                (a + ("router",), (1, D, E), F32, ("normal", 0.02)),
                (a + ("router_bias",), (1, E), F32, ("zeros",)),
                (a + ("w_up",), (1, E, D, Fe), pdt, ("normal", 0.02)),
                (a + ("w_down",), (1, E, Fe, D), pdt, ("normal", out_std)),
                (a + ("shared", "w_up"), (1, D, Fs), pdt, ("normal", 0.02)),
                (a + ("shared", "w_down"), (1, Fs, D), pdt,
                 ("normal", out_std))]
        else:
            a = pre + ("attn",)
            leaves += [(a + ("wq",), (1, D, Hq, hd), pdt, ("normal", 0.02)),
                       (a + ("wk",), (1, D, K, hd), pdt, ("normal", 0.02)),
                       (a + ("wv",), (1, D, K, hd), pdt, ("normal", 0.02)),
                       (a + ("wo",), (1, Hq, hd, D), pdt,
                        ("normal", out_std))]
    return leaves


def make_params(m: dict, seed: int, device) -> dict:
    """The weights both sides get, in the program's tree, made on `device`
    from `seed`: one standard-normal draw a dtype over one flat buffer,
    each leaf a view of it scaled by its std, as `decoder.make_params`
    draws them; then the correction biases that even the experts' loads
    on the seed's calibration text. The same seed on the same device
    gives the same weights."""
    gen = torch.Generator(device).manual_seed(seed)
    leaves = layout(m)
    normal = [x for x in leaves if x[3][0] == "normal"]
    flat = {}
    for dt in dict.fromkeys(x[2] for x in normal):
        numel = sum(math.prod(x[1]) for x in normal if x[2] == dt)
        flat[dt] = torch.empty(numel, dtype=dt, device=device)
        flat[dt].normal_(generator=gen)
    offset = dict.fromkeys(flat, 0)
    params: dict = {}
    for path, shape, dt, init in leaves:
        if init[0] == "normal":
            k = math.prod(shape)
            t = flat[dt][offset[dt]:offset[dt] + k].view(shape)
            offset[dt] += k
            t.mul_(init[1])
        elif init[0] == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        elif init[0] == "full":
            t = torch.full(shape, init[1], dtype=dt, device=device)
        elif init[0] == "a_log":
            t = torch.log(torch.arange(1, shape[-1] + 1, dtype=dt,
                                       device=device)).expand(shape).clone()
        else:                           # dt_bias
            step = torch.exp(torch.linspace(math.log(1e-3), math.log(0.1),
                                            shape[-1], device=device))
            t = (step + torch.log(-torch.expm1(-step))).to(dt).expand(
                shape).clone()
        _put(params, path, t)
    V = m["vocab_size"]
    params["embed"][V:] = 0
    if "lm_head" in params:
        params["lm_head"][V:] = 0
    text = zipf_markov(V, BALANCE_ROWS, BALANCE_LEN, seed, BALANCE_STREAM)
    with torch.no_grad(), exact_float32():
        hidden(params, m, torch.from_numpy(text).to(device), Ops(None),
               [(0, BALANCE_LEN)], balance=True)
    return params


def even_loads(s, k):
    """The bias b (E,) that evens the loads of the top-k of scores s
    (N, E) plus b: `BALANCE_STEPS` updates from 0."""
    b = torch.zeros_like(s[0])
    mean = s.shape[0] * k / s.shape[1]
    for _ in range(BALANCE_STEPS):
        load = torch.bincount(torch.topk(s + b, k, dim=-1)[1].flatten(),
                              minlength=s.shape[1])
        b -= BALANCE_RATE * (load / mean - 1)
    return b


# ---------------------------------------------------------------------------
# Float32 forward
# ---------------------------------------------------------------------------


def mamba2(p, x, m, ops):
    mb = m["mamba"]
    B, T, _ = x.shape
    H, P, G, N = mb["n_heads"], mb["head_dim"], mb["n_groups"], mb["d_state"]
    dc, I, R = mb["d_conv"], H * P, H // G
    C = I + 2 * G * N
    z, xbc, dt = ops.mm("btd,de->bte", x, p["in_proj"]).split([I, C, H], -1)
    pad = torch.cat([xbc.new_zeros(B, dc - 1, C), xbc], dim=1)
    xbc = F.silu(sum(pad[:, i:i + T] * p["conv_w"][i] for i in range(dc))
                 + p["conv_b"])
    xs, Bm, Cm = xbc.split([I, G * N, G * N], -1)
    xs = xs.reshape(B, T, G, R, P)
    Bm, Cm = Bm.reshape(B, T, G, N), Cm.reshape(B, T, G, N)
    dt = _softplus(dt + p["dt_bias"]).reshape(B, T, G, R)
    decay = torch.exp(dt * -torch.exp(p["A_log"]).reshape(G, R))
    add = dt[..., None] * xs                                  # (B,T,G,R,P)
    h = x.new_zeros(B, G, R, P, N)
    ys = []
    # token t's operands, each shaped to broadcast against h (B,G,R,P,N)
    for dec, ad, b_t, c_t in zip(decay[..., None, None].unbind(1),
                                 add[..., None].unbind(1),
                                 Bm[:, :, :, None, None, :].unbind(1),
                                 Cm[:, :, :, None, :, None].unbind(1)):
        h = torch.addcmul(h * dec, ad, b_t)
        ys.append(h @ c_t)                                    # (B,G,R,P,1)
    y = torch.stack(ys, dim=1)[..., 0] + xs * p["D"].reshape(G, R, 1)
    y = y.reshape(B, T, I) * F.silu(z)
    y = rms_norm(y.reshape(B, T, G, I // G), p["norm"].reshape(G, I // G),
                 m.get("norm_eps", 1e-5)).reshape(B, T, I)
    return ops.mm("bti,id->btd", y, p["out_proj"])


def relu2(x, w_up, w_down, ops):
    """down(relu(x up)^2) over tokens x (n, D)."""
    return ops.mm("nf,fd->nd", torch.square(F.relu(ops.mm("nd,df->nf", x,
                                                          w_up))), w_down)


def moe(p, x, m, ops, groups, batch=None):
    """Token-choice top-k MoE with per-group capacity; `groups` are the
    (start, end) position ranges routed together over each `batch` rows
    (all, by default), rows in order within each."""
    mc = m["moe"]
    E, k = mc["num_experts"], mc["top_k"]
    B, T, D = x.shape
    batch = batch or B
    s = torch.sigmoid(ops.mm("btd,de->bte", ops.route(x), p["router"]))
    ids = torch.topk(s + p["router_bias"], k, dim=-1)[1]        # (B,T,k)
    gates = s.gather(-1, ids)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * \
        mc["routed_scaling"]
    keep = torch.zeros_like(gates, dtype=torch.bool)
    for r0 in range(0, B, batch):
        r1 = min(B, r0 + batch)
        for s0, s1 in groups:
            g_ids = ids[r0:r1, s0:s1].reshape(-1, k)          # (N,k)
            n = g_ids.shape[0]
            cap = max(1, int(mc["capacity_factor"] * k * n / E))
            order = F.one_hot(g_ids.t().reshape(-1), E)       # (k*N,E)
            place = ((torch.cumsum(order, 0) - order) * order).sum(-1)
            keep[r0:r1, s0:s1] = (place < cap).reshape(k, n).t().reshape(
                r1 - r0, s1 - s0, k)
    xt, gt = x.reshape(-1, D), (gates * keep).reshape(-1, k)
    it = ids.reshape(-1, k)
    out = relu2(xt, p["shared"]["w_up"], p["shared"]["w_down"], ops)
    for e in range(E):
        tok, slot = torch.nonzero((it == e) & (gt > 0), as_tuple=True)
        if tok.numel():
            ye = relu2(xt[tok], p["w_up"][e], p["w_down"][e], ops)
            out.index_add_(0, tok, ye * gt[tok, slot, None])
    return out.reshape(B, T, D)


def attention(p, x, m, ops):
    """Causal GQA without positions, `QUERY_ROWS` queries at a time over
    the rows."""
    B, T, _ = x.shape
    qb = max(1, QUERY_ROWS // B)
    H, K = m["num_heads"], m["num_kv_heads"]
    hd = p["wq"].shape[-1]
    q = ops.mm("btd,dhk->bthk", x, p["wq"])
    k = ops.mm("btd,dhk->bthk", x, p["wk"]).repeat_interleave(H // K, dim=2)
    v = ops.mm("btd,dhk->bthk", x, p["wv"]).repeat_interleave(H // K, dim=2)
    pos = torch.arange(T, device=x.device)
    outs = []
    for q0 in range(0, T, qb):
        q1 = min(T, q0 + qb)
        s = ops.mm("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) / math.sqrt(hd)
        ok = pos[q0:q1, None] >= pos[None, :q1]
        w = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        outs.append(ops.mm("bhqk,bkhd->bqhd", w, v[:, :q1]))
        del s, w
    return ops.mm("bthk,hkd->btd", torch.cat(outs, dim=1), p["wo"])


def _layer(params, li):
    """Block li's weights: a float32 copy of each leaf's one slice."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return t[0].float()
    return cut(params["layers"][li])


def hidden(params, m, tokens, ops, groups, last=0, balance=False,
           batch=None):
    """Final-normed hidden states (B, T - last, D) of the positions from
    `last` on, from a forward over `tokens`, block by block, the MoE routing
    each `batch` rows (all, by default) on their own. With
    `balance`, each MoE block's correction bias is first set in `params`
    to even its loads over `tokens` (`even_loads`)."""
    x = params["embed"][tokens].float()
    eps = m.get("norm_eps", 1e-5)
    mixers = {"M": ("mamba2", lambda p, h: mamba2(p, h, m, ops)),
              "E": ("moe", lambda p, h: moe(p, h, m, ops, groups, batch)),
              "*": ("attn", lambda p, h: attention(p, h, m, ops))}
    for li, kind in enumerate(m["layer_pattern"]):
        p = _layer(params, li)
        name, fn = mixers[kind]
        h = rms_norm(x, p["ln1"], eps)
        if balance and kind == "E":
            s = torch.sigmoid(ops.mm("btd,de->bte", ops.route(h),
                                     p[name]["router"]))
            b = even_loads(s.reshape(-1, s.shape[-1]), m["moe"]["top_k"])
            params["layers"][li][name]["router_bias"][0] = b
            p[name]["router_bias"] = b
        x = x + fn(p[name], h)
        del p
    return rms_norm(x[:, last:], params["final_norm"], eps)


# ---------------------------------------------------------------------------
# Serving: logits of the served tokens, teacher-forced
# ---------------------------------------------------------------------------


@torch.no_grad()
def served_logits(params, m, prompts, served, quant=None, batch=None):
    """Logits (B, G, V) over the real vocabulary that predict each served
    token, from one forward over the prompts and the served tokens before
    the last. Routing groups, each `batch` rows (all, by default) on their
    own, as the program served them: the prompts together, then each
    generated position across the rows, as the program routes its prefill
    and its decode steps."""
    B, P = prompts.shape
    G = served.shape[1]
    tokens = torch.cat([prompts, served[:, :G - 1]], dim=1)
    groups = [(0, P)] + [(P + j, P + j + 1) for j in range(G - 1)]
    ops = Ops(quant)
    with exact_float32():
        h = hidden(params, m, tokens, ops, groups, last=P - 1, batch=batch)
        head = params.get("lm_head", params["embed"])[:m["vocab_size"]]
        return ops.mm("bgd,vd->bgv", h, head)
