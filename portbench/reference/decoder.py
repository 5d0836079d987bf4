"""Plain float32 reference of the decoder families the benchmark runs:
dense GQA decoders (h2o-danube) and the Mamba + attention hybrid with MoE
FFNs (Jamba), with the weights the benchmark makes for both sides.

It imports nothing of the program. It follows the configuration as the
program states it (a configuration file's `model`):

- RMSNorm scales by (1 + scale); RoPE rotates split halves; causal GQA
  attention (query head h reads kv head h // (H / K)) within the sliding
  window; SwiGLU FFNs.
- A period of `attn_every` layers has attention in its last layer and
  Mamba-1 in the others; every `moe_every`-th layer of a period (the
  last of each group) has the MoE FFN, the others the dense one.
- Mamba-1: in_proj to (x, z), a causal depthwise conv of `d_conv` taps
  with bias and SiLU, x_proj to (dt, B, C) with dt rank d_model / 16,
  dt = softplus(dt @ dt_proj + dt_bias), A = -exp(A_log), the
  recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t . h_t +
  Dskip x_t, gated by SiLU(z). Run here one token at a time.
- MoE: a float32 router, softmax, top-k renormalised, and a capacity of
  C = max(1, int(capacity_factor * k * N / E)) slots an expert over a
  routing group of N tokens; a token's place in its expert's queue
  counts choices in (k, token) order, and a choice past C adds nothing.
  The program routes each forward call as a group: a prefill's prompts
  (rows in order), then each decode step's one token a row.

Everything is computed in float32 with TF32 off. `quant="fp8"` is the
control: every matrix product takes its operands rounded to float8 e4m3
with one scale a tensor (in the forward; gradients pass straight
through), which is the step below the configurations' bfloat16.
`quant="route_bf16"` is a witness, not a control: float32 throughout but
the router's input rounded to bfloat16, as the program's activations
are, to show what that rounding alone does to the expert choices.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16
F32 = torch.float32


# ---------------------------------------------------------------------------
# Layer pattern and the weights' layout
# ---------------------------------------------------------------------------


def period(m: dict) -> int:
    if m.get("attn_every", 1) > 1:
        return m["attn_every"]
    if m.get("moe") and m.get("moe_every", 1) > 1:
        return m["moe_every"]
    return 1


def block_specs(m: dict) -> list[dict]:
    """(mixer, ffn) of each position in a period."""
    P, out = period(m), []
    for pos in range(P):
        mixer = ("attn" if m.get("attn_every", 1) <= 1 or pos == P - 1
                 else "mamba")
        every = m.get("moe_every", 1)
        ffn = "moe" if m.get("moe") and pos % every == every - 1 else "ffn"
        out.append({"mixer": mixer, "ffn": ffn})
    return out


def _dims(m: dict) -> dict:
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    d = {"D": m["d_model"], "H": m["num_heads"], "K": m["num_kv_heads"],
         "hd": hd, "F": m["d_ff"], "V": m["vocab_size"],
         "Vp": -(-m["vocab_size"] // 128) * 128,
         "n": m["num_layers"] // period(m)}
    if m.get("mamba"):
        mb = m["mamba"]
        d.update(I=mb["expand"] * m["d_model"], N=mb["d_state"],
                 dc=mb["d_conv"], R=max(1, m["d_model"] // 16))
    if m.get("moe"):
        d.update(E=m["moe"]["num_experts"], Fe=m["moe"]["d_ff"])
    return d


def layout(m: dict) -> list[tuple]:
    """(path, shape, dtype, init) of every leaf of the program's params
    tree (one device, no tensor-parallel padding): `init` is ("normal",
    std), ("zeros",), ("full", value) or ("a_log",)."""
    d = _dims(m)
    D, n = d["D"], d["n"]
    pdt = getattr(torch, m.get("param_dtype", "bfloat16"))
    out_std = 0.02 / math.sqrt(2 * m["num_layers"])
    leaves = [(("embed",), (d["Vp"], D), pdt, ("normal", 0.02)),
              (("final_norm",), (D,), F32, ("zeros",))]
    if not m.get("tie_embeddings"):
        leaves.append((("lm_head",), (d["Vp"], D), pdt, ("normal", 0.02)))
    for pos, spec in enumerate(block_specs(m)):
        pre = ("layers", pos)
        leaves += [(pre + ("ln1",), (n, D), F32, ("zeros",)),
                   (pre + ("ln2",), (n, D), F32, ("zeros",))]
        if spec["mixer"] == "attn":
            H, K, hd = d["H"], d["K"], d["hd"]
            a = pre + ("attn",)
            leaves += [(a + ("wq",), (n, D, H, hd), pdt, ("normal", 0.02)),
                       (a + ("wk",), (n, D, K, hd), pdt, ("normal", 0.02)),
                       (a + ("wv",), (n, D, K, hd), pdt, ("normal", 0.02)),
                       (a + ("wo",), (n, H, hd, D), pdt, ("normal", out_std))]
        else:
            I, N, R = d["I"], d["N"], d["R"]
            a = pre + ("mamba",)
            leaves += [
                (a + ("in_proj",), (n, D, 2 * I), pdt, ("normal", 0.02)),
                (a + ("conv_w",), (n, d["dc"], I), pdt, ("normal", 0.1)),
                (a + ("conv_b",), (n, I), pdt, ("zeros",)),
                (a + ("x_proj",), (n, I, R + 2 * N), pdt, ("normal", 0.02)),
                (a + ("dt_proj",), (n, R, I), pdt, ("normal", 0.02)),
                (a + ("dt_bias",), (n, I), pdt, ("full", -2.0)),
                (a + ("A_log",), (n, I, N), F32, ("a_log",)),
                (a + ("Dskip",), (n, I), pdt, ("full", 1.0)),
                (a + ("out_proj",), (n, I, D), pdt, ("normal", out_std))]
        if spec["ffn"] == "moe":
            E, Fe = d["E"], d["Fe"]
            a = pre + ("moe",)
            leaves += [(a + ("router",), (n, D, E), F32, ("normal", 0.02)),
                       (a + ("w_gate",), (n, E, D, Fe), pdt, ("normal", 0.02)),
                       (a + ("w_up",), (n, E, D, Fe), pdt, ("normal", 0.02)),
                       (a + ("w_down",), (n, E, Fe, D), pdt,
                        ("normal", out_std))]
        else:
            a = pre + ("ffn",)
            leaves += [(a + ("w_gate",), (n, D, d["F"]), pdt, ("normal", 0.02)),
                       (a + ("w_up",), (n, D, d["F"]), pdt, ("normal", 0.02)),
                       (a + ("w_down",), (n, d["F"], D), pdt,
                        ("normal", out_std))]
    return leaves


def _put(tree, path, value):
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(tree, list):
            while len(tree) <= key:
                tree.append({})
            tree = tree[key]
        else:
            tree = tree.setdefault(key, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


def make_params(m: dict, seed: int, device) -> dict:
    """The weights both sides get, in the program's tree, made on `device`
    from `seed`: one standard-normal draw a dtype over one flat buffer,
    each leaf a view of it scaled by its std. The same seed on the same
    device gives the same weights."""
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
        else:                           # A_log: log(1..N) in every channel
            t = torch.log(torch.arange(1, shape[-1] + 1, dtype=dt,
                                       device=device)).expand(shape).clone()
        _put(params, path, t)
    V = m["vocab_size"]
    params["embed"][V:] = 0
    if "lm_head" in params:
        params["lm_head"][V:] = 0
    return params


def named_slices(tree: dict, m: dict):
    """(name, tensor) for every leaf of a tree in the program's layout
    (params, or an optimizer moment or master copy of them), a layer's
    slice of a stacked leaf named by the layer's depth: layers.<l>.<...>."""
    P = period(m)

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k], prefix + (k,))
        else:
            yield prefix, t
    for key in sorted(tree):
        if key != "layers":
            yield key, tree[key]
            continue
        for pos, sub in enumerate(tree["layers"]):
            for path, t in walk(sub, ()):
                for li in range(t.shape[0]):
                    yield (f"layers.{li * P + pos}." + ".".join(path),
                           t[li])


# ---------------------------------------------------------------------------
# Float32 forward
# ---------------------------------------------------------------------------


def _fp8(x):
    """x rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's 448."""
    s = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).to(F32) / s


class Ops:
    """The matrix products of the reference, in float32, or with their
    operands rounded to fp8 (the control)."""

    def __init__(self, quant=None):
        if quant not in (None, "fp8", "route_bf16"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def q(self, x):
        if self.quant != "fp8":
            return x
        return x + (_fp8(x) - x).detach()

    def route(self, x):
        """The router's input."""
        if self.quant != "route_bf16":
            return x
        return x.to(BF16).float()

    def mm(self, eq, a, b):
        return torch.einsum(eq, self.q(a.float()), self.q(b.float()))


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def rope(x, pos, theta):
    """x (B,T,H,d), pos (T,) -> rotated split halves."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, m, ops, rows=None):
    """Causal windowed GQA over the whole sequence of each row; `rows`
    rows of scores at a time."""
    B, T, _ = x.shape
    H, K = m["num_heads"], m["num_kv_heads"]
    hd = p["wq"].shape[-1]
    pos = torch.arange(T, device=x.device)
    q = rope(ops.mm("btd,dhk->bthk", x, p["wq"]), pos, m["rope_theta"])
    k = rope(ops.mm("btd,dhk->bthk", x, p["wk"]), pos, m["rope_theta"])
    v = ops.mm("btd,dhk->bthk", x, p["wv"])
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    lag = pos[:, None] - pos[None, :]
    ok = lag >= 0
    if m.get("sliding_window"):
        ok = ok & (lag < m["sliding_window"])
    rows = rows or B
    outs = []
    for b in range(0, B, rows):
        s = ops.mm("bqhd,bkhd->bhqk", q[b:b + rows], k[b:b + rows])
        s = s / math.sqrt(hd)
        w = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        outs.append(ops.mm("bhqk,bkhd->bqhd", w, v[b:b + rows]))
    o = torch.cat(outs, dim=0)
    return ops.mm("bthk,hkd->btd", o, p["wo"])


def _softplus(x):
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba(p, x, m, ops):
    mb = m["mamba"]
    B, T, D = x.shape
    I, N, dc = mb["expand"] * D, mb["d_state"], mb["d_conv"]
    R = p["dt_proj"].shape[0]
    w = p["in_proj"]
    xin = ops.mm("btd,de->bte", x, w[:, :I])
    z = ops.mm("btd,de->bte", x, w[:, I:])
    pad = torch.cat([xin.new_zeros(B, dc - 1, I), xin], dim=1)
    cw = p["conv_w"].float()
    conv = sum(pad[:, i:i + T] * cw[i] for i in range(dc))
    xc = F.silu(conv + p["conv_b"].float())
    dbc = ops.mm("bti,ir->btr", xc, p["x_proj"])
    dt_r, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = _softplus(ops.mm("btr,ri->bti", dt_r, p["dt_proj"])
                   + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    h = x.new_zeros(B, I, N)
    ys = []
    for t in range(T):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * xc[:, t])[:, :, None] * Bm[:, t, None, :])
        ys.append(torch.einsum("bin,bn->bi", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + xc * p["Dskip"].float()
    y = y * F.silu(z)
    return ops.mm("bti,id->btd", y, p["out_proj"])


def swiglu(p, x, ops):
    g = ops.mm("btd,df->btf", x, p["w_gate"])
    u = ops.mm("btd,df->btf", x, p["w_up"])
    return ops.mm("btf,fd->btd", F.silu(g) * u, p["w_down"])


def moe(p, x, m, ops, groups):
    """Token-choice top-k MoE with per-group capacity; `groups` are the
    (start, end) position ranges routed together, rows in order within
    each."""
    mc = m["moe"]
    E, k = mc["num_experts"], mc["top_k"]
    B, T, D = x.shape
    probs = torch.softmax(ops.mm("btd,de->bte", ops.route(x), p["router"]),
                          dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)                 # (B,T,k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = torch.zeros_like(gates, dtype=torch.bool)
    for s0, s1 in groups:
        g_ids = ids[:, s0:s1].reshape(-1, k)                  # (N,k)
        N = g_ids.shape[0]
        C = max(1, int(mc.get("capacity_factor", 1.25) * k * N / E))
        order = F.one_hot(g_ids.t().reshape(-1), E)           # (k*N,E)
        place = ((torch.cumsum(order, 0) - order) * order).sum(-1)
        keep[:, s0:s1] = (place < C).reshape(k, N).t().reshape(B, s1 - s0, k)
    xt, gt = x.reshape(-1, D), (gates * keep).reshape(-1, k)
    it = ids.reshape(-1, k)
    out = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = torch.nonzero((it == e) & (gt > 0), as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        h = (F.silu(ops.mm("nd,df->nf", xe, p["w_gate"][e]))
             * ops.mm("nd,df->nf", xe, p["w_up"][e]))
        ye = ops.mm("nf,fd->nd", h, p["w_down"][e])
        out.index_add_(0, tok, ye * gt[tok, slot, None])
    return out.reshape(B, T, D)


def block(p, spec, x, m, ops, groups, rows=None):
    eps = m.get("norm_eps", 1e-5)
    h = rms_norm(x, p["ln1"], eps)
    if spec["mixer"] == "attn":
        x = x + attention(p["attn"], h, m, ops, rows)
    else:
        x = x + mamba(p["mamba"], h, m, ops)
    h = rms_norm(x, p["ln2"], eps)
    if spec["ffn"] == "moe":
        return x + moe(p["moe"], h, m, ops, groups)
    return x + swiglu(p["ffn"], h, ops)


def _layer(params, m, li):
    """Layer li's weights: a float32 copy of its slice of each leaf."""
    P = period(m)
    sub = params["layers"][li % P]

    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return t[li // P].float()
    return cut(sub)


def hidden(params, m, tokens, ops, groups, rows=None):
    """Final-normed hidden states (B,T,D) of a forward over `tokens`,
    layer by layer, each layer's weights made float32 as it runs."""
    specs = block_specs(m)
    x = params["embed"][tokens].float()
    for li in range(m["num_layers"]):
        x = block(_layer(params, m, li), specs[li % len(specs)], x, m, ops,
                  groups, rows)
    return rms_norm(x, params["final_norm"], m.get("norm_eps", 1e-5))


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# Serving: logits of the served tokens, teacher-forced
# ---------------------------------------------------------------------------


@torch.no_grad()
def served_logits(params, m, prompts, served, quant=None, rows=None):
    """Logits (B, G, V) over the real vocabulary that predict each served
    token, from one forward over the prompts and the served tokens before
    the last. Routing groups: the prompts together, then each generated
    position across the rows, as the program routes its prefill and its
    decode steps."""
    B, P = prompts.shape
    G = served.shape[1]
    tokens = torch.cat([prompts, served[:, :G - 1]], dim=1)
    groups = [(0, P)] + [(P + j, P + j + 1) for j in range(G - 1)]
    ops = Ops(quant)
    with exact_float32():
        h = hidden(params, m, tokens, ops, groups, rows)[:, P - 1:]
        head = params.get("lm_head", params["embed"])[:m["vocab_size"]]
        return ops.mm("bgd,vd->bgv", h, head)


def token_gap(logits, tokens):
    """How far each token's logit lies below the row's best, (B, G)."""
    V = logits.shape[-1]
    bad = (tokens < 0) | (tokens >= V)
    got = logits.gather(-1, tokens.clamp(0, V - 1)[..., None])[..., 0]
    gap = logits.amax(-1) - got
    return torch.where(bad, torch.full_like(gap, float("inf")), gap)


# ---------------------------------------------------------------------------
# Training: the first steps of AdamW on the same batches
# ---------------------------------------------------------------------------


def cosine_lr(opt: dict, step: int) -> float:
    lr, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return lr * min(step / max(warm, 1), 1.0)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def train_readings(params, m, batches, opt: dict, quant=None,
                   start_step: int = 0) -> dict:
    """Losses of the first len(batches) steps, each leaf's first (clipped)
    gradient and its change over all of them, of a float32 model made
    from `params` (the program's starting weights, left unchanged) under
    AdamW with a float32 master, its step counter (the learning rate and
    the bias corrections) starting at `start_step`. `param_change` is the
    change of the working weights, the master rounded to the params'
    dtype. A row a pass, each layer recomputed in the backward."""
    specs = block_specs(m)
    ops = Ops(quant)
    names = [n for n, _ in named_slices(params, m)]
    start = dict(named_slices(params, m))
    w = {n: start[n].float().clone().requires_grad_() for n in names}
    mom = {n: torch.zeros_like(t) for n, t in w.items()}
    vel = {n: torch.zeros_like(t) for n, t in w.items()}
    eps = m.get("norm_eps", 1e-5)
    V = m["vocab_size"]
    out = {"loss": [], "grad": {}, "change": {}, "param_change": {}}

    def layer(li):
        pre = f"layers.{li}."
        sub: dict = {}
        for n in names:
            if n.startswith(pre):
                _put(sub, tuple(n[len(pre):].split(".")), w[n])
        return sub

    def run_block(x, li):
        return block(layer(li), specs[li % len(specs)], x, m, ops,
                     [(0, x.shape[1])])

    with exact_float32():
        for step, batch in enumerate(batches, start=start_step + 1):
            tokens, labels = batch["tokens"], batch["labels"]
            B = tokens.shape[0]
            loss = 0.0
            for b in range(B):
                x = w["embed"][tokens[b:b + 1]]
                for li in range(m["num_layers"]):
                    x = checkpoint(run_block, x, li, use_reentrant=False)
                x = rms_norm(x, w["final_norm"], eps)
                head = w.get("lm_head", w["embed"])[:V]
                logits = ops.mm("btd,vd->btv", x, head)
                ce = F.cross_entropy(logits[0], labels[b])
                (ce / B).backward()
                loss += ce.item() / B
            out["loss"].append(loss)
            with torch.no_grad():
                grads = {n: t.grad for n, t in w.items()}
                gnorm = math.sqrt(sum(float(g.square().sum())
                                      for g in grads.values()))
                scale = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0)
                lr = cosine_lr(opt, step)
                b1, b2 = opt["b1"], opt["b2"]
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for n, t in w.items():
                    g = grads[n] * scale
                    if step == start_step + 1:
                        out["grad"][n] = float(g.norm())
                    mom[n].mul_(b1).add_(g, alpha=1 - b1)
                    vel[n].mul_(b2).add_(g.square(), alpha=1 - b2)
                    u = (mom[n] / bc1) / ((vel[n] / bc2).sqrt() + opt["eps"])
                    t.sub_(lr * (u + opt["weight_decay"] * t))
                    t.grad = None
        with torch.no_grad():
            for n, t in w.items():
                s0 = start[n].float()
                out["change"][n] = float((t - s0).norm())
                out["param_change"][n] = float(
                    (t.to(start[n].dtype).float() - s0).norm())
    return out
