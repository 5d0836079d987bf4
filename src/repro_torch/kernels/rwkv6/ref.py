"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence, in float32:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(logw_t) in (0,1]
    o_t = r_t . (S_{t-1} + (u * k_t) v_t^T)

`wkv6_ref`, the per-token loop, is a copy of
`repro/kernels/rwkv6/ref.py::wkv6_ref`: the kernel's plain version.
`wkv6_chunked`, the chunked parallel form, is a copy of
`repro/models/layers.py::_wkv6_chunked`: the layers run it where the kernel
does not (with a state), and the kernel's backward is its autograd.
"""
import torch

RWKV_CHUNK = 64


def wkv6_ref(r, k, v, logw, u, S0):
    """r,k,v,logw (B,H,S,d); u (H,d); S0 (B,H,d,d). Returns (o, S_final)."""
    S = r.shape[2]
    Sm = S0
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]           # (B,H,d,d)
        o = torch.einsum("bhd,bhde->bhe", rt, Sm) \
            + torch.einsum("bhd,hd,bhd,bhe->bhe", rt, u, kt, vt)
        Sm = torch.exp(wt)[..., :, None] * Sm + kv
        outs.append(o)
    return torch.stack(outs, dim=2), Sm


def wkv6_chunked(r, k, v, logw, u, S0):
    """r,k,v,logw: (B,H,S,d)  u: (H,d)  S0: (B,H,d,d)  ->  (out, S_final),
    S a multiple of the chunk min(RWKV_CHUNK, S).

    All decay exponents are differences of a running cumsum and are <= 0,
    so the chunked form is overflow-free by construction.
    """
    B, H, S, d = r.shape
    c = min(RWKV_CHUNK, S)
    nch = S // c
    if nch * c != S:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {c}")

    def chunks(x):
        return x.reshape(B, H, nch, c, d).permute(2, 0, 1, 3, 4)
    rs, ks, vs, lws = (chunks(x) for x in (r, k, v, logw))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     -1)                                   # i < t strictly
    S_ = S0
    outs = []
    for rc, kc, vc, lw in zip(rs, ks, vs, lws):            # (B,H,c,d)
        clw = torch.cumsum(lw, dim=2)
        clw_prev = clw - lw                                 # sum_{i<t}
        # intra-chunk scores: P[t,i,d] = exp(clw_prev[t] - clw[i]),  i < t
        diff = clw_prev[:, :, :, None, :] - clw[:, :, None, :, :]
        P = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  -torch.inf))
        att = torch.einsum("bhtd,bhtid,bhid->bhti", rc, P, kc)
        out = torch.einsum("bhti,bhie->bhte", att, vc)
        # bonus diagonal term: (r_t . (u * k_t)) v_t
        out = out + torch.einsum("bhtd,hd,bhtd,bhte->bhte", rc, u, kc, vc)
        # inter-chunk: r~_t = r_t * exp(clw_prev[t])
        out = out + torch.einsum("bhtd,bhde->bhte", rc * torch.exp(clw_prev),
                                 S_)
        # state update: S = exp(clw[-1]) S0 + sum_i exp(clw[-1]-clw[i]) k_i v_i
        wtot = clw[:, :, -1:, :]
        Kdec = kc * torch.exp(wtot - clw)
        S_ = (torch.exp(wtot.squeeze(2))[..., None] * S_
              + torch.einsum("bhid,bhie->bhde", Kdec, vc))
        outs.append(out)
    out = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(B, H, S, d)
    return out, S_
