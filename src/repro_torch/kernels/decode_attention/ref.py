"""Plain PyTorch version of single-token GQA decode attention.

A copy of `repro/kernels/decode_attention/ref.py::decode_attention_ref`.
"""
import math

import torch


def decode_attention_ref(q, k, v, bias):
    """q (B,1,H,d), k/v (B,W,K,d), bias (B,W) additive fp32 (mask).

    Returns (B,1,H,d) in v's dtype. A bf16 cache under a float32 q is
    promoted for the scores, as jnp.einsum promotes mixed dtypes.
    """
    B, _, H, d = q.shape
    K = k.shape[2]
    g = H // K
    qg = q.reshape(B, 1, K, g, d)
    ct = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("bskgd,btkd->bkgst", qg.to(ct), k.to(ct)).float()
    s = s / math.sqrt(d) + bias[:, None, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, 1, H, d)
