"""Plain PyTorch version of the Mamba selective scan, in float32:

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ,   y_t = C_t . h_t

`mamba_ssm_chunked`, a copy of `repro/models/layers.py::_mamba_ssm_chunked`
with `lax.associative_scan` written as a doubling scan: the kernel's plain
version, the form the CPU runs, and the kernel's backward is its autograd.
"""
import torch

MAMBA_CHUNK = 256


def chunking(S):
    """(number of chunks, chunk length) of a sequence of S tokens: chunks
    of c = S // max(1, S // MAMBA_CHUNK) tokens. Raises unless S is a
    whole number of them, as the reference's reshape needs."""
    nchunk = max(1, S // MAMBA_CHUNK)
    c = S // nchunk
    if nchunk * c != S:
        raise ValueError(f"sequence length {S} is not a multiple of its "
                         f"{nchunk} chunks")
    return nchunk, c


def _scan_pairs(a, b):
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under the
    reference's combine (a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2): the
    log-step (Hillis-Steele) doubling, ceil(log2 c) vectorised steps in
    place of `lax.associative_scan`'s tree (the same function, rounded in
    another order)."""
    c, s = a.shape[1], 1
    while s < c:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def mamba_ssm_chunked(dt, A, Bm, Cm, xin, h0):
    """h_t = exp(dt_t*A) h_{t-1} + dt_t*B_t*x_t ; y_t = C_t . h_t.

    dt,xin: (B,S,I)  Bm,Cm: (B,S,Nst)  A: (I,Nst)  h0: (B,I,Nst)
    Returns y (B,S,I), h_final. Chunks of c = S // max(1, S // 256) tokens
    (S must be a multiple of their count, as the reference's reshape
    needs); dA and dBx, (B,c,I,Nst) each, are formed a chunk at a time
    where the reference forms them for all of S at once.
    """
    nchunk, c = chunking(xin.shape[1])
    h, ys = h0, []
    for i in range(nchunk):
        sl = slice(i * c, (i + 1) * c)
        dA = torch.exp(dt[:, sl, :, None] * A)                 # (B,c,I,N)
        dBx = (dt[:, sl] * xin[:, sl])[..., None] * Bm[:, sl, None, :]
        aa, bb = _scan_pairs(dA, dBx)
        del dA, dBx
        h_all = aa * h[:, None] + bb                           # (B,c,I,N)
        del aa, bb
        ys.append(torch.einsum("bcin,bcn->bci", h_all, Cm[:, sl]))
        h = h_all[:, -1].clone()
        del h_all
    return torch.cat(ys, dim=1), h
