"""Serving cells: the program's batch-serving entry
(`repro_torch.launch.serve.serve`) on the benchmark's weights, one batch
in flight at a time (the port has no admission queue), each batch's
prompts drawn from the seed.

Set-up makes the weights and the prompt pool and serves one whole batch
at the cell's shapes. The window serves batches back to back. Once it
has closed, the float32 reference reads the prompts and served tokens of
`check_batches` of the window's batches, drawn from the seed. Numbers:
`gap`, the widest gap by which a served token's logit lies below the
reference's best at its position, `gap_mean`, the mean of those gaps
over the served tokens, and `share_over_0.5`, the share of served tokens
whose gap is over 0.5; a cell's check file says which it compares.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import bench, generate

# what the traced run annotates: each prefill and decode step made by
# serve's factories
FACTORIES = {"repro_torch.launch.serve:make_prefill": "prefill",
             "repro_torch.launch.serve:make_serve_step": "decode_step"}


def serve_batches(cell, params, pool, count=None, window=None):
    """Serve pool batches in turn: `count` of them, or in `window` until
    its seconds have passed. Returns [(start, end, stats, tokens)]."""
    from repro_torch.launch import serve as S
    tr = cell.traffic
    B, P, G = tr["batch"], tr["prompt_len"], tr["gen"]
    clock = window.clock if window is not None else None
    done = []
    while True:
        tb = clock() if clock else 0.0
        toks, stats, logits = S.serve(
            cell.model_config(), batch=B, prompt_len=P, gen=G,
            params=params, prompts=pool[len(done) % len(pool)],
            device=cell.device)
        del logits
        te = clock() if clock else 0.0
        done.append((tb, te, stats, toks))
        if window is None:
            if len(done) == count:
                return done
        elif te - window.t0 >= cell.seconds:
            return done


def gaps(cell, params, pool, done, picks, quant=None) -> list:
    """Per picked batch, the served tokens' gaps (B, G) below the
    reference's best; with `quant`, the gaps of the tokens that the
    control (the reference in that precision) puts first instead. A
    reference module's `BATCHES_A_FORWARD` picked batches go through one
    forward, each routed as the batch it was served in."""
    ref, m, B = cell.reference, cell.model, cell.traffic["batch"]
    per = getattr(ref, "BATCHES_A_FORWARD", 1)
    kw = {"batch": B} if per > 1 else {}
    out = []
    for j in range(0, len(picks), per):
        chunk = picks[j:j + per]
        prompts = torch.cat([pool[i % len(pool)] for i in chunk])
        served = torch.cat([done[i][3] for i in chunk])
        logits = ref.served_logits(params, m, prompts, served, **kw)
        if quant is None:
            found = ref.token_gap(logits, served)
        else:
            low = ref.served_logits(params, m, prompts, served, quant=quant,
                                    **kw)
            found = ref.token_gap(logits, low.argmax(-1))
            del low
        del logits
        out.extend(found.split(B))
    return out


def numbers(found) -> dict:
    flat = torch.cat([g.flatten() for g in found])
    return {"gap": float(flat.max()), "gap_mean": float(flat.mean()),
            "share_over_0.5": float((flat > 0.5).float().mean())}


def picks(cell, n_batches: int) -> list:
    k = min(cell.traffic["check_batches"], n_batches)
    rng = np.random.default_rng([cell.seed, 2])
    return sorted(rng.choice(n_batches, size=k, replace=False).tolist())


def run(cell, window) -> dict:
    ref, m, tr, dev = cell.reference, cell.model, cell.traffic, cell.device
    B, P, G = tr["batch"], tr["prompt_len"], tr["gen"]
    params = ref.make_params(m, cell.seed, dev)
    pool = generate.prompt_batches(tr, m["vocab_size"], cell.seed, dev)
    serve_batches(cell, params, pool, count=1)          # warm-up
    with window.open():
        done = serve_batches(cell, params, pool, window=window)
    elapsed = window.elapsed
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batch_s = [te - tb for tb, te, _, _ in done]
    lat = [t for t in batch_s for _ in range(B)]
    series = {"batch_s": batch_s,
              "prefill_s": [d[2]["prefill_s"] for d in done],
              "decode_s": [d[2]["decode_s"] for d in done]}
    found = gaps(cell, params, pool, done, picks(cell, len(done)))
    return {"attempted": len(done) * B, "failed": 0, "window_s": elapsed,
            "e2e": {"serve_tokens_per_s": len(done) * B * (P + G) / elapsed,
                    "request_p95_ms": bench.nearest_rank(lat, 0.95) * 1e3},
            "work": {"kind": "serve", "batches": len(done), "batch": B,
                     "prompt_len": P, "gen": G,
                     "prefill_s": series["prefill_s"],
                     "decode_s": series["decode_s"]},
            "series": series,
            "numbers": numbers(found),
            "memory_peak_bytes": peak}
