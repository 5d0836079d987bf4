"""The traffic generator: token batches drawn from a cell's seed.

`zipf_markov` is a copy of the program's synthetic language
(`repro_torch.data.pipeline.StorageNodeDataset`, distribution
"zipf_markov"): a Zipfian unigram law over a permuted vocabulary, and a
first-order chain that follows a fixed permutation with probability
`jump` and draws a fresh Zipfian token otherwise. Here it draws all rows
of a batch at once, from a generator seeded by (seed, stream), so that
every seed gives the same sizes in another order of tokens.
"""
from __future__ import annotations

import numpy as np
import torch


def zipf_markov(vocab: int, rows: int, length: int, seed: int, stream: int,
                jump: float = 0.75) -> np.ndarray:
    """(rows, length) int64 tokens."""
    perm = np.random.default_rng([seed, 0]).permutation(vocab)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    p /= p.sum()
    rng = np.random.default_rng([seed, 1, stream])
    out = np.empty((rows, length), dtype=np.int64)
    out[:, 0] = rng.choice(vocab, size=rows, p=p)
    jumps = rng.random((rows, length - 1)) < jump
    fresh = rng.choice(vocab, size=(rows, length - 1), p=p)
    for t in range(length - 1):
        out[:, t + 1] = np.where(jumps[:, t], perm[out[:, t]], fresh[:, t])
    return out


def tokens(traffic: dict, vocab: int, seed: int, stream: int, rows: int,
           length: int) -> np.ndarray:
    spec = traffic["tokens"]
    if spec["distribution"] != "zipf_markov":
        raise ValueError(f"unknown token distribution "
                         f"{spec['distribution']!r}")
    return zipf_markov(vocab, rows, length, seed, stream, spec["jump"])


def train_batches(traffic: dict, vocab: int, seed: int, device) -> list:
    """`pool` distinct batches of {"tokens", "labels"} (batch, seq_len):
    the first steps take them in order, the window cycles through them."""
    B, S = traffic["batch"], traffic["seq_len"]
    out = []
    for i in range(traffic["pool"]):
        t = torch.from_numpy(tokens(traffic, vocab, seed, i, B, S + 1))
        out.append({"tokens": t[:, :-1].to(device),
                    "labels": t[:, 1:].to(device)})
    return out


def prompt_batches(traffic: dict, vocab: int, seed: int, device) -> list:
    """`pool` distinct (batch, prompt_len) prompt batches; the window
    cycles through them."""
    B, P = traffic["batch"], traffic["prompt_len"]
    return [torch.from_numpy(tokens(traffic, vocab, seed, i, B, P)).to(device)
            for i in range(traffic["pool"])]
