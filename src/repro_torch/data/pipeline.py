"""Storage-node data pipeline (Lovelock §3: storage nodes serve shards).

A copy of `repro.data.pipeline` (numpy only; the port imports nothing of
`repro`). The global batch must be a multiple of the storage nodes (4 by
default).

The dataset is partitioned across logical *storage nodes*; each training
host requests the shard ranges it owns for the step.  Synthetic mode is
fully deterministic in (node, step) — the substrate for tests, examples and
benchmarks without external data.  A bounded prefetch queue keeps host
memory O(queue) (the same bounded-memory discipline as the streaming
checkpointer).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np


class StorageNodeDataset:
    """Deterministic synthetic token shards served by N storage nodes."""

    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 n_storage_nodes: int = 4, seed: int = 0,
                 distribution: str = "uniform"):
        if global_batch % n_storage_nodes:
            raise ValueError(f"global batch {global_batch} must split "
                             f"across {n_storage_nodes} storage nodes")
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.nodes = n_storage_nodes
        self.seed = seed
        self.distribution = distribution
        if distribution == "zipf_markov":
            # a learnable synthetic language: Zipfian unigram marginals +
            # first-order structure token_{t+1} ~ f(token_t). CE can drop
            # well below ln(V), so loss curves are meaningful.
            rng = np.random.default_rng(seed)
            self._perm = rng.permutation(vocab_size).astype(np.int32)
            ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
            p = 1.0 / ranks
            self._zipf = p / p.sum()

    def _node_shard(self, node: int, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + node) * 2_654_435_761 + step)
        rows = self.batch // self.nodes
        if self.distribution == "uniform":
            return rng.integers(0, self.vocab, (rows, self.seq + 1),
                                dtype=np.int32)
        # zipf_markov: x_{t+1} = perm[x_t] with prob .75, else Zipf sample
        out = np.empty((rows, self.seq + 1), dtype=np.int32)
        out[:, 0] = rng.choice(self.vocab, size=rows, p=self._zipf)
        jump = rng.random((rows, self.seq)) < 0.75
        fresh = rng.choice(self.vocab, size=(rows, self.seq), p=self._zipf)
        for t in range(self.seq):
            out[:, t + 1] = np.where(jump[:, t], self._perm[out[:, t]],
                                     fresh[:, t])
        return out

    def fetch_step(self, step: int) -> dict:
        """Gather the step's global batch from all storage nodes."""
        toks = np.concatenate([self._node_shard(n, step)
                               for n in range(self.nodes)], axis=0)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.fetch_step(step)
            step += 1


class Prefetcher:
    """Background prefetch with a bounded queue (double buffering)."""

    def __init__(self, it: Iterator, depth: int = 2,
                 put_fn: Optional[callable] = None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self.put_fn = put_fn or (lambda x: x)

        def work():
            try:
                for item in it:
                    if self._stop.is_set():
                        break
                    self.q.put(self.put_fn(item))
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self.q.put(None)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker (an endless source never ends it) and join it,
        draining the queue so that a blocked put returns."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self.t.is_alive() and time.monotonic() < deadline:
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.01)
        if self.t.is_alive():
            raise RuntimeError("Prefetcher: the worker did not stop")

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self._err:
                raise self._err
            raise StopIteration
        return item
