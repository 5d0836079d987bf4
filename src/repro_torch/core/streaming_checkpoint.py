"""Chunked streaming checkpoint (Lovelock §5.3), port of
`repro.core.streaming_checkpoint`.

Peak host memory during training hits ~2x the model-shard size at
checkpoint time when the whole snapshot is staged in host DRAM before it
reaches storage. The paper's fix, "split model parameters into chunks and
checkpoint a stream of these chunks", is what lets a 16-48 GB smart NIC
drive 2-4 accelerators. This module implements it:

  * leaves are streamed to disk in fixed-size chunks (default 64 MiB), each
    a row slice of the leaf copied from the device on its own;
  * at most `buffers` chunks are in flight (submitted and not yet written),
    so the host memory overhead is O(chunk), not O(model);
  * every chunk carries a sha256; the manifest is committed atomically
    (write to `.tmp_step_*`, then `os.replace`), so a crash mid-checkpoint
    leaves the previous checkpoint intact;
  * restore reads chunk by chunk into a tensor allocated on the device.

The on-disk format is the reference's, so either package restores what the
other wrote: `step_%08d/manifest.json` holds `{"step", "leaves": {path:
{"file", "dtype", "shape", "chunks": [{"offset", "nbytes", "sha256",
"row0"}]}}}` and each leaf's raw bytes are in `leaf_%05d.bin`. Leaf paths
are the ones `jax.tree_util.tree_flatten_with_path` gives: dict keys,
list indices and NamedTuple field names joined by "/", None leaves absent.
dtypes are numpy names ("float32", "bfloat16", ...); bfloat16 is stored as
its 16-bit patterns. A Python int leaf (the `TrainState` step) is stored
as a 0-d int32 array and restored as an int.

Under a mesh the leaves are DTensors and the checkpoint holds their global
tensors, in the same format: every rank takes part in gathering a leaf,
rank 0 alone writes it, and all ranks meet after the commit. Restore reads
the global tensor on every rank and keeps the rank's shard, in the
placements of the `like` leaf.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import queue
import shutil
import threading
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

Pytree = Any

# the chunk unit of `repro.core.costmodel.CKPT_CHUNK_BYTES`: the simulator
# prices preemption spill and restore with the same chunk model
CKPT_CHUNK_BYTES = 64 * 1024 * 1024
DEFAULT_CHUNK = CKPT_CHUNK_BYTES


@dataclasses.dataclass
class CkptMetrics:
    bytes_written: int = 0
    n_chunks: int = 0
    peak_buffer_bytes: int = 0
    n_leaves: int = 0


class _Writer(threading.Thread):
    """Background chunk writer. At most `nbuf` chunks are submitted and not
    yet written: `submit` blocks until a slot frees (the double buffer)."""

    def __init__(self, nbuf: int):
        super().__init__(daemon=True)
        self.q: queue.Queue = queue.Queue()
        self.err: Optional[BaseException] = None
        self.inflight_bytes = 0
        self.peak = 0
        self._slots = threading.Semaphore(nbuf)
        self._lock = threading.Lock()

    def submit(self, fh, data: bytes):
        self._slots.acquire()
        with self._lock:
            self.inflight_bytes += len(data)
            self.peak = max(self.peak, self.inflight_bytes)
        self.q.put((fh, data))

    def run(self):
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                fh, data = item
                try:
                    if self.err is None:     # after a failure: discard
                        fh.write(data)
                except Exception as e:  # noqa: BLE001  re-raised by drain
                    self.err = e
                finally:
                    with self._lock:
                        self.inflight_bytes -= len(data)
                    self._slots.release()
            finally:
                self.q.task_done()

    def drain(self):
        """Block until all submitted chunks are written (before the file
        closes)."""
        self.q.join()
        if self.err:
            raise self.err

    def finish(self):
        self.q.put(None)
        self.join()
        if self.err:
            raise self.err


def _leaf_paths(tree: Pytree, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) in `jax.tree_util.tree_flatten_with_path` order: dict
    keys sorted, lists and NamedTuples in order; None is an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaf_paths(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten(like: Pytree, leaves: Iterator) -> Pytree:
    """A tree of `like`'s structure holding `leaves` in `_leaf_paths`
    order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, DTensor):
        return leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return torch.tensor(leaf, dtype=torch.int32)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype ("float32", "bfloat16", ...)."""
    return str(t.dtype).removeprefix("torch.")


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """The raw bytes of a contiguous tensor, as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


class StreamingCheckpointer:
    def __init__(self, directory, *, chunk_bytes: int = DEFAULT_CHUNK,
                 buffers: int = 2, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.chunk_bytes = chunk_bytes
        self.buffers = buffers
        self.keep = keep
        self.metrics = CkptMetrics()

    # -------------------------------------------------- save

    def save(self, step: int, tree: Pytree) -> pathlib.Path:
        """Write `tree` as step `step`. A tree of DTensors is a collective:
        every rank of the process group calls it; rank 0 writes."""
        self.metrics = CkptMetrics()
        tmp = self.dir / f".tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"
        sharded = any(isinstance(x, DTensor) for _, x in _leaf_paths(tree))
        if sharded and dist.get_rank() != 0:
            for _, leaf in _leaf_paths(tree):   # the writer's gathers
                if isinstance(leaf, DTensor):
                    leaf.full_tensor()
            dist.barrier()                       # after its commit
            return final
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        writer = _Writer(self.buffers)
        writer.start()
        manifest: dict = {"step": int(step), "leaves": {}}
        try:
            for li, (lpath, leaf) in enumerate(_leaf_paths(tree)):
                leaf = _as_tensor(leaf)
                fname = f"leaf_{li:05d}.bin"
                rows_per_chunk = self._rows_per_chunk(leaf)
                chunks = []
                with open(tmp / fname, "wb") as fh:
                    n = leaf.shape[0] if leaf.ndim else 1
                    off = 0
                    for start in range(0, max(n, 1), rows_per_chunk):
                        sl = (leaf[start:start + rows_per_chunk]
                              if leaf.ndim else leaf)
                        # device -> host copy of ONE chunk (the bound)
                        buf = _bytes_of(sl.cpu().contiguous()).numpy() \
                            .tobytes()
                        sha = hashlib.sha256(buf).hexdigest()
                        chunks.append({"offset": off, "nbytes": len(buf),
                                       "sha256": sha, "row0": start})
                        writer.submit(fh, buf)
                        off += len(buf)
                        self.metrics.bytes_written += len(buf)
                        self.metrics.n_chunks += 1
                    writer.drain()   # all chunks written before close
                manifest["leaves"][lpath] = {
                    "file": fname, "dtype": _dtype_name(leaf),
                    "shape": list(leaf.shape), "chunks": chunks}
                self.metrics.n_leaves += 1
        finally:
            writer.finish()
        self.metrics.peak_buffer_bytes = writer.peak
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():        # idempotent re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)                    # atomic commit
        self._gc()
        if sharded:
            dist.barrier()
        return final

    def _rows_per_chunk(self, leaf: torch.Tensor) -> int:
        if leaf.ndim == 0:
            return 1
        row_bytes = max(1, leaf.nbytes // max(leaf.shape[0], 1))
        return max(1, self.chunk_bytes // row_bytes)

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Pytree, step: Optional[int] = None,
                verify: bool = True) -> Pytree:
        """Restore into the structure of `like` (the latest step unless
        `step` is given).

        Each tensor leaf is allocated anew on the device of `like`'s leaf,
        with the checkpoint's dtype and shape, and filled one chunk at a
        time; where `like`'s leaf is a DTensor, the rank keeps its shard in
        that leaf's placements. An int leaf of `like` comes back as an int.
        Raises OSError when a chunk's sha256 does not match (with
        `verify`).
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = []
        for lpath, leaf in _leaf_paths(like):
            meta = manifest["leaves"][lpath]
            device = (leaf.device if isinstance(leaf, torch.Tensor)
                      else torch.device("cpu"))
            val = torch.empty(meta["shape"],
                              dtype=getattr(torch, meta["dtype"]),
                              device=device)
            dst = _bytes_of(val)
            with open(d / meta["file"], "rb") as fh:
                for ch in meta["chunks"]:
                    fh.seek(ch["offset"])
                    buf = fh.read(ch["nbytes"])
                    if verify and hashlib.sha256(buf).hexdigest() != \
                            ch["sha256"]:
                        raise OSError(
                            f"checksum mismatch {lpath} @{ch['offset']}")
                    if buf:
                        dst[ch["offset"]:ch["offset"] + len(buf)].copy_(
                            torch.frombuffer(bytearray(buf),
                                             dtype=torch.uint8))
            if isinstance(leaf, DTensor):
                val = distribute_tensor(val, leaf.device_mesh,
                                        leaf.placements, src_data_rank=None)
            leaves.append(val if isinstance(leaf, torch.Tensor)
                          else int(val))
        return _unflatten(like, iter(leaves))
