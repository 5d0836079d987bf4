"""Run the PyTorch port on several gloo ranks on localhost: the harness
(`run_ranks`) and the code each rank runs (the `rank_*` functions).

Each rank is a subprocess with one thread, jax and `repro` blocked from
import, and a process group initialised from a `file://` store in the
test's own directory (never a fixed port: the suite runs several workers
at once). It calls one `rank_*` function of this module and prints its
JSON result. A rank that fails or hangs ends all of them and fails the
test.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

_MAIN = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {tests!r}]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, fn, args = sys.argv[1:]
dist.init_process_group("gloo", init_method="file://" + store,
                        rank=int(rank), world_size=int(world))
try:
    import _torch_dist
    out = getattr(_torch_dist, fn)(*json.loads(args))
    dist.barrier()
finally:
    dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
# gloo's threads can abort the interpreter's teardown ("terminate called
# without an active exception"): the work is done, leave without it
os._exit(0)
"""


def run_ranks(n: int, fn: str, tmp_path, *args, timeout: float = 120):
    """`fn(*args)` of this module on `n` gloo ranks; their results, by
    rank. Raises AssertionError if a rank fails or all have not finished
    within `timeout` seconds (then every rank is killed)."""
    code = _MAIN.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    store = Path(tmp_path) / f"store_{fn}_{time.monotonic_ns()}"
    logs, procs = [], []
    for r in range(n):
        out = open(Path(tmp_path) / f"{fn}_rank{r}.out", "w+")
        err = open(Path(tmp_path) / f"{fn}_rank{r}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(n), str(store), fn,
             json.dumps(args)], stdout=out, stderr=err,
            env={**os.environ, "OMP_NUM_THREADS": "1"}))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    # report the rank that failed first, not one killed after it
    order = sorted(range(n), key=lambda r: procs[r].returncode in (0, -9))
    for r in order:
        text, etext = texts[r]
        assert procs[r].returncode == 0, (
            f"{fn} rank {r} of {n}: exit {procs[r].returncode} (a hung rank "
            f"is killed after {timeout} s)\n{text[-3000:]}\n{etext[-6000:]}")
    return [json.loads([x for x in text.splitlines()
                        if x.startswith("RESULT ")][-1][len("RESULT "):])
            for text, _ in texts]


# ---------------------------------------------------------------------------
# The numpy re-enactment of the reference's quantized psum
# (src/repro/core/collectives.py:43-53), in float32
# ---------------------------------------------------------------------------


def bf16_round(a) -> np.ndarray:
    """float32 values rounded to bfloat16 (round to nearest even), still
    as float32."""
    b = np.asarray(a, np.float32).view(np.uint32)
    # finite values stay below 2^32 after the rounding increment
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def quantized_psum_np(xs, efs, ef_bf16=False):
    """xs, efs: one float32 array per pod (the same leaf). Returns (the
    mean every pod gets, each pod's new ef), as the reference computes
    them, all float32; with `ef_bf16` the new ef is rounded to bf16."""
    f32 = np.float32
    vals = [np.asarray(x, f32) + np.asarray(e, f32) for x, e in zip(xs,
                                                                  efs)]
    scale = max(f32(np.max(np.abs(v))) for v in vals) / f32(127.0)
    scale = np.maximum(f32(scale), f32(1e-12))
    qs = [np.clip(np.round(v / scale), -127, 127).astype(f32) for v in vals]
    new_efs = [v - q * scale for v, q in zip(vals, qs)]
    if ef_bf16:
        new_efs = [bf16_round(e) for e in new_efs]
    summed = sum(q.astype(np.int16) for q in qs).astype(f32)
    return summed * scale / f32(len(xs)), new_efs


# ---------------------------------------------------------------------------
# Rank code
# ---------------------------------------------------------------------------


def _cfg(arch, f32):
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    cfg = smoke_variant(get_config(arch))
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def _batches(cfg, n, B, S, seed=1):
    """n batches of B x S random tokens; the cross-attention families also
    get random N(0, 1) image embeddings or audio frames."""
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        b = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
        if cfg.encoder_layers or cfg.cross_attn_every:
            key = "audio_frames" if cfg.encoder_layers else "image_embeds"
            T = cfg.num_audio_frames or cfg.num_image_tokens
            b["extra"] = {key: torch.from_numpy(rng.standard_normal(
                (B, T, cfg.d_model)).astype(np.float32)).to(
                getattr(torch, cfg.compute_dtype))}
        out.append(b)
    return out


def _live_gates(params):
    """The VLM's cross-attention gates set to 1 (tanh(0) = 0 at init
    leaves the cross path dead)."""
    import torch
    for layer in params["layers"]:
        for p in layer.values():
            if isinstance(p, dict) and "gate" in p:
                p["gate"] = torch.ones_like(p["gate"])
    return params


def _max_rel(got, want):
    """Largest |got - want| over the largest |want|, over tree leaves."""
    from repro_torch.tree import tree_leaves
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def rank_gspmd_parity(arch, shape, names, steps, f32, B=8, S=16):
    """`steps` gspmd steps on a mesh of `shape` / `names` and the same
    steps on one device from the same params and batches: both runs'
    losses and the params' largest difference after them."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding.rules import (ShardingRules, gather, place,
                                            state_specs)
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_map
    cfg = _cfg(arch, f32)
    mesh = make_mesh(tuple(shape), tuple(names))
    rules = ShardingRules(mesh)
    tp = dict(zip(names, shape)).get("model", 1)
    params = _live_gates(M.init_params(torch.Generator().manual_seed(0), cfg,
                                       tp=tp))
    oc = OptimizerConfig(lr=1e-3, warmup=2, total_steps=10)
    batches = _batches(cfg, steps, B, S)
    out = {}
    for meshed in (True, False):
        state = adamw_init(tree_map(torch.clone, params), oc)
        if meshed:
            state = place(state, state_specs(state, mesh), mesh)
        step = make_train_step(cfg, oc, rules if meshed else None)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out[meshed] = (losses, gather(state.params))
    return {"losses": out[True][0], "ref_losses": out[False][0],
            "param_err": _max_rel(out[True][1], out[False][1])}


def rank_compressed_vs_gspmd(arch, steps, B=8, S=32):
    """The reference's test_compressed_pod_train_step_matches_gspmd on the
    port: `steps` steps of each sync on a (2, 2, 2) mesh from the same
    params and batches (bf16); the losses, and the ef's finiteness and
    largest |ef| after the compressed run."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding.rules import (ShardingRules, gather, place,
                                            state_specs)
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = _cfg(arch, False)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    rules = ShardingRules(mesh)
    oc = OptimizerConfig(lr=1e-3)
    batches = _batches(cfg, steps, B, S)
    out = {}
    for mode in ("gspmd", "compressed_pod"):
        comp = mode == "compressed_pod"
        params = M.init_params(torch.Generator().manual_seed(0), cfg, tp=2)
        state = adamw_init(params, oc, with_ef=comp)
        state = place(state, state_specs(state, mesh, fsdp_pod=not comp),
                      mesh)
        step = make_train_step(cfg, oc, rules, grad_sync=mode)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out[mode] = losses
    ef = [t.float() for t in tree_leaves(gather(state.ef))]
    out["ef_finite"] = all(bool(torch.isfinite(t).all()) for t in ef)
    out["ef_max"] = max(float(t.abs().max()) for t in ef)
    return out


def rank_all_reduce(R, N, seed=0):
    """flat_all_reduce and hierarchical_all_reduce on a (2, 2, 2) mesh of
    an (R, N) replica array made from `seed`; each returns its (1, N) sum
    and the bytes this rank handed to collectives whose group spans
    pods."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    pod_of = {int(r): i for i, plane in enumerate(mesh.mesh.tolist())
              for row in plane for r in row}
    x = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((R, N), np.float32))
    crossing = []

    def counted(fn):
        """fn, counting the bytes it sends (all_reduce's tensor, the
        others' input) where its group spans pods."""
        def call(tensor, *a, group=None, **k):
            ranks = dist.get_process_group_ranks(group)
            if len({pod_of[r] for r in ranks}) > 1:
                crossing.append((a[0] if a else tensor).nbytes)
            return fn(tensor, *a, group=group, **k)
        return call
    for name in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor"):
        setattr(dist, name, counted(getattr(dist, name)))
    out = {}
    for name, fn in (("flat", C.flat_all_reduce),
                     ("hierarchical", C.hierarchical_all_reduce)):
        crossing.clear()
        y = fn(x, mesh)
        out[name] = {"sum": y.tolist(), "shape": list(y.shape),
                     "cross_pod_bytes": sum(crossing)}
    return out


def _np_inputs(seed, shape, ef_scale):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape, np.float32)
    e = (rng.standard_normal(shape, np.float32) * ef_scale).astype(np.float32)
    return g, e


def rank_quantized_psum(seed, ef_dtype):
    """quantized_psum_pod on a (2, 4) ("pod", "data") mesh: each pod p
    syncs g[p] with error feedback e[p] ((2, 256) inputs made from
    `seed`), as a whole-leaf plain tensor and as a DTensor split over its
    data ranks. Returns both results as float lists (exact float32
    values)."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.core.collectives import quantized_psum_pod
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 4), ("pod", "data"))
    p = mesh.get_local_rank("pod")
    g, e = _np_inputs(seed, (2, 256), 0.05)
    x = torch.from_numpy(g[p])
    ef = torch.from_numpy(e[p]).to(getattr(torch, ef_dtype))
    out = {}
    o, ne = quantized_psum_pod(x, ef, mesh)
    out["plain"] = (o.tolist(), ne.float().tolist(), str(ne.dtype))
    sub = mesh["data"]
    xd, efd = (distribute_tensor(t, sub, (Shard(0),), src_data_rank=None)
               for t in (x, ef))
    o, ne = quantized_psum_pod(xd, efd, mesh)
    assert tuple(o.placements) == (Shard(0),) and o.device_mesh is sub
    out["dtensor"] = (o.full_tensor().tolist(),
                      ne.full_tensor().float().tolist(), str(ne.dtype))
    return out


def rank_error_feedback(seed, syncs):
    """tests/test_distributed.py:49-85 on the port: (2, 256) per-pod
    gradients on a (2, 4) mesh; one sync's largest error and the scale;
    then `syncs` syncs of the same gradient with the error fed back, the
    accumulated drift relative to the true accumulated mean."""
    import torch
    from repro_torch.core.collectives import quantized_psum_pod
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 4), ("pod", "data"))
    g = np.random.default_rng(seed).standard_normal((2, 256), np.float32)
    x = torch.from_numpy(g[mesh.get_local_rank("pod")])
    true_mean = torch.from_numpy(g.mean(0))
    out, _ = quantized_psum_pod(x, torch.zeros_like(x), mesh)
    err1 = float((out - true_mean).abs().max())
    scale = float(np.abs(g).max()) / 127
    acc = torch.zeros(256)
    accq = torch.zeros(256)
    ef = torch.zeros_like(x)
    for _ in range(syncs):
        out, ef = quantized_psum_pod(x, ef, mesh)
        acc += true_mean
        accq += out
    rel = float((acc - accq).abs().max() / acc.abs().max())
    return {"err1": err1, "scale": scale, "rel": rel}


def rank_train_loop(ckpt_dir, steps, every):
    """train_loop on a (2, 2) mesh, lovelock-20m smoke in float32, with a
    checkpoint every `every` steps; then its last checkpoint removed and
    the run resumed from the one before. The losses of both runs."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch.train import train_loop
    cfg = _cfg("lovelock-20m", True)
    kw = dict(steps=steps, batch=4, seq=16, seed=3, log_every=100,
              device="cpu", data_mesh=2, model_mesh=2, ckpt_dir=ckpt_dir,
              ckpt_every=every)
    state, info = train_loop(cfg, **kw)
    if dist.get_rank() == 0:
        shutil.rmtree(f"{ckpt_dir}/step_{steps:08d}")
    dist.barrier()
    state, resumed = train_loop(cfg, resume=True, **kw)
    return {"losses": info["losses"], "resumed": resumed["losses"],
            "step": state.step}


def rank_train_loop_mismatch(data, model):
    """train_loop with a data x model mesh on this process group: the
    error it raises."""
    from repro_torch.launch.train import train_loop
    try:
        train_loop(_cfg("lovelock-20m", True), steps=1, batch=4, seq=8,
                   device="cpu", data_mesh=data, model_mesh=model)
    except RuntimeError as e:
        return str(e)
    return None


def rank_checkpoint(ckpt_dir, chunk):
    """A qwen3-32b smoke TrainState (bf16 params, float32 moments and
    master, ef) placed on a (2, 2) mesh, saved in `chunk`-byte chunks,
    and restored into a placed state of zeros; the same state saved
    without a mesh by rank 0. Returns, by leaf, whether the restored
    global tensor equals the saved one bit for bit and keeps the `like`
    leaf's placements; both manifests; the peak bytes in flight."""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.core.streaming_checkpoint import (StreamingCheckpointer,
                                                       _leaf_paths)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding.rules import gather, place, state_specs
    from repro_torch.tree import tree_map
    cfg = _cfg("qwen3-32b", False)
    mesh = make_host_mesh(2, 2)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, tp=2)
    state = adamw_init(params, OptimizerConfig(), with_ef=True)
    state = tree_map(lambda t: t + 0.25 if isinstance(t, torch.Tensor)
                     and t.dtype == torch.float32 else t, state)
    state = state._replace(step=5)
    specs = state_specs(state, mesh)
    placed = place(state, specs, mesh)
    ck = StreamingCheckpointer(f"{ckpt_dir}/mesh", chunk_bytes=chunk)
    d = ck.save(5, placed)
    like = place(tree_map(lambda t: t if isinstance(t, int)
                          else torch.zeros_like(t), state), specs, mesh)
    back = ck.restore(like)
    full = gather(back)
    same, kept = {}, {}
    for (path, a), (_, b), (_, lk), (_, bk) in zip(
            _leaf_paths(state), _leaf_paths(full), _leaf_paths(like),
            _leaf_paths(back)):
        if isinstance(a, int):
            same[path] = a == b
            continue
        same[path] = a.dtype == b.dtype and bool(torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))
        kept[path] = isinstance(bk, DTensor) and \
            tuple(bk.placements) == tuple(lk.placements)
    largest = max(c["nbytes"] for m in json.loads(
        (d / "manifest.json").read_text())["leaves"].values()
        for c in m["chunks"])
    out = {"same": same, "placements_kept": kept,
           "peak": ck.metrics.peak_buffer_bytes,
           "bound": ck.buffers * largest}
    if dist.get_rank() == 0:
        plain = StreamingCheckpointer(f"{ckpt_dir}/plain", chunk_bytes=chunk)
        pd = plain.save(5, state)
        out["manifests_equal"] = (
            json.loads((d / "manifest.json").read_text())
            == json.loads((pd / "manifest.json").read_text()))
    return out


def rank_mesh_basics():
    """A (2, 2) host mesh: its names and axes, `to_placements`,
    `place` / `gather`, `ShardingRules.cs` and `make_elastic_mesh`."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.elastic import make_elastic_mesh
    from repro_torch.launch.mesh import describe, make_host_mesh, mesh_axes
    from repro_torch.sharding.rules import (P, ShardingRules, gather, place,
                                            to_placements)
    mesh = make_host_mesh(2, 2)
    rules = ShardingRules(mesh)
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    placed = place({"x": x}, {"x": P("data", None, "model")}, mesh)["x"]
    y = rules.cs(placed, "act_bsd")
    emesh = make_elastic_mesh(range(4), model=2)
    return {
        "desc": [list(describe(mesh).axis_names),
                 list(describe(mesh).axis_sizes)],
        "axes": {k: list(v) for k, v in mesh_axes(mesh).items()},
        "placements": [str(p) for p in
                       to_placements(P(("data", "model"), None), mesh)]
        + [str(p) for p in to_placements(P(None, "model"), mesh)],
        "local_shape": list(placed.to_local().shape),
        "cs": [str(p) for p in y.placements],
        "cs_equal": bool(torch.equal(y.full_tensor(), x)),
        "gather_equal": bool(torch.equal(gather({"x": placed})["x"], x)),
        "is_dtensor": isinstance(placed, DTensor),
        "replicate": isinstance(to_placements(P(), mesh)[0], Replicate),
        "shard": isinstance(to_placements(P("data"), mesh)[0], Shard),
        "elastic": [list(emesh.mesh_dim_names), list(emesh.mesh.shape)],
    }


def rank_train_loop_compressed(steps):
    """train_loop on a (2, 2, 2) ("pod", "data", "model") mesh with
    grad_sync="compressed_pod", lovelock-20m smoke in float32: its
    losses."""
    from repro_torch.launch.train import train_loop
    _, info = train_loop(_cfg("lovelock-20m", True), steps=steps, batch=8,
                         seq=16, seed=3, log_every=100, device="cpu",
                         pod_mesh=2, data_mesh=2, model_mesh=2,
                         grad_sync="compressed_pod")
    return info["losses"]
