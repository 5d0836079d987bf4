"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lovelock-20m \
        --steps 100 --batch 8 --seq 256 [--device cpu] [--no-kernels]

    PYTHONPATH=src python -m repro_torch.launch.train --arch lovelock-20m \
        --steps 100 --ckpt-dir ck [--ckpt-every 50] [--resume]

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --data-mesh 2 --model-mesh 2

Port of `repro.launch.train`: storage-node data pipeline -> sharded train
step (AdamW) -> streaming checkpoints -> straggler detection. Runs on the
CUDA card unless `--device cpu`; the kernels are on unless
`--no-kernels`. With `--ckpt-dir` the state is saved every `--ckpt-every`
steps and at the end, in the reference's on-disk format; `--resume`
restores the latest checkpoint there and goes on from its step, with that
step's batch. A mesh of more than one rank (`--data-mesh`, `--model-mesh`,
and `--pod-mesh` for a pod axis, whose gradients `--grad-sync
compressed_pod` syncs in int8) needs a process group of exactly that many
ranks, one per process (torchrun: gloo on the CPU, NCCL on cards).
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.elastic import StragglerDetector
from repro_torch.core.streaming_checkpoint import StreamingCheckpointer
from repro_torch.data.pipeline import Prefetcher, StorageNodeDataset
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.sharding.rules import ShardingRules, place, state_specs
from repro_torch.train.steps import make_train_step


def _clock(dev: torch.device) -> float:
    """Host clock after the device has finished the queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()  # simlint: ok[DET002]


def train_loop(cfg, *, steps, batch, seq, ckpt_dir=None, ckpt_every=50,
               lr=3e-4, seed=0, log_every=10, data_mesh=1, model_mesh=1,
               pod_mesh=1, grad_sync="gspmd", resume=False, log_path=None,
               use_kernels=True, distribution="zipf_markov", device=None,
               params=None):
    """Train `steps` steps of `batch` x `seq` tokens from the synthetic
    storage-node dataset made from `seed`.

    With `pod_mesh` x `data_mesh` x `model_mesh` > 1 the state is placed
    on a ("pod",) "data", "model" mesh by `state_specs` and trained by the
    sharded step; that needs a process group of exactly that many ranks
    (else it raises, naming the world size it found), each running this
    loop on the same arguments. `grad_sync` is the step's (see
    `make_train_step`).

    `params` default to random ones made from `seed` on the device. With
    `ckpt_dir`, the state is saved there after every `ckpt_every`-th step
    and at the end; with `resume` as well, the loop starts from the latest
    checkpoint there, if any, and feeds step i the dataset's batch i, as an
    uninterrupted run does (the reference feeds batch 0 after a resume).
    Returns (state, info): info holds the losses of the steps run, each
    step's seconds (`step_s`, host clock around a synchronised step, the
    batch's copy to the device included) and the wall seconds of the loop.
    """
    mesh = rules = None
    if pod_mesh * data_mesh * model_mesh > 1:
        shape, names = (data_mesh, model_mesh), ("data", "model")
        if pod_mesh > 1:
            shape, names = (pod_mesh, *shape), ("pod", *names)
        mesh = make_mesh(shape, names)
        rules = ShardingRules(mesh)
    main_rank = mesh is None or dist.get_rank() == 0
    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(lr=lr, warmup=max(10, steps // 20),
                              total_steps=steps)
    if params is None:
        params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                               tp=model_mesh)
    compressed = grad_sync == "compressed_pod"
    state = adamw_init(params, opt_cfg, with_ef=compressed)
    if mesh is not None:
        state = place(state, state_specs(state, mesh,
                                         fsdp_pod=not compressed), mesh)
    ckpt = StreamingCheckpointer(ckpt_dir) if ckpt_dir else None
    if resume and ckpt and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        if main_rank:
            print(f"resumed from step {state.step}", flush=True)
    step_fn = make_train_step(cfg, opt_cfg, rules, use_kernels=use_kernels,
                              grad_sync=grad_sync)
    ds = StorageNodeDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch, seed=seed,
                            distribution=distribution)
    detector = StragglerDetector(n_hosts=1)
    losses, step_s = [], []
    t_start = _clock(dev)
    with contextlib.ExitStack() as stack:
        logf = (stack.enter_context(open(log_path, "a"))
                if log_path and main_rank else None)
        it = Prefetcher((ds.fetch_step(i)
                         for i in itertools.count(state.step)), depth=2)
        stack.callback(it.close)
        for batch_np in it:
            step = state.step
            if step >= steps:
                break
            t0 = _clock(dev)
            tensors = {k: torch.from_numpy(v).to(dev)
                       for k, v in batch_np.items()}
            state, metrics = step_fn(state, tensors)
            loss = float(metrics["loss"])
            dt = _clock(dev) - t0
            detector.observe([dt])
            losses.append(loss)
            step_s.append(dt)
            if step % log_every == 0 and main_rank:
                rec = {"step": step, "loss": round(loss, 4),
                       "step_time_s": round(dt, 3),
                       "tokens_per_s": round(batch * seq / dt, 1)}
                print(json.dumps(rec), flush=True)
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(state.step, state)
    wall = _clock(dev) - t_start
    return state, {"losses": losses, "step_s": step_s, "wall_s": wall}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lovelock-20m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of --arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--pod-mesh", type=int, default=1)
    ap.add_argument("--grad-sync", default="gspmd",
                    choices=["gspmd", "compressed_pod"])
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain PyTorch attention / WKV6 instead of the "
                         "kernels")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device = args.device
    # one rank per process, as torchrun starts them
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        cuda = resolve_device(device).type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if cuda else "gloo")
    try:
        _, info = train_loop(
            cfg, steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
            data_mesh=args.data_mesh, model_mesh=args.model_mesh,
            pod_mesh=args.pod_mesh, grad_sync=args.grad_sync,
            resume=args.resume, log_path=args.log,
            use_kernels=not args.no_kernels, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    l = info["losses"]
    losses = f", loss {l[0]:.3f} -> {l[-1]:.3f}" if l else ""
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"done: {len(l)} steps{losses}, wall {info['wall_s']:.0f}s")


if __name__ == "__main__":
    main()
