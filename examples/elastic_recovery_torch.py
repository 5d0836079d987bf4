"""Fault tolerance on the PyTorch port: inject a failure mid-training; the
runner recovers from the last streamed checkpoint and finishes the run
(twin of examples/elastic_recovery.py).

    PYTHONPATH=src python examples/elastic_recovery_torch.py [--device cpu]
        [--no-kernels]

Runs on the CUDA card unless `--device cpu`. The model is h2o-danube-1.8b's
smoke variant; its head dim of 16 is one the flash kernel does not take
(it takes 32/64/80/112/128), so on the card it trains with head dim 32
through the kernel.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.elastic import (ElasticRunner, StragglerDetector,
                                      StragglerPolicy)
from repro_torch.core.streaming_checkpoint import StreamingCheckpointer
from repro_torch.data.pipeline import StorageNodeDataset
from repro_torch.models import model as M
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.train.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain PyTorch attention instead of the kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=32)
    oc = OptimizerConfig(lr=1e-3)
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, tp=1)
    state = adamw_init(params, oc)
    step = make_train_step(cfg, oc, use_kernels=not args.no_kernels)

    ds = StorageNodeDataset(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4, n_storage_nodes=2)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in ds.fetch_step(i).items()}
               for i in range(args.steps)]

    with tempfile.TemporaryDirectory() as d:
        ck = StreamingCheckpointer(d)
        ck.save(0, state)
        runner = ElasticRunner(make_step=lambda mesh: step,
                               init_state=state, checkpointer=ck,
                               ckpt_every=5)
        print(f"training {args.steps} steps on {dev} with a simulated node "
              f"failure at step {args.fail_at}")
        final = runner.run(batches, fail_at={args.fail_at: 16})
        print(f"finished at step {int(final.step)}; "
              f"recoveries={runner.recoveries}; "
              f"checkpoints={ck.all_steps()}")
        out = {"step": int(final.step), "recoveries": runner.recoveries,
               "checkpoints": ck.all_steps()}

    # straggler detection on synthetic per-host timings
    det = StragglerDetector(8, StragglerPolicy(patience=3))
    times = [[1.0] * 8 for _ in range(6)]
    for t in times[2:]:
        t[5] = 4.0          # host 5 becomes persistently slow
    out["evicted"] = []
    for i, t in enumerate(times):
        evict = det.observe(t)
        if evict:
            out["evicted"].append(evict)
            print(f"step {i}: evicting persistent stragglers {evict} "
                  "(-> elastic re-mesh)")
    return out


if __name__ == "__main__":
    main()
