"""One run of one cell: the manifest, the cell's files, the device, the
window, the readers and the result line.

Everything that belongs to one configuration, traffic mix, cell kind or
per-layer metric lives in a file of its own, found by name:

- configs/<config>.json: the model as it is run (`model`), its source,
  what was cut, and the reference module (`reference/<name>.py`);
- traffic/<cell>.json: the cell's traffic, read by `generate.py`; its
  `kind` names the driver, drivers/<kind>.py;
- checks/<cell>.json: the limit of each number the cell's comparison
  with the reference gives;
- metrics/<metric>.py: the reader of a per-layer metric, or, where
  there is none, metrics/<the metric's name before its first dot>.py
  (one reader for `idle_share.train` and `idle_share.serve`);
- rooflines/<kernel>.py: a kernel's operations and bytes.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot give a result (no card, a missing file, a module
    that must not be loaded); exit code 2 and no result line."""


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark's process
    must not hold, compared whole (`repro_torch` is not `repro`)."""
    names = {m.split(".")[0] for m in (modules if modules is not None
                                        else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise Refused(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least
    q of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


class Cell:
    """A cell of the manifest with its files, and the run's settings."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device=None, manifest=None):
        self.root = Path(root)
        self.bench = self.root / "portbench"
        self.manifest = manifest or _json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise Refused(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _json(self.root / self.config_entry["file"])
        self.model = self.config["model"]
        self.traffic = _json(self.bench / "traffic" /
                             f"{self.workload['traffic']}.json")
        self.limits = _json(self.bench / "checks" / f"{workload}.json")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.chips = self.workload["chips"]
        self.device = device
        self.e2e = [m for m in self.manifest["end_to_end"]
                    if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.reference = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        self.t_window = None

    def model_config(self):
        """The program's ModelConfig of this cell's configuration."""
        if getattr(self, "_cfg", None) is None:
            self._cfg = self._model_config()
        return self._cfg

    def _model_config(self):
        import dataclasses
        from repro_torch.configs.base import (MambaConfig, ModelConfig,
                                              MoEConfig)
        m = dict(self.model)
        if m.get("moe"):
            m["moe"] = MoEConfig(**m["moe"])
        if m.get("mamba"):
            m["mamba"] = MambaConfig(**m["mamba"])
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in m.items() if k in fields})

    def driver(self):
        kind = self.traffic["kind"]
        return load_file(self.bench / "drivers" / f"{kind}.py",
                         f"portbench_driver_{kind}")

    def readers(self) -> dict:
        def path(name):
            own = self.bench / "metrics" / f"{name}.py"
            return own if own.is_file() else own.with_name(
                f"{name.split('.')[0]}.py")
        return {m["name"]: load_file(path(m["name"]),
                                     f"portbench_metric_{m['name']}")
                for m in self.per_layer}

    def roofline(self, kernel: str):
        return load_file(self.bench / "rooflines" / f"{kernel}.py",
                         f"portbench_roofline_{kernel}")


class Window:
    """The measured window: the host clock over whole steps or batches,
    with the tracer (if any) around it and the run's diagnostics probe
    read at each clock reading (drivers read the clock in the window
    only)."""

    def __init__(self, cell: Cell, tracer):
        from portbench.diagnostics import Probe
        self.cell, self.tracer = cell, tracer
        self.probe = Probe(cell.device)
        self.elapsed = None

    def annotate(self, name):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.annotate(name)

    def clock(self) -> float:
        if self.cell.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.cell.device)
        t = time.perf_counter()
        self.probe.sample()
        return t

    @contextlib.contextmanager
    def open(self):
        if self.tracer is not None:
            self.tracer.start()
        self.probe.open()
        self.t0 = self.clock()
        self.cell.t_window = self.t0
        yield self
        self.elapsed = self.clock() - self.t0
        self.probe.close()
        if self.tracer is not None:
            self.tracer.stop()


def _tracer(cell: Cell, readers: dict, driver):
    from portbench.tracing import Tracer
    spans, calls = set(), {}
    for mod in readers.values():
        spans |= set(getattr(mod, "SPANS", ()))
        for k in getattr(mod, "ROOFLINES", ()):
            calls[k] = cell.roofline(k)
    return Tracer(spans=sorted(spans), calls=calls,
                  factories=getattr(driver, "FACTORIES", {}),
                  cuda=cell.device.type == "cuda")


class Run:
    """What a per-layer reader reads: the cell, the window's work as the
    driver counted it, and the trace."""

    def __init__(self, cell, out, trace):
        self.cell, self.trace, self.model = cell, trace, cell.model
        self.window_s = out["window_s"]
        self.work = out["work"]

    def roofline(self, kernel):
        return self.cell.roofline(kernel)


def execute(cell: Cell, t_start: float) -> dict:
    """Set-up, the window and the check of one run; returns the result
    line's object. Raises Refused where no result may be printed."""
    import torch
    if cell.device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: this "
                          "benchmark measures the port on a CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} visible")
        cell.device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    driver = cell.driver()
    readers = cell.readers() if cell.trace else {}
    tracer = _tracer(cell, readers, driver) if cell.trace else None
    window = Window(cell, tracer)
    out = driver.run(cell, window)
    setup_s = cell.t_window - t_start
    values = dict(out["e2e"], setup_s=setup_s)
    metrics = {}
    if cell.trace:
        view = tracer.view(out["window_s"])
        run = Run(cell, out, view)
        for m in cell.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules that must not be loaded: {bad}")
    # the numbers the cell's check file gives a limit are compared
    checks = {name: {"value": out["numbers"][name], "limit": limit}
              for name, limit in cell.limits["limits"].items()}
    correct = (bool(checks) and out["attempted"] > 0 and out["failed"] == 0
               and all(c["limit"] is not None and math.isfinite(c["value"])
                       and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(cell.device)
                    if cell.device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if cell.trace:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.trace_window_s
        result["breakdown"] = {"device_ops": view.device_ops(),
                               "idle_gaps": view.idle_gaps()}
    result["diagnostics"] = window.probe.report(out["series"])
    print("portbench: series " + json.dumps(
        {**out["series"], "card": window.probe.samples}), file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    try:
        if not (root / "src" / "repro_torch").is_dir():
            raise Refused(f"no src/repro_torch under {root}: the program "
                          f"under test is missing")
        cell = Cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace))
        result = execute(cell, t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    emit(result)
    return 0


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
