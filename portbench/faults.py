"""Faults planted under the timed path, to show that the comparison
catches them: each patches a factory of the program for as long as its
context lasts. Used by the tests and by `calibrate.py`."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def train_frozen():
    """A train step that returns its state unchanged."""
    from repro_torch.train import steps

    def make(real):
        def factory(cfg, opt_cfg, rules=None, *, use_kernels=True,
                    remat=True, **_):
            grad_fn = steps.make_grad_fn(cfg, rules, use_kernels=use_kernels,
                                         remat=remat)

            def step(state, batch):
                metrics, _ = grad_fn(state.params, batch)
                return state, metrics
            return step
        return factory
    return patched(steps, "make_train_step", make)


def train_half():
    """A train step that leaves out half of the batch and takes the mean
    over the rest."""
    from repro_torch.train import steps

    def make(real):
        def factory(*a, **k):
            step = real(*a, **k)

            def half(state, batch):
                return step(state, {n: t[:t.shape[0] // 2]
                                    for n, t in batch.items()})
            return half
        return factory
    return patched(steps, "make_train_step", make)


def train_no_writeback():
    """A train step that updates the float32 master and the moments but
    never writes the master back into the working weights the model runs
    on."""
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves

    def make(real):
        def factory(*a, **k):
            step = real(*a, **k)

            def stale(state, batch):
                before = [p.clone() for p in tree_leaves(state.params)]
                state, metrics = step(state, batch)
                for p, old in zip(tree_leaves(state.params), before):
                    p.copy_(old)
                return state, metrics
            return stale
        return factory
    return patched(steps, "make_train_step", make)


def serve_frozen():
    """A decode step that returns its state unchanged: the token it was
    given comes back as the next."""
    from repro_torch.launch import serve

    def make(real):
        def factory(*a, **k):
            step = real(*a, **k)

            def frozen(params, caches, token):
                _, caches, last = step(params, caches, token)
                return token, caches, last
            return frozen
        return factory
    return patched(serve, "make_serve_step", make)


def serve_token():
    """A decode step whose token is altered where it is produced."""
    from repro_torch.launch import serve

    def make(real):
        def factory(cfg, *a, **k):
            step = real(cfg, *a, **k)

            def altered(params, caches, token):
                nxt, caches, last = step(params, caches, token)
                return (nxt + 1) % cfg.vocab_size, caches, last
            return altered
        return factory
    return patched(serve, "make_serve_step", make)


FAULTS = {"train": {"frozen": train_frozen, "half": train_half,
                   "no_writeback": train_no_writeback},
          "serve": {"frozen": serve_frozen, "token": serve_token}}
