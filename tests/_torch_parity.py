"""Helpers for the PyTorch port's parity tests.

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy float32 arrays.
"""
import dataclasses

import numpy as np
import pytest

# the reference's own tolerances: kernels (tests/test_kernels.py:33) and
# bf16 logits (tests/test_models.py:81)
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL_BF16 = 0.15
LOGIT_TOL_F32 = 1e-4

# the reference's kernel sweeps (tests/test_kernels.py:19-25 and :60-61)
FLASH_SWEEP = [  # B, S, H, K, d, causal, window
    (2, 256, 4, 2, 64, True, None),
    (1, 384, 8, 8, 128, True, None),
    (2, 200, 4, 1, 80, True, 96),      # GQA + sliding window + ragged S
    (1, 128, 2, 2, 32, False, None),   # non-causal
    (1, 130, 6, 2, 112, True, None),   # ragged seq + kimi head_dim
]
DECODE_SWEEP = [(2, 512, 4, 2, 64), (1, 300, 8, 8, 128),  # B, W, H, K, d
                (2, 1000, 4, 1, 80)]
# tests/test_kernels.py:77-79 (B, H, S, d); S=100 and 65 are ragged for the
# reference's 64-token chunks
WKV6_SWEEP = [(2, 2, 128, 32), (1, 4, 100, 64), (2, 1, 64, 16),
              (1, 2, 65, 64)]
WKV6_TOL = 1e-4                  # float32, tests/test_kernels.py:88


def flash_inputs(seed, B, S, H, K, d):
    """q (B,S,H,d), k/v (B,S,K,d): standard normal float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, d), np.float32),
            rng.standard_normal((B, S, K, d), np.float32),
            rng.standard_normal((B, S, K, d), np.float32))


def decode_inputs(seed, B, W, H, K, d):
    """q (B,1,H,d), k/v (B,W,K,d), and a (B,W) bias masking ~20% of
    slots with -1e30."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, d), np.float32)
    k = rng.standard_normal((B, W, K, d), np.float32)
    v = rng.standard_normal((B, W, K, d), np.float32)
    bias = np.where(rng.random((B, W)) < 0.8, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias


def wkv6_inputs(seed, B, H, S, d):
    """r, k, v, logw (B,H,S,d) and u (H,d), float32, scaled as the
    reference's sweep scales them: logw = -exp(N(0,1)/2 - 1) < 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, d), np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, S, d), np.float32) * 0.5 - 1.0)
    u = rng.standard_normal((H, d), np.float32) * 0.5
    return r, k, v, logw.astype(np.float32), u


def cfg_pair(arch, *, smoke=False, f32=True, **replace):
    """The same config from both packages' registries, equally modified."""
    from repro.configs import get_config as jget, smoke_variant as jsmoke
    from repro_torch.configs import (get_config as tget,
                                     smoke_variant as tsmoke)
    jc, tc = jget(arch), tget(arch)
    if smoke:
        jc, tc = jsmoke(jc), tsmoke(tc)
    if f32:
        replace = dict(param_dtype="float32", compute_dtype="float32",
                       **replace)
    return dataclasses.replace(jc, **replace), dataclasses.replace(tc,
                                                                  **replace)


def to_np(x):
    """A torch tensor or jax array as a numpy array (floats as float32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "f" or \
        a.dtype.name == "bfloat16" else a


def jax_to_torch(tree):
    """A reference params / cache tree converted for the port."""
    import jax
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def both(x, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of `dtype`."""
    import jax.numpy as jnp
    import torch
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))


@pytest.fixture
def cuda_device():
    """The CUDA card; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the card run "
                    "`PYTHONPATH=src python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py`")
    return torch.device("cuda")
