"""The benchmark's inputs, made from ``--seed``: seeds, the LM's initial
params and its token batches.

Frozen copies, taken on 2026-10-18 from ``kubernetes_tpu_torch/workloads/
lm.py`` at the commit that the benchmark was defined on:

- :func:`init_params` keeps ``lm.init_params``'s layout and scales
  (weights stored ``[in, out]``, layers stacked on a leading axis);
  each leaf is drawn from a generator of its own, so that a leaf can be
  made again alone (:func:`init_leaf`) without holding a copy.
- :func:`global_batch` is ``lm.synthetic_batch``'s stream,
  tok_n = (3^n * tok_0 + 7n) % vocab with a share of random tokens,
  drawn from a generator that is a function of the seed and the step.

The program may change; these may not. Both the port and the reference
are handed what these make.
"""
from __future__ import annotations

import hashlib

import torch

#: One layer's weights, in the program's order.
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed made from ``seed`` and ``tags``: every use of the
    run's seed draws from a stream of its own."""
    text = repr((int(seed),) + tuple(str(t) for t in tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def leaf_names() -> list:
    """The params' leaves as dotted paths, in the program's order."""
    return ["embed", *(f"layers.{k}" for k in LAYER_KEYS), "ln_f"]


def _leaf_spec(run: dict, name: str):
    """``(shape, scale)`` of one leaf; scale None for a norm's ones."""
    e, f, l, v = run["d_model"], run["d_ff"], run["n_layers"], run["vocab"]
    return {
        "embed": ((v, e), e ** -0.5),
        "layers.ln1": ((l, e), None),
        "layers.wq": ((l, e, e), e ** -0.5),
        "layers.wk": ((l, e, e), e ** -0.5),
        "layers.wv": ((l, e, e), e ** -0.5),
        "layers.wo": ((l, e, e), (2 * l * e) ** -0.5),
        "layers.ln2": ((l, e), None),
        "layers.w1": ((l, e, f), e ** -0.5),
        "layers.w3": ((l, e, f), e ** -0.5),
        "layers.w2": ((l, f, e), (2 * l * f) ** -0.5),
        "ln_f": ((e,), None),
    }[name]


def init_leaf(seed: int, run: dict, name: str, device,
              dtype=None) -> torch.Tensor:
    """One leaf of :func:`init_params`, made again from the seed, in
    ``dtype`` (default the run's ``param_dtype``): normal draws in f32
    on the device, scaled, then cast."""
    dtype = dtype or getattr(torch, run["param_dtype"])
    shape, scale = _leaf_spec(run, name)
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator(device, seed, "param", name),
                    device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def init_params(seed: int, run: dict, device) -> dict:
    """The initial params in the program's layout, in the run's
    ``param_dtype``, on ``device``: one draw per leaf."""
    leaves = {name: init_leaf(seed, run, name, device)
              for name in leaf_names()}
    return {"embed": leaves["embed"],
            "layers": {k: leaves[f"layers.{k}"] for k in LAYER_KEYS},
            "ln_f": leaves["ln_f"]}


def flat(params: dict) -> dict:
    """``{dotted name: leaf}`` of a params dict in the program's layout."""
    return {"embed": params["embed"],
            **{f"layers.{k}": params["layers"][k] for k in LAYER_KEYS},
            "ln_f": params["ln_f"]}


_POW3: dict = {}


def _powers_of_3(vocab: int, n: int, device: torch.device) -> torch.Tensor:
    """3^0 .. 3^(n-1) mod vocab on ``device``, made once per shape: a
    host list copied to the card every step would wait for the card."""
    key = (vocab, n, str(device))
    if key not in _POW3:
        # Reduced mod vocab with Python ints: 3**t would overflow.
        pow3, p = [], 1
        for _ in range(n):
            pow3.append(p)
            p = (p * 3) % vocab
        _POW3[key] = torch.tensor(pow3, device=device)
    return _POW3[key]


def global_batch(seed: int, step: int, vocab: int, batch: int, seq: int,
                 device, noise: float = 0.02) -> torch.Tensor:
    """Step ``step``'s global batch, [batch, seq + 1] int32: each row the
    stream tok_n = (3^n * tok_0 + 7n) % vocab from a random tok_0, with
    a share ``noise`` of its tokens replaced at random."""
    gen = generator(device, seed, "batch", step)
    start = torch.randint(0, vocab, (batch, 1), generator=gen,
                          device=device, dtype=torch.int64)
    toks = (start * _powers_of_3(vocab, seq + 1, torch.device(device))
            + 7 * torch.arange(seq + 1, device=device)) % vocab
    swap = torch.rand(toks.shape, generator=gen, device=device) < noise
    rand = torch.randint(0, vocab, toks.shape, generator=gen, device=device,
                         dtype=torch.int64)
    return torch.where(swap, rand, toks).to(torch.int32)
