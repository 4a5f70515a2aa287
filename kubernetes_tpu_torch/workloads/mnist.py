"""The "MNIST" baseline payload: a small MLP classifier trained on
synthetic digits.

Counterpart of ``kubernetes_tpu/workloads/mnist.py``: the same sizes
(784 -> ``hidden`` -> 10), init scales, synthetic data (fixed random
class prototypes, a function of the seed alone, plus noise), Adam
(``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, no decay) and mean
softmax cross-entropy over integer labels. The reference's step is plain
XLA and this one plain PyTorch ops: it has no kernel of its own. The
data and initial weights are drawn on the host from the seed
(``torch.Generator`` on the CPU) and moved to the device, so a run on
the card and one on the CPU train on the same numbers.

    python -m kubernetes_tpu_torch.workloads.mnist   # {"accuracy": ...}
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import lm

N_CLASSES = 10
DIM = 784


def _synthetic(generator: torch.Generator, n: int, seed: int = 0):
    """``(x [n, DIM] f32, labels [n] int64)`` drawn from ``generator``;
    the class prototypes are a function of ``seed`` alone, fixed across
    batches."""
    protos = torch.randn((N_CLASSES, DIM), generator=torch.Generator(
        generator.device).manual_seed(seed + 7919),
        device=generator.device)
    labels = torch.randint(0, N_CLASSES, (n,), generator=generator,
                           device=generator.device)
    x = protos[labels] + 0.5 * torch.randn((n, DIM), generator=generator,
                                           device=generator.device)
    return x, labels


def init_params(generator: torch.Generator, hidden: int = 128) -> dict:
    """Random params on ``generator``'s device, the reference's shapes
    and scales."""
    dev = generator.device
    return {
        "w1": torch.randn((DIM, hidden), generator=generator, device=dev)
        * DIM ** -0.5,
        "b1": torch.zeros((hidden,), device=dev),
        "w2": torch.randn((hidden, N_CLASSES), generator=generator,
                          device=dev) * hidden ** -0.5,
        "b2": torch.zeros((N_CLASSES,), device=dev),
    }


def params_from_jax(tree: dict, device=None) -> dict:
    """The reference's params (leaves as numpy arrays, or anything
    ``np.asarray`` takes) as f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {key: lm._to_tensor(val).to(device=dev, dtype=torch.float32)
            for key, val in tree.items()}


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params: dict, x: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross-entropy of ``labels`` (int) under the logits."""
    return F.cross_entropy(forward(params, x), labels)


def make_optimizer(lr: float) -> lm.AdamW:
    """``optax.adam(lr)``: AdamW with no decay."""
    return lm.AdamW(lr, b1=0.9, b2=0.999, weight_decay=0.0)


def make_train_step(lr: float):
    """``step(params, opt_state, x, labels) -> loss``: the loss's
    gradient and one Adam update of ``params`` in place."""
    opt = make_optimizer(lr)

    def step(params: dict, opt_state: dict, x, labels) -> torch.Tensor:
        wrt = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(wrt, x, labels)
        grads = torch.autograd.grad(loss, list(wrt.values()))
        opt.update_(params, dict(zip(wrt, grads)), opt_state)
        return loss.detach()

    return step


def train(steps: int = 60, batch: int = 256, lr: float = 1e-2,
          seed: int = 0, device=None) -> float:
    """Trains on ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``) and returns the held-out accuracy on 1024 samples
    (the reference expects > 0.9 at 60 steps)."""
    dev = resolve_device(device)
    host = torch.Generator("cpu").manual_seed(seed)
    params = {k: p.to(dev) for k, p in init_params(host).items()}
    opt_state = make_optimizer(lr).init(params)
    step = make_train_step(lr)
    for _ in range(steps):
        x, labels = _synthetic(host, batch, seed)
        step(params, opt_state, x.to(dev), labels.to(dev))
    x, labels = _synthetic(host, 1024, seed)
    with torch.no_grad():
        pred = forward(params, x.to(dev)).argmax(-1)
    return float((pred == labels.to(dev)).float().mean())


if __name__ == "__main__":
    import json
    print(json.dumps({"accuracy": train()}))
