"""Entry point: a single-GPU forward step on the flagship workload.

Counterpart of ``__graft_entry__.entry()``: the same tiny LM config and a
[2, 64] -> [2, 64, 256] forward. The reference's default attention is the
sequence-parallel ring, which is ported later; on one device the port
takes the flash-attention kernel (head dim 32). ``dryrun_multichip``
arrives with the multi-GPU port.
"""
from __future__ import annotations

import torch

from .device import resolve_device
from .workloads import lm


def entry(device=None):
    """Returns ``(forward_fn, (params, tokens))`` on ``device`` (default
    ``cuda``; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cfg = lm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4, d_ff=512,
                      attn_impl="flash")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    return lm.make_forward(cfg, dev), (params, tokens)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok", tuple(out.shape))
