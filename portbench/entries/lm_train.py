"""The LM family's training entry: ``kubernetes_tpu_torch``'s train step
(``lm.make_train_step``, the one call through which every step of
``lm.train`` and so of the TrainJob worker runs), built for a
configuration and driven on the benchmark's feed.

The harness sees an :class:`Entry` (``step``, ``readings``,
``launches``, ``free``), the accounting of its work (``shape``,
``flops_per_step``, ``tokens_per_step``) and :func:`reference_readings`,
the plain reference's readings on the same inputs.
"""
from __future__ import annotations

import torch

from .. import feed
from ..reference import lm as reference


def _port_config(lm, run: dict):
    return lm.LMConfig(
        vocab=run["vocab"], d_model=run["d_model"], n_layers=run["n_layers"],
        n_heads=run["n_heads"], d_ff=run["d_ff"], rope_base=run["rope_base"],
        param_dtype=getattr(torch, run["param_dtype"]),
        compute_dtype=getattr(torch, run["compute_dtype"]),
        remat=run["remat"], remat_policy=run["remat_policy"],
        attn_impl=run["attn_impl"])


def kernel_sources(run: dict) -> tuple:
    """The kernel libraries that the cell's attention launches."""
    from kubernetes_tpu_torch.workloads import flash_attention as fa
    dtype = getattr(torch, run["compute_dtype"])
    if fa.one_tile(run["d_model"] // run["n_heads"], dtype):
        return ("flash_attn_fwd", "flash_attn_bwd")
    return ("flash_attn_wide",)


class Entry:
    """The port's train step and its state for ``config`` under
    ``traffic``, the initial params made from ``seed`` on ``device``; under
    a process ``group`` (data parallelism, the TrainJob gang's) this rank
    takes its rows of each global batch."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 group=None):
        from kubernetes_tpu_torch.workloads import flash_attention, lm
        self.fa = flash_attention
        self.run, self.traffic, self.seed = config["run"], traffic, seed
        self.device = torch.device(device)
        self.rank, self.world = 0, 1
        if group is not None:
            from torch import distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.rows = traffic["global_batch"] // self.world
        opt = self.run["optimizer"]
        cfg = _port_config(lm, self.run)
        params = feed.init_params(seed, self.run, self.device)
        self.state = [params, lm.init_opt_state(params, cfg, opt["lr"])]
        self.step_fn = lm.make_train_step(cfg, lr=opt["lr"],
                                          device=self.device, group=group)

    def batch(self, i: int) -> torch.Tensor:
        t = self.traffic
        rows = feed.global_batch(self.seed, i, self.run["vocab"],
                                 t["global_batch"], t["seq"], self.device,
                                 t["noise"])
        return rows[self.rank * self.rows:(self.rank + 1) * self.rows]

    def step(self, i: int) -> torch.Tensor:
        """Step ``i`` on its batch; its loss, on the device."""
        params, opt_state, loss = self.step_fn(*self.state, self.batch(i))
        self.state = [params, opt_state]
        return loss

    def _adam_and_master(self):
        """AdamW's state and the f32 master, as ``lm.init_opt_state``
        lays them out (with bf16 params, ``(adamw_state, master)``)."""
        params, opt_state = self.state
        if isinstance(opt_state, tuple):
            return opt_state
        return opt_state, params

    def grad_norms(self) -> dict:
        """After the first step: each leaf's gradient norm as AdamW got
        it, mu / (1 - b1), mu starting at zero."""
        adam, _ = self._adam_and_master()
        b1 = self.run["optimizer"]["b1"]
        return {n: float(torch.linalg.vector_norm(mu.float())) / (1 - b1)
                for n, mu in feed.flat(adam["mu"]).items()}

    def change_norms(self) -> dict:
        """Each leaf's change from its initial value (made again from the
        seed), of the f32 master."""
        _, master = self._adam_and_master()
        out = {}
        for n, p in feed.flat(master).items():
            p0 = feed.init_leaf(self.seed, self.run, n, self.device)
            out[n] = float(torch.linalg.vector_norm(p.float() - p0.float()))
        return out

    def launches(self) -> dict:
        """The attention kernels' launches so far, forward and backward."""
        counts = self.fa.counts()
        return {d: sum(v for k, v in counts.items()
                       if k.startswith(f"flash_attn_{d}"))
                for d in ("fwd", "bwd")}

    def zero_launches(self) -> None:
        self.fa.zero_counts()

    def launch_counts(self) -> dict:
        return self.fa.counts()

    def free(self) -> None:
        self.state = None
        self.step_fn = None


def least_launches(config: dict, steps: int) -> int:
    """The fewest attention launches each way that ``steps`` steps make
    when every layer's attention runs through the kernels."""
    return config["run"]["n_layers"] * steps


def shape(config: dict, traffic: dict, world: int) -> dict:
    run = config["run"]
    return {"batch": traffic["global_batch"] // world,
            "heads": run["n_heads"], "seq": traffic["seq"],
            "head_dim": run["d_model"] // run["n_heads"],
            "elem_bytes": torch.tensor([], dtype=getattr(
                torch, run["compute_dtype"])).element_size()}


def tokens_per_step(traffic: dict, world: int) -> int:
    """This rank's tokens in one step."""
    return traffic["global_batch"] // world * traffic["seq"]


def flops_per_step(accounting, config: dict, traffic: dict,
                   world: int) -> float:
    """This rank's model FLOPs in one step."""
    return accounting.train_flops_per_token(config["run"], traffic["seq"]) \
        * tokens_per_step(traffic, world)


def reference_readings(config: dict, traffic: dict, seed: int, steps: int,
                       device, group=None, matmul: str = "f32",
                       fault: str = "") -> dict:
    """The plain reference's readings of the first ``steps`` steps on the
    same inputs as the port's; under ``group`` each rank its rows, the
    gradients summed. ``matmul="fp8"`` is the control. ``fault`` puts a
    faulty step in the program's place: ``"half"``, half of each batch
    left out and the mean taken over the rest (half the rows, or of one
    row the first half of its positions, which a causal model reads
    alone); ``"exchange"``, each rank stepping on its own rows."""
    run = config["run"]
    rank, world = 0, 1
    if group is not None:
        from torch import distributed as dist
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    rows = traffic["global_batch"] // world

    def rows_of_step(i):
        x = feed.global_batch(seed, i, run["vocab"], traffic["global_batch"],
                              traffic["seq"], device, traffic["noise"])
        x = x[rank * rows:(rank + 1) * rows]
        if fault == "half":
            x = x[:rows // 2] if rows > 1 else x[:, :traffic["seq"] // 2 + 1]
        return x

    return reference.train_readings(
        run, lambda n: feed.init_leaf(seed, run, n, device), rows_of_step,
        steps, run["optimizer"], matmul=matmul, group=group,
        exchange=fault != "exchange",
        row_block=traffic.get("reference_row_block", 0))
