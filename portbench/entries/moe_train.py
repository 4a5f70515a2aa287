"""The MoE family's training entry: ``kubernetes_tpu_torch``'s MoE train
step (``moe.make_train_step``) at a configuration of per-kind layer
stacks (``layer_types``: gated short-conv and GQA mixers, leading dense
FFNs, the sigmoid router with its expert bias, the dropless sorted
dispatch over grouped expert GEMMs), on one card, driven on the
benchmark's feed.

The harness sees what ``lm_train`` gives it: an :class:`Entry`, the
accounting of its work and :func:`reference_readings`, the plain
reference's (``reference/lfm2.py``) readings on the same inputs. The
weights are made here from the seed, one generator a leaf
(``feed.generator``), so that a leaf can be made again alone; the
token batches are ``feed.global_batch``'s.
"""
from __future__ import annotations

import torch

from .. import feed
from ..reference import lfm2 as reference

#: Leaves that start at 1 (the norms; the expert bias starts at 0).
_ONES = ("ln", "q_norm", "k_norm", "ln_f")

#: The capacity fault's factor: each expert keeps 1.0 x its mean load
#: (top_k x tokens / experts) of picks. The cell's loads stay under 1.25
#: x the mean at the first steps, where a capacity of 1.25 drops nothing.
CAPACITY_FAULT = 1.0


def _port_config(moe, run: dict):
    return moe.MoEConfig(
        vocab=run["vocab"], d_model=run["d_model"], n_layers=run["n_layers"],
        n_heads=run["n_heads"], d_ff=run["expert_d_ff"],
        n_experts=run["n_experts"], top_k=run["top_k"],
        rope_base=run["rope_base"],
        param_dtype=getattr(torch, run["param_dtype"]),
        compute_dtype=getattr(torch, run["compute_dtype"]),
        remat=run["remat"], layer_types=tuple(run["layer_types"]),
        n_kv_heads=run["n_kv_heads"], qk_norm=run["qk_norm"],
        conv_kernel=run["conv_kernel"], n_dense_layers=run["n_dense_layers"],
        dense_d_ff=run["dense_d_ff"], norm_topk=run["norm_topk"],
        routed_scale=run["routed_scale"], bias_rate=run["bias_rate"])


def kernel_sources(run: dict) -> tuple:
    """The kernel libraries that the cell's attention launches."""
    from kubernetes_tpu_torch.workloads import flash_attention as fa
    dtype = getattr(torch, run["compute_dtype"])
    if fa.one_tile(run["d_model"] // run["n_heads"], dtype):
        return ("flash_attn_fwd", "flash_attn_bwd")
    return ("flash_attn_wide",)


def init_leaf(seed: int, run: dict, name: str, device,
              dtype=None) -> torch.Tensor:
    """One leaf (``reference.leaf_shapes``'s name), made again from the
    seed: the norms at 1, the expert bias at 0 (f32), each weight a
    normal draw in f32 on the device over the square root of its fan-in
    (the short conv's: its taps), cast to ``dtype`` (default the run's
    ``param_dtype``)."""
    shape = reference.leaf_shapes(run)[name]
    if name == "expert_bias":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    dtype = dtype or getattr(torch, run["param_dtype"])
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = shape[-1] if leaf in ("conv", "embed") else shape[-2]
    x = torch.randn(shape, generator=feed.generator(device, seed, "param",
                                                    name),
                    device=device, dtype=torch.float32)
    return x.mul_(fan_in ** -0.5).to(dtype)


def init_params(seed: int, run: dict, device) -> dict:
    """The initial params in the program's tree: ``embed``, a dict per
    group (``attention``, ``conv``, ``dense``, ``sparse``), ``ln_f``,
    ``expert_bias``."""
    out: dict = {}
    for name in reference.leaf_shapes(run):
        group, _, key = name.rpartition(".")
        leaf = init_leaf(seed, run, name, device)
        if group:
            out.setdefault(group, {})[key] = leaf
        else:
            out[name] = leaf
    return out


def flat(params: dict) -> dict:
    """``{dotted name: leaf}`` of a tree of the program's layout."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out.update({f"{key}.{k}": v for k, v in val.items()})
        else:
            out[key] = val
    return out


class Entry:
    """The port's MoE train step and its state for ``config`` under
    ``traffic``, the initial params made from ``seed`` on ``device``. One
    card: these options raise under a mesh, and the entry takes no
    process group."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 group=None):
        if group is not None:
            raise ValueError("the MoE entry runs on one card")
        from kubernetes_tpu_torch.workloads import flash_attention, moe
        self.fa, self.moe = flash_attention, moe
        self.run, self.traffic, self.seed = config["run"], traffic, seed
        self.device = torch.device(device)
        lr = self.run["optimizer"]["lr"]
        cfg = _port_config(moe, self.run)
        params = init_params(seed, self.run, self.device)
        self.state = [params, moe.init_opt_state(params, cfg, lr)]
        self.step_fn = moe.make_train_step(cfg, lr=lr, device=self.device)

    def batch(self, i: int) -> torch.Tensor:
        t = self.traffic
        return feed.global_batch(self.seed, i, self.run["vocab"],
                                 t["global_batch"], t["seq"], self.device,
                                 t["noise"])

    def step(self, i: int) -> torch.Tensor:
        """Step ``i`` on its batch; its loss, on the device."""
        params, opt_state, loss = self.step_fn(*self.state, self.batch(i))
        self.state = [params, opt_state]
        return loss

    def _adam_and_master(self):
        params, opt_state = self.state
        if isinstance(opt_state, tuple):
            return opt_state
        return opt_state, self.moe.trainable(params)

    def grad_norms(self) -> dict:
        """After the first step, of the leaves that the reference's
        ``read`` keeps: each trained leaf's gradient norm as AdamW got
        it, mu / (1 - b1), mu starting at zero; the expert bias's first
        step's norm (it starts at zero)."""
        adam, _ = self._adam_and_master()
        b1 = self.run["optimizer"]["b1"]
        out = {n: float(torch.linalg.vector_norm(mu.float())) / (1 - b1)
               for n, mu in flat(adam["mu"]).items() if reference.read(n)}
        out["expert_bias"] = float(torch.linalg.vector_norm(
            self.state[0]["expert_bias"]))
        return out

    def change_norms(self) -> dict:
        """Each read trained leaf's change from its initial value, of the
        f32 master; and the expert bias's."""
        _, master = self._adam_and_master()
        out = {}
        leaves = {**flat(master),
                  "expert_bias": self.state[0]["expert_bias"]}
        for n, p in leaves.items():
            if reference.read(n):
                p0 = init_leaf(self.seed, self.run, n, self.device)
                out[n] = float(torch.linalg.vector_norm(p.float()
                                                        - p0.float()))
        return out

    def launches(self) -> dict:
        """The attention kernels' launches so far, forward and backward."""
        counts = self.fa.counts()
        return {d: sum(v for k, v in counts.items()
                       if k.startswith(f"flash_attn_{d}"))
                for d in ("fwd", "bwd")}

    def zero_launches(self) -> None:
        """The attention's launch counts and the MoE counter to 0."""
        self.fa.zero_counts()
        self.moe.zero_counts()

    def launch_counts(self) -> dict:
        return self.fa.counts()

    def free(self) -> None:
        self.state = None
        self.step_fn = None


def least_launches(config: dict, steps: int) -> int:
    """The fewest attention launches each way that ``steps`` steps make
    when every attention layer runs through the kernels."""
    return config["run"]["layer_types"].count("attention") * steps


def shape(config: dict, traffic: dict, world: int) -> dict:
    """The attention launches' shape (k and v repeated to every query
    head), and the expert GEMMs' widths."""
    run = config["run"]
    return {"batch": traffic["global_batch"] // world,
            "heads": run["n_heads"], "seq": traffic["seq"],
            "head_dim": run["d_model"] // run["n_heads"],
            "elem_bytes": torch.tensor([], dtype=getattr(
                torch, run["compute_dtype"])).element_size(),
            "d_model": run["d_model"], "expert_d_ff": run["expert_d_ff"],
            "experts": run["n_experts"]}


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
    same inputs as the port's. ``matmul="fp8"`` is the control. ``fault``
    puts a faulty step in the program's place: ``"half"``, half of each
    batch left out (half the rows, or of one row the first half of its
    positions); ``"capacity"``, GShard's capacity at
    :data:`CAPACITY_FAULT` in the dropless route's place."""
    run = config["run"]

    def rows_of_step(i):
        x = feed.global_batch(seed, i, run["vocab"], traffic["global_batch"],
                              traffic["seq"], device, traffic["noise"])
        if fault == "half":
            rows = x.shape[0]
            x = x[:rows // 2] if rows > 1 else x[:, :traffic["seq"] // 2 + 1]
        return x

    capacity = fault == "capacity"
    if capacity:
        run = dict(run, capacity_factor=CAPACITY_FAULT)
    return reference.train_readings(
        run, lambda n: init_leaf(seed, run, n, device), rows_of_step, steps,
        run["optimizer"], matmul=matmul,
        dispatch="capacity" if capacity else "dropless",
        row_block=0 if capacity else traffic.get("reference_row_block", 0))
