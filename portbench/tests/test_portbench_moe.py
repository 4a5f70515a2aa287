"""The MoE cell's files and code: the LFM2 configuration's keys against
what it runs, a CPU rehearsal of the cell at tiny widths through
``cell.run_rank`` (``correct`` for the sound port, not for each planted
fault), ``expert_gemm_roofline`` on a synthetic trace, and on the card
(marker ``cuda``) one step that waits for nothing on the host.

    python -m pytest -q portbench/tests/test_portbench_moe.py
"""
import copy

import pytest
import torch

from portbench import run, spec
from portbench.tests import rehearsal

CELL = "lfm2-8b-a1b-train-t8k"

#: The published keys and the ``run`` keys they set.
PAIRS = [("hidden_size", "d_model"), ("intermediate_size", "dense_d_ff"),
         ("moe_intermediate_size", "expert_d_ff"),
         ("num_attention_heads", "n_heads"),
         ("num_key_value_heads", "n_kv_heads"),
         ("num_hidden_layers", "n_layers"), ("vocab_size", "vocab"),
         ("norm_eps", "norm_eps"), ("rope_theta", "rope_base"),
         ("num_experts", "n_experts"), ("num_experts_per_tok", "top_k"),
         ("num_dense_layers", "n_dense_layers"),
         ("conv_L_cache", "conv_kernel"),
         ("routed_scaling_factor", "routed_scale"),
         ("norm_topk_prob", "norm_topk")]

#: The cut cell: two dense layers and one period, in f32, so that the
#: port reads the reference to f32's rounding and no routing flips.
TINY = {"vocab": 256, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "n_layers": 6, "layer_types": ["conv", "conv", "attention", "conv",
                                       "conv", "conv"],
        "dense_d_ff": 96, "n_experts": 4, "top_k": 2, "expert_d_ff": 32,
        "param_dtype": "float32", "compute_dtype": "float32"}


def test_lfm2_config_run_matches_its_keys():
    """The key check of ``test_portbench_files`` for ``lfm2_moe``: a key
    the port runs otherwise keeps its published value, and the file says
    why under ``departures``."""
    c = spec.load(CELL)["config"]
    r = c["run"]
    assert c["model_type"] == "lfm2_moe"
    for key, name in PAIRS:
        assert c[key] == r[name] or key in c["departures"], key
    assert [{"full_attention": "attention"}.get(t, t)
            for t in c["layer_types"]] == r["layer_types"]
    assert c["layer_types"] == c["published"]["layer_types"][:r["n_layers"]]
    assert c["use_expert_bias"] and not c["conv_bias"]
    assert set(c["published"]) == set(c["reduced_why"])
    bench = [x for x in spec.benchmark()["configs"] if x["name"] == c["name"]]
    assert set(bench[0]["reduced"]) == set(c["published"])


def test_lfm2_sizes_are_the_accounting_s():
    from portbench.accounting import moe as acc
    from portbench.reference import lfm2
    c = spec.load(CELL)["config"]
    sizes, r = c["sizes"], c["run"]
    numel = {n: torch.Size(s).numel()
             for n, s in lfm2.leaf_shapes(r).items() if n != "expert_bias"}
    assert sum(numel.values()) == sizes["params"]
    assert sum(v for n, v in numel.items() if n.startswith("sparse.w")) \
        == sizes["experts"]
    assert acc.active_matmul_params(r) == sizes["active_matmul_params_a_token"]
    assert acc.train_flops_per_token(r, 8192) \
        == sizes["train_flops_a_token_t8192"]


@pytest.mark.parametrize("cut", [4, 10])
def test_moe_flops_equal_a_count_of_the_reference(monkeypatch, cut):
    """``accounting/moe``'s matmul FLOPs a token against PyTorch's FLOP
    counter over the reference's forward at the cell's widths and its
    first ``cut`` layers (the vocabulary cut to 512, weights that are
    one zero broadcast: every token picks the first top-k experts). The
    attention's score and value products (the MFU convention's 2 T d a
    token and layer, apart) and the short conv's taps are left out of
    both."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.accounting import moe as acc
    from portbench.reference import lfm2
    run = dict(spec.load(CELL)["config"]["run"], vocab=512)
    run.update(layer_types=run["layer_types"][:cut], n_layers=cut)
    params = {n: torch.zeros(()).expand(shape)
              for n, shape in lfm2.leaf_shapes(run).items()}
    seq = 16
    monkeypatch.setattr(lfm2, "grouped_attention", lambda q, k, v: q)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        lfm2.logits(params, torch.zeros((1, seq), dtype=torch.long), run)
    counted = sum(n for op, n in counter.get_flop_counts()["Global"].items()
                  if "convolution" not in str(op))
    attention = 2 * seq * run["d_model"] * run["layer_types"].count(
        "attention")
    assert counted == seq * (acc.forward_flops_per_token(run, seq)
                             - attention)
    assert acc.train_flops_per_token(run, seq) \
        == 3 * acc.forward_flops_per_token(run, seq)


#: Limits for the cut cell in f32: above what sound runs of the port
#: read at these widths (loss <= 1.6e-7, grad <= 4.5e-7, change <=
#: 2.7e-6 over four seeds), under what each planted fault reads
#: (``half``: grad >= 0.48; the capacity fault: grad >= 0.016; the
#: expert bias left where it was: grad >= 8e-3, change >= 0.21; a state
#: left unchanged: 1).
MOE_TEST_LIMITS = {"loss": 1e-4, "grad": 1e-3, "change": 1e-3}


def _tiny_cell(**run_kw) -> dict:
    cell = copy.deepcopy(spec.load(CELL))
    cell["config"]["run"].update(TINY, **run_kw)
    cell["traffic"].update(global_batch=2, seq=64)
    cell["workload"]["limits"] = dict(MOE_TEST_LIMITS)
    return cell


def _plant(fault: str, monkeypatch) -> None:
    """Break the port's step: ``unchanged``, AdamW leaves the state as
    it was; ``half``, half of the batch left out; ``capacity``, each
    expert keeps its first ``CAPACITY_FAULT`` x mean load of picks
    (GShard's capacity, the reference's fault); ``bias``, the expert
    bias never moves."""
    from kubernetes_tpu_torch.workloads import lm, moe
    if fault == "unchanged":
        monkeypatch.setattr(lm.AdamW, "update_",
                            lambda self, params, grads, state: None)
    elif fault == "half":
        loss_fn = moe.loss_fn

        def half(params, batch, cfg, *args, **kw):
            return loss_fn(params, batch[:batch.shape[0] // 2], cfg, *args,
                           **kw)

        monkeypatch.setattr(moe, "loss_fn", half)
    elif fault == "capacity":
        from portbench.entries import moe_train
        route = moe.route_sorted

        def capped(y, router_w, bias, cfg):
            # GShard's capacity: each expert keeps its first picks in
            # (round, token) order, the order of its rows here.
            r = route(y, router_w, bias, cfg)
            cap = int(moe_train.CAPACITY_FAULT * cfg.top_k * y.shape[0]
                      / cfg.n_experts)
            start = (r.offs.long() - r.load).repeat_interleave(r.load)
            pos = torch.arange(r.weight.shape[0]) - start
            r.weight = torch.where(pos < cap, r.weight, 0.0)
            return r

        monkeypatch.setattr(moe, "route_sorted", capped)
    elif fault == "bias":
        monkeypatch.setattr(moe, "update_bias_", lambda *args: None)


def _rehearse(fault: str, monkeypatch, seed: int) -> tuple:
    from kubernetes_tpu_torch.workloads import flash_attention as fa
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        monkeypatch.setattr(fa, name, getattr(fa, name))
    rehearsal.count_cpu_launches()
    _plant(fault, monkeypatch)
    cell = _tiny_cell()
    res = run.run_cell(cell, seed, 0.3, False, "cpu")
    line, correct, compared = run.result_line(cell, res, False)
    return correct, compared


@pytest.mark.parametrize("seed", [31, 2 ** 31 + 77])
def test_sound_step_is_correct(monkeypatch, seed):
    from kubernetes_tpu_torch.workloads import moe
    correct, compared = _rehearse("", monkeypatch, seed)
    assert correct, compared
    assert moe.counts()["rows"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "capacity", "bias"])
def test_fault_is_not_correct(monkeypatch, fault):
    correct, compared = _rehearse(fault, monkeypatch, 31)
    assert not correct, compared


def test_expert_gemm_roofline_on_a_synthetic_trace(monkeypatch):
    from kubernetes_tpu_torch.workloads import moe
    from portbench.accounting import moe as acc
    from portbench.metrics import expert_gemm_roofline as reader
    monkeypatch.setattr(moe, "counts", lambda: {"gemm_calls": 9,
                                                "gemm_rows": 9 * 65536})
    ctx = {"shape": {"d_model": 2048, "expert_d_ff": 1792, "experts": 32},
           "accounting": acc, "peak_flops": 989e12, "peak_bytes": 3.35e12,
           # Two grouped GEMM kernels of 2 ms and one other kernel (us).
           "kernels": [("void cutlass::device_kernel<GemmUniversal<cutlass::"
                        "gemm::GroupProblemShape<cute::tuple<int>>>>", 0, 2000),
                       ("x<GroupProblemShape>", 3000, 5000),
                       ("vectorized_elementwise_kernel", 0, 9000)]}
    bound = 9 * 2 * 65536 * 2048 * 1792 / 989e12
    assert reader.read(ctx) == pytest.approx(bound / 4e-3 * 100)
    monkeypatch.setattr(moe, "counts", lambda: {"gemm_calls": 0,
                                                "gemm_rows": 0})
    assert reader.read(ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_one_lfm2_step_waits_for_nothing_on_the_host(card):
    """A step at a cut width (one dense layer, a period, 8 experts) under
    ``set_sync_debug_mode("error")``: any host sync raises. Its grouped
    GEMMs run as such, and drop nothing."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.workloads import moe
    from portbench.entries import moe_train
    build.build(("flash_attn_fwd", "flash_attn_bwd"))
    cell = _tiny_cell(d_model=512, n_heads=8, n_kv_heads=2, n_experts=8,
                      expert_d_ff=256, dense_d_ff=1024, vocab=4096,
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    entry = moe_train.Entry(cell["config"], dict(cell["traffic"], seq=1024),
                            3, "cuda")
    entry.step(0)
    torch.cuda.synchronize()
    moe.zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        entry.step(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    c = moe.counts()
    sparse = len(TINY["layer_types"]) - cell["config"]["run"]["n_dense_layers"]
    assert c["gemm_calls"] == sparse * (3 + 3 + 6)
