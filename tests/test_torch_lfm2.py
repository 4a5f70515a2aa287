"""The port's MoE path at LFM2-8B-A1B's architecture (``moe.MoEConfig``
with ``layer_types``: gated short-conv and GQA mixers, leading dense
layers, the sigmoid router with its expert bias, the dropless sorted
dispatch over grouped expert GEMMs) against the plain reference,
``portbench/reference/lfm2.py``, on the CPU at a tiny shape: one dense
layer and one period of the layer pattern, 4 experts, top-2, 2 kv
heads.

The port runs in f32 for the parity tests (its bf16 run follows the
reference within bf16's rounding); both take the same params, the
port's stacked tree carried to the reference's flat names."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kubernetes_tpu_torch.workloads import lm, moe
from portbench.reference import lfm2 as ref
from portbench.reference import lm as ref_lm

LAYERS = ("conv", "attention", "conv", "conv", "conv")
B, T = 2, 32


def _cfg(**kw) -> moe.MoEConfig:
    base = dict(vocab=128, d_model=64, n_layers=len(LAYERS), n_heads=4,
                n_kv_heads=2, d_ff=32, n_experts=4, top_k=2,
                rope_base=1e6, layer_types=LAYERS, qk_norm=True,
                n_dense_layers=1, dense_d_ff=96, param_dtype=torch.float32,
                compute_dtype=torch.float32)
    return moe.MoEConfig(**{**base, **kw})


def _run(cfg: moe.MoEConfig) -> dict:
    """The reference's ``run`` of ``cfg``."""
    return {"vocab": cfg.vocab, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.kv_heads,
            "layer_types": list(cfg.layer_types),
            "conv_kernel": cfg.conv_kernel,
            "n_dense_layers": cfg.n_dense_layers,
            "dense_d_ff": cfg.dense_d_ff, "n_experts": cfg.n_experts,
            "top_k": cfg.top_k, "expert_d_ff": cfg.d_ff,
            "norm_topk": cfg.norm_topk, "routed_scale": cfg.routed_scale,
            "bias_rate": cfg.bias_rate, "rope_base": cfg.rope_base,
            "norm_eps": 1e-6}


def _flat(tree: dict) -> dict:
    """The port's params under the reference's dotted names."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update({f"{key}.{k}": v for k, v in val.items()})
        else:
            out[key] = val
    return out


def _params(cfg: moe.MoEConfig, seed: int = 0, bias_scale: float = 0.0):
    params = moe.init_params(torch.Generator().manual_seed(seed), cfg)
    if bias_scale:
        params["expert_bias"].normal_(
            0.0, bias_scale, generator=torch.Generator().manual_seed(seed))
    return params


def _ref_params(params: dict, grad: bool = False) -> dict:
    return {n: p.detach().float().clone().requires_grad_(grad)
            for n, p in _flat(params).items()}


def _batch(cfg: moe.MoEConfig, seed: int = 1) -> torch.Tensor:
    return moe.synthetic_batch(torch.Generator().manual_seed(seed), cfg, B,
                               T, "cpu")


def _close(a, b, rtol=2e-5, atol=2e-6):
    torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 3])
def test_logits_match_the_reference(seed):
    cfg = _cfg()
    params, batch = _params(cfg, seed, 0.05), _batch(cfg, seed)
    got, aux = moe.forward(params, batch[:, :-1], cfg)
    assert aux is None
    want = ref.logits(_ref_params(params), batch[:, :-1], _run(cfg))
    _close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_loss_and_every_gradient_match_the_reference(seed):
    cfg = _cfg()
    params, batch = _params(cfg, seed, 0.05), _batch(cfg, seed)
    loss, grads = moe.loss_and_grads(params, batch, cfg)
    rp = _ref_params(params, grad=True)
    rp["expert_bias"].requires_grad_(False)
    want = ref.loss_sum(rp, batch, _run(cfg)) / (B * T)
    want.backward()
    _close(loss, want.detach())
    flat = _flat(grads)
    assert set(flat) == set(rp) - {"expert_bias"}
    for name, g in flat.items():
        _close(g, rp[name].grad, rtol=1e-4, atol=1e-6)


def test_two_adamw_steps_with_the_bias_update_match_the_reference():
    cfg = _cfg()
    params = _params(cfg, 2)
    opt_state = moe.init_opt_state(params, cfg, lr=1e-3)
    step = moe.make_train_step(cfg, lr=1e-3, device="cpu")
    rp = _ref_params(params, grad=True)
    bias = rp.pop("expert_bias").detach()
    names = list(rp)
    state = {"count": 0, "m": {}, "v": {}}
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.01}
    for i in range(2):
        batch = _batch(cfg, 10 + i)
        params, opt_state, loss = step(params, opt_state, batch)
        loads = {}
        want = ref.loss_sum({**rp, "expert_bias": bias}, batch, _run(cfg),
                            loads=loads) / (B * T)
        want.backward()
        _close(loss, want.detach())
        ref_lm._adamw_({n: rp[n].data for n in names},
                       {n: rp[n].grad for n in names}, state, opt)
        ref.update_bias_(bias, loads, cfg.bias_rate)
        for p in rp.values():
            p.grad = None
    got = _flat(params)
    assert torch.count_nonzero(got["expert_bias"]) > 0
    torch.testing.assert_close(got["expert_bias"], bias, rtol=0, atol=1e-9)
    for name in names:
        _close(got[name], rp[name].detach(), rtol=1e-4, atol=1e-6)


def test_bf16_step_follows_the_reference():
    cfg = _cfg(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params, batch = _params(cfg, 4), _batch(cfg, 4)
    loss, grads = moe.loss_and_grads(params, batch, cfg)
    want = ref.loss_sum(_ref_params(params), batch, _run(cfg)) / (B * T)
    assert abs(float(loss) - float(want)) / float(want) < 2e-2
    assert all(g.dtype == torch.bfloat16 for g in _flat(grads).values())


def _per_token(y, lp, bias, cfg):
    """The sparse FFN one token and pick at a time."""
    out = torch.zeros_like(y)
    s = torch.sigmoid(y @ lp["router"])
    for n in range(y.shape[0]):
        idx = torch.topk(s[n] + bias, cfg.top_k).indices
        w = s[n, idx] / (s[n, idx].sum() + 1e-6) * cfg.routed_scale
        for j, e in enumerate(idx.tolist()):
            h = torch.nn.functional.silu(y[n] @ lp["w1"][e]) \
                * (y[n] @ lp["w3"][e])
            out[n] += w[j] * (h @ lp["w2"][e])
    return out


@pytest.mark.parametrize("imbalance", [0.0, 10.0])
def test_dropless_dispatch_matches_a_per_token_loop(imbalance):
    """Balanced picks, and one expert biased to take every token's first
    pick (the others' segments short or empty): nothing is dropped."""
    cfg = _cfg()
    params = _params(cfg, 5)
    lp = {k: v[0] for k, v in params["sparse"].items()}
    bias = torch.zeros(cfg.n_experts)
    bias[1] = imbalance
    y = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    moe.zero_counts()
    out, load = moe.sorted_moe_ffn(y, lp, bias, cfg)
    want = _per_token(y.reshape(-1, cfg.d_model), lp, bias, cfg)
    _close(out.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-6)
    n = B * T
    assert int(load.sum()) == n * cfg.top_k
    if imbalance:
        assert int(load[1]) == n
    c = moe.counts()
    assert c["rows"] == n * cfg.top_k
    assert c["layers"] == 1 and c["max_rows"] == int(load.max())
    assert c["gemm_calls"] == 0  # the CPU's loop is no grouped GEMM


def test_dispatch_and_combine_gradients_match_autograd():
    cfg = _cfg()
    params = _params(cfg, 8)
    lp = {k: v[0].clone().requires_grad_() for k, v in
          params["sparse"].items() if k != "ln"}
    y = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(9), requires_grad=True)
    bias = torch.zeros(cfg.n_experts)
    out, _ = moe.sorted_moe_ffn(y, lp, bias, cfg)
    out.square().sum().backward()
    rlp = {k: v.detach().clone().requires_grad_() for k, v in lp.items()}
    ry = y.detach().clone().requires_grad_()
    want, _ = ref.sparse_ffn(ry, rlp, bias, _run(cfg), "f32", "dropless")
    want.square().sum().backward()
    _close(y.grad, ry.grad, rtol=1e-4, atol=1e-6)
    for k in lp:
        _close(lp[k].grad, rlp[k].grad, rtol=1e-4, atol=1e-6)


def test_short_conv_is_causal():
    """Changing token t + 1 leaves every output at t and before as it
    was, in the conv alone and in the whole stack."""
    cfg = _cfg()
    x = torch.randn(1, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    w = torch.randn(cfg.d_model, cfg.conv_kernel)
    t = T // 2
    moved = x.clone()
    moved[:, t + 1] += 1.0
    a, b = moe.causal_conv(x, w), moe.causal_conv(moved, w)
    assert torch.equal(a[:, :t + 1], b[:, :t + 1])
    assert not torch.allclose(a[:, t + 1:t + 3], b[:, t + 1:t + 3])
    want = ref.conv_mixer(x, {"in_proj": torch.eye(cfg.d_model).repeat(1, 3),
                              "conv": w, "out_proj": torch.eye(cfg.d_model)},
                          "f32")
    _close(x * moe.causal_conv(x * x, w), want)
    cfg = _cfg(layer_types=("conv",) * 3, n_layers=3, n_dense_layers=0)
    params = _params(cfg, 2)
    tokens = _batch(cfg)[:1, :-1]
    other = tokens.clone()
    other[:, t + 1] = (other[:, t + 1] + 1) % cfg.vocab
    ha, _ = moe.hidden_states(params, tokens, cfg)
    hb, _ = moe.hidden_states(params, other, cfg)
    assert torch.equal(ha[:, :t + 1], hb[:, :t + 1])


def test_gqa_matches_the_reference_per_group_attention():
    cfg = _cfg()
    params = _params(cfg, 11)
    mp = {k: v[0] for k, v in params["attention"].items()}
    mp["q_norm"] = torch.rand(cfg.head_dim) + 0.5
    mp["k_norm"] = torch.rand(cfg.head_dim) + 0.5
    y = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(12))
    got = moe._gqa_mixer(y, mp, cfg, moe._flash)
    _close(got, ref.attention_mixer(y, mp, _run(cfg), "f32"), rtol=1e-4,
           atol=1e-5)


class _Mesh:
    """A stand-in for a DeviceMesh of two ranks."""
    mesh_dim_names = moe.MOE_AXES

    def size(self):
        return 2


@pytest.mark.parametrize("make", [
    lambda cfg, mesh: moe.make_train_step(cfg, mesh=mesh, device="cpu"),
    lambda cfg, mesh: moe.hidden_states({}, None, cfg, mesh),
    lambda cfg, mesh: moe.shard_params({}, cfg, mesh),
])
def test_new_options_raise_under_a_mesh(make):
    with pytest.raises(ValueError, match="all-to-all"):
        make(_cfg(), _Mesh())


@pytest.mark.parametrize("option", [
    {"n_kv_heads": 2}, {"qk_norm": True}, {"conv_kernel": 4},
    {"norm_topk": False}, {"routed_scale": 2.5}, {"bias_rate": 1e-2},
    {"n_dense_layers": 1, "dense_d_ff": 8}])
def test_new_options_need_layer_types(option):
    with pytest.raises(ValueError, match="layer_types"):
        moe.MoEConfig(**option)


@pytest.mark.parametrize("bad", [
    {"layer_types": ("conv",) * 2}, {"layer_types": ("mamba",) * 5},
    {"n_kv_heads": 3}, {"n_dense_layers": len(LAYERS) + 1},
    {"n_dense_layers": 1, "dense_d_ff": 0}])
def test_config_refusals(bad):
    with pytest.raises(ValueError):
        _cfg(**bad)


def test_the_default_config_is_todays_model():
    cfg = moe.MoEConfig()
    assert not cfg.hybrid and cfg.kv_heads == cfg.n_heads
    params = moe.init_params(torch.Generator().manual_seed(0), cfg)
    assert set(params) == {"embed", "layers", "ln_f"}
    assert set(params["layers"]) == set(moe._LAYER_KEYS)


def test_params_are_few_stacked_leaves():
    cfg = _cfg(param_dtype=torch.bfloat16)
    params = _params(cfg)
    flat = _flat(params)
    assert set(flat) == set(ref.leaf_shapes(_run(cfg)))
    assert {n: tuple(p.shape) for n, p in flat.items()} \
        == ref.leaf_shapes(_run(cfg))
    assert flat["expert_bias"].dtype == torch.float32
    opt_state, master = moe.init_opt_state(params, cfg)
    assert "expert_bias" not in master
    assert len(lm._leaves(master)) == len(flat) - 1 < 64
    specs = moe.param_specs(cfg)
    assert specs["sparse"]["w1"] == (None,) * 4


def test_the_step_opens_its_spans_and_counts_its_layers():
    cfg = _cfg()
    params = _params(cfg)
    step = moe.make_train_step(cfg, device="cpu")
    moe.zero_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, moe.init_opt_state(params, cfg), _batch(cfg))
    names = [e.name for e in prof.events()]
    sparse = cfg.sparse_layers
    for name, n in (("lm.forward", 1), ("lm.backward", 1), ("lm.update", 1),
                    ("lm.layer", 2 * cfg.n_layers), ("moe.route", 2 * sparse),
                    ("moe.dispatch", 2 * sparse), ("moe.experts", 2 * sparse),
                    ("moe.combine", 2 * sparse),
                    ("moe.dispatch.bwd", sparse), ("moe.experts.bwd", sparse),
                    ("moe.combine.bwd", sparse),
                    ("moe.conv", 2 * LAYERS.count("conv")),
                    ("attention.fwd", 2), ("attention.bwd", 1)):
        assert names.count(name) == n, name
    c = moe.counts()
    assert c["layers"] == 2 * sparse
    assert c["rows"] == 2 * sparse * B * T * cfg.top_k
