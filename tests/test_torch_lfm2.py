"""The port's MoE path at LFM2-8B-A1B's architecture (``moe.MoEConfig``
with ``layer_types``: gated short-conv and GQA mixers, leading dense
layers, the sigmoid router with its expert bias, the dropless sorted
dispatch over grouped expert GEMMs) against the plain reference,
``portbench/reference/lfm2.py``, on the CPU at a tiny shape: one dense
layer and one period of the layer pattern, 4 experts, top-2, 2 kv
heads.

The port runs in f32 for the parity tests (its bf16 run follows the
reference within bf16's rounding); both take the same params, the
port's stacked tree carried to the reference's flat names.

The permutation between tokens and expert rows (``moe.gather_reduce``,
``moe.scatter_rows``): on the CPU their plain versions against the
``index_add_`` / ``index_select`` formulation they replace, in float64,
on balanced picks, on picks biased to two experts (the others' segments
empty) and with weights zeroed as the capacity fault zeroes them. On the
card (marked ``cuda``, each test skips without a CUDA device, decided
inside the fixture) the kernels of ``csrc/moe_permute.cu`` against the
plain versions in bf16, at the lfm2 cell's shape and at odd and ragged
ones, the same bits on two calls, their counters, their refusals:

    python -m pytest --noconftest -q tests/test_torch_lfm2.py -m cuda
"""
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


# The permutation between tokens and expert rows.

#: ``(tokens, picks, width, experts)`` of the CPU cases.
PERMUTE_SHAPES = [(47, 2, 24, 8), (40, 4, 16, 8)]
PERMUTE_CASES = ("balanced", "biased", "capped")


def _sorted_route(case: str, n: int, k: int, experts: int, device="cpu",
                  seed: int = 0) -> moe.SortedRoute:
    """``route_sorted``'s picks of n random tokens: ``balanced`` with no
    bias; ``biased`` with experts 1 and 5 far ahead, so that at k 2 they
    take every pick and the other segments are empty; ``capped``, the
    biased picks with each expert's weights past the mean load zeroed, as
    the benchmark's capacity fault zeroes them."""
    gen = torch.Generator(device).manual_seed(seed)
    d = 32
    y = torch.randn(n, d, generator=gen, device=device)
    router = torch.randn(d, experts, generator=gen, device=device)
    bias = torch.zeros(experts, device=device)
    if case != "balanced":
        bias[1] = bias[5] = 10.0
    cfg = moe.MoEConfig(d_model=d, n_experts=experts, top_k=k,
                        layer_types=("conv", "conv"), n_dense_layers=0)
    route = moe.route_sorted(y, router, bias, cfg)
    if case == "capped":
        cap = k * n // experts
        start = (route.offs.long() - route.load).repeat_interleave(route.load)
        rank = torch.arange(n * k, device=device) - start
        route.weight = torch.where(rank < cap, route.weight, 0.0)
    return route


def _rows(shape: tuple, dtype, device="cpu", seed: int = 1):
    return torch.randn(shape, generator=torch.Generator(device)
                       .manual_seed(seed), device=device).to(dtype)


@pytest.mark.parametrize("shape", PERMUTE_SHAPES)
@pytest.mark.parametrize("case", PERMUTE_CASES)
def test_pos_inverts_the_sort(case, shape):
    n, k, _, experts = shape
    route = _sorted_route(case, n, k, experts)
    assert route.pos.shape == (k, n) and route.pos.dtype == torch.int32
    assert torch.equal(route.token[route.pos.long()],
                       torch.arange(n).expand(k, n))
    assert sorted(route.pos.reshape(-1).tolist()) == list(range(n * k))
    if case != "balanced" and k == 2:
        assert route.load.tolist() == [0, n, 0, 0, 0, n, 0, 0]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", PERMUTE_SHAPES)
@pytest.mark.parametrize("case", PERMUTE_CASES)
def test_plain_gather_reduce_is_the_index_add_it_replaced(case, shape,
                                                          weighted):
    """Combine's forward (weighted) and Dispatch's backward (not)."""
    n, k, d, experts = shape
    route = _sorted_route(case, n, k, experts)
    rows = _rows((n * k, d), torch.float64)
    weight = route.weight.double() if weighted else None
    got = moe.gather_reduce_plain(rows, route.pos, weight)
    terms = rows * weight[:, None] if weighted else rows
    want = torch.zeros(n, d, dtype=torch.float64).index_add_(
        0, route.token, terms)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)
    if case == "capped":
        kept = (route.weight != 0).sum()
        assert 0 < kept < n * k
    assert torch.equal(moe.gather_reduce(rows, route.pos, weight), got)


@pytest.mark.parametrize("shape", PERMUTE_SHAPES)
@pytest.mark.parametrize("case", PERMUTE_CASES)
def test_plain_scatter_rows_is_the_index_select_it_replaced(case, shape):
    """Dispatch's forward, and Combine's backward with its weights'
    gradient."""
    n, k, d, experts = shape
    route = _sorted_route(case, n, k, experts)
    src = _rows((n, d), torch.float64)
    rows = _rows((n * k, d), torch.float64, seed=2)
    weight = route.weight.double()
    assert torch.equal(moe.scatter_rows_plain(src, route.pos),
                       src.index_select(0, route.token))
    g = src.index_select(0, route.token)
    out, dot = moe.scatter_rows_plain(src, route.pos, weight, rows)
    assert torch.equal(out, g * weight[:, None])
    torch.testing.assert_close(dot, (g * rows).sum(-1), rtol=1e-13,
                               atol=1e-13)
    if case == "capped":
        assert not out[weight == 0].any()


@pytest.mark.parametrize("shape", PERMUTE_SHAPES)
@pytest.mark.parametrize("case", PERMUTE_CASES)
def test_dispatch_and_combine_grads_are_autograds_of_the_indexing(case,
                                                                  shape):
    n, k, d, experts = shape
    route = _sorted_route(case, n, k, experts)
    x = _rows((n, d), torch.float64).requires_grad_()
    rows = _rows((n * k, d), torch.float64, seed=2).requires_grad_()
    weight = route.weight.double().requires_grad_()
    up_rows = _rows((n * k, d), torch.float64, seed=3)
    up = _rows((n, d), torch.float64, seed=4)

    dispatched = moe.Dispatch.apply(x, route.pos)
    combined = moe.Combine.apply(rows, weight, route.pos)
    got = torch.autograd.grad((dispatched * up_rows).sum()
                              + (combined * up).sum(), (x, rows, weight))
    want_dispatch = x.index_select(0, route.token)
    want_combine = torch.zeros(n, d, dtype=torch.float64).index_add(
        0, route.token, rows * weight[:, None])
    torch.testing.assert_close(dispatched, want_dispatch, rtol=0, atol=0)
    torch.testing.assert_close(combined, want_combine, rtol=1e-13,
                               atol=1e-13)
    want = torch.autograd.grad((want_dispatch * up_rows).sum()
                               + (want_combine * up).sum(), (x, rows, weight))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def test_plain_path_counts_nothing():
    route = _sorted_route("balanced", 16, 2, 8)
    rows = _rows((32, 8), torch.float32)
    moe.zero_counts()
    moe.scatter_rows(moe.gather_reduce(rows, route.pos, route.weight),
                     route.pos, route.weight, rows)
    c = moe.counts()
    assert c["permute_launches"] == 0 and c["permute_bytes"] == 0


def test_permute_kernels_bear_the_benchmarks_name_marks():
    """The benchmark tells the permutation's kernels by these names."""
    from pathlib import Path
    from portbench.metrics import moe_permute_gbs
    src = (Path(moe.__file__).parent.parent / "csrc" / "moe_permute.cu"
           ).read_text()
    for mark in moe_permute_gbs.KERNELS:
        assert f"{mark}_kernel(" in src, mark
    assert moe._GATHER_REDUCE.library == moe._SCATTER_ROWS.library \
        == "moe_permute"


# On the card.

#: ``(tokens, picks, width, experts)``: the lfm2 cell's layer, an odd n at
#: a ragged width (the one-element path), more picks than a group of 8.
CARD_SHAPES = [(16384, 4, 2048, 32), (4097, 4, 2046, 32), (333, 10, 72, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _card_inputs(card, shape, case="balanced"):
    n, k, d, experts = shape
    route = _sorted_route(case, n, k, experts, card)
    return (route, _rows((n, d), torch.bfloat16, card),
            _rows((n * k, d), torch.bfloat16, card, seed=2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PERMUTE_CASES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_their_plain_versions(card, shape, case):
    """Every output bit for bit but the weights' gradient, a sum in
    another order: within 1e-5 of the sum of its terms' magnitudes."""
    route, src, rows = _card_inputs(card, shape, case)
    for weight in (route.weight, None):
        assert torch.equal(moe.gather_reduce(rows, route.pos, weight),
                           moe.gather_reduce_plain(rows, route.pos, weight))
    assert torch.equal(moe.scatter_rows(src, route.pos),
                       moe.scatter_rows_plain(src, route.pos))
    out, dot = moe.scatter_rows(src, route.pos, route.weight, rows)
    want_out, want_dot = moe.scatter_rows_plain(src, route.pos, route.weight,
                                                rows)
    assert torch.equal(out, want_out)
    token = route.token
    scale = (src.float()[token] * rows.float()).abs().sum(-1)
    assert bool(((dot - want_dot).abs() <= 1e-5 * scale + 1e-30).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_the_same_bits_on_two_calls(card, shape):
    route, src, rows = _card_inputs(card, shape)

    def calls():
        return [moe.gather_reduce(rows, route.pos, route.weight),
                moe.gather_reduce(rows, route.pos),
                moe.scatter_rows(src, route.pos),
                *moe.scatter_rows(src, route.pos, route.weight, rows)]

    for a, b in zip(calls(), calls()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_counters_per_call(card):
    n, k, d, experts = CARD_SHAPES[0]
    route, src, rows = _card_inputs(card, CARD_SHAPES[0])
    moe.zero_counts()
    moe.gather_reduce(rows, route.pos, route.weight)
    moe.gather_reduce(rows, route.pos)
    moe.scatter_rows(src, route.pos)
    moe.scatter_rows(src, route.pos, route.weight, rows)
    c = moe.counts()
    rd, td, r = n * k * d * 2, n * d * 2, n * k
    assert c["permute_launches"] == 4
    assert c["permute_bytes"] == (rd + td + 8 * r) + (rd + td + 4 * r) \
        + (td + rd + 4 * r) + (td + 2 * rd + 12 * r)
    # The lfm2 cell's layer: 335.5 MB a gather-reduce, 604 MB the scatter
    # with its dot.
    assert round((rd + td) / 1e6, 1) == 335.5
    assert round((td + 2 * rd) / 1e6) == 604


@pytest.mark.cuda
def test_refusals(card):
    route, src, rows = _card_inputs(card, (64, 2, 16, 8))
    with pytest.raises(TypeError):
        moe.gather_reduce(rows.float(), route.pos, route.weight)
    with pytest.raises(TypeError):
        moe.scatter_rows(src.float(), route.pos)
    with pytest.raises(TypeError):
        moe.gather_reduce(rows, route.pos.cpu(), route.weight)
    with pytest.raises(TypeError):
        moe.scatter_rows(src, route.pos, route.weight.cpu(), rows)
    with pytest.raises(TypeError):
        moe.gather_reduce(rows, route.pos.long(), route.weight)
    with pytest.raises(TypeError):
        moe.gather_reduce(rows, route.pos, route.weight.bfloat16())
    with pytest.raises(ValueError):
        moe.gather_reduce(rows[:-1], route.pos)
    with pytest.raises(ValueError):
        moe.scatter_rows(src.t().contiguous().t(), route.pos)
    with pytest.raises(ValueError):
        moe.scatter_rows(src, route.pos, route.weight)


@pytest.mark.cuda
def test_the_sorted_layer_launches_only_the_permutation_kernels(card):
    """A sparse FFN's forward and backward on the card: the two kernels,
    twice each, and no index_add_ or mixed-dtype product around them."""
    cfg = moe.MoEConfig(d_model=256, d_ff=128, n_experts=8, top_k=4,
                        layer_types=("conv", "conv"), n_dense_layers=0,
                        param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)
    gen = torch.Generator(card).manual_seed(0)
    lp = {"router": torch.randn(256, 8, generator=gen, device=card),
          **{key: (torch.randn(8, *shape, generator=gen, device=card)
                   * 0.05).bfloat16().requires_grad_()
             for key, shape in (("w1", (256, 128)), ("w3", (256, 128)),
                                ("w2", (128, 256)))}}
    y = torch.randn(2, 512, 256, generator=gen, device=card) \
        .bfloat16().requires_grad_()
    moe.zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, _ = moe.sorted_moe_ffn(y, lp, torch.zeros(8, device=card), cfg)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert moe.counts()["permute_launches"] == 4
    assert sum("moe_gather_reduce" in n for n in names) == 2
    assert sum("moe_scatter_rows" in n for n in names) == 2
    assert not any("indexFuncLargeIndex" in n or "index_add" in n
                   for n in names)
