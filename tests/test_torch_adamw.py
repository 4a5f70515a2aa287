"""The port's AdamW update (``workloads/adamw.py``, ``csrc/adamw.cu``).

On the CPU (tier 1): ``lm.AdamW.update_`` with the mixed-precision state
``(adamw_state, master)`` equals, bit for bit, the two steps it replaced
(AdamW on the master with the gradients cast to f32, then each param
copied from its master); the plain path counts nothing; lists that
disagree raise.

On the card (marked ``cuda``, each test skips without a CUDA device,
decided inside the fixture): each of the kernel's two instances (bf16
gradients with a bf16 out; f32 gradients in place) against the plain
``torch._foreach_*`` chain on the same inputs, at lengths around its
4-element vectors and 16384-element chunks (1, 3, 7, 8, 9, 4095, 4097,
2^20 + 5), on views at aligned storage, at one unaligned offset in
every array (the vector path after a head) and at offsets that no
element aligns (the scalar path), at t 1 and 1000 and weight decay 0
and 0.01. mu, nu and the master within 2 f32 ulps of the largest term
of the sum that made each (a sum that cancels is judged by its terms);
the bf16 out bit for bit the round-to-nearest-even of the kernel's own
master; nothing written outside the views. Then more leaves than one
launch takes, with a leaf of several chunks and an empty one; the
refusals (a non-contiguous leaf, dtype pairs the kernel does not take,
CPU and CUDA tensors in one update); and the counter after one train
step of a small bf16 LM and of an f32 one.

    python -m pytest --noconftest -q tests/test_torch_adamw.py
"""
import pytest
import torch

from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.workloads import adamw
from kubernetes_tpu_torch.workloads import lm

TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            attn_impl="local")
HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8)


def _mixed_tree_and_grads(seed: int):
    """A bf16 LM's params, mixed-precision state and one batch's bf16
    gradients, on the CPU."""
    cfg = lm.LMConfig(**TINY, param_dtype=torch.bfloat16)
    params, opt_state = lm.init_train_state(
        torch.Generator().manual_seed(seed), cfg)
    batch = lm.synthetic_batch(torch.Generator().manual_seed(seed + 1), cfg,
                               2, 16, device="cpu")
    _, grads = lm.loss_and_grads(params, batch, cfg)
    return params, opt_state, grads


def test_mixed_update_is_the_two_steps_it_replaced():
    params, (inner, master), grads = _mixed_tree_and_grads(0)
    want_params, (want_inner, want_master), _ = _mixed_tree_and_grads(0)
    opt = lm.make_optimizer(1e-3)
    for _ in range(2):
        opt.update_(params, grads, (inner, master))
        opt.update_(want_master, lm._tree_map(lambda g: g.float(), grads),
                    want_inner)
        for p, m in zip(lm._leaves(want_params), lm._leaves(want_master)):
            p.copy_(m)
    assert int(inner["count"]) == int(want_inner["count"]) == 2
    for got, want in [(params, want_params), (master, want_master),
                      (inner["mu"], want_inner["mu"]),
                      (inner["nu"], want_inner["nu"])]:
        for a, b in zip(lm._leaves(got), lm._leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for p, m in zip(lm._leaves(params), lm._leaves(master)):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, m.to(torch.bfloat16))


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
def test_plain_path_counts_nothing(param_dtype):
    adamw.zero_counts()
    cfg = lm.LMConfig(**TINY, param_dtype=param_dtype)
    params, opt_state = lm.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator().manual_seed(1), cfg, 2, 16,
                               device="cpu")
    before = [p.clone() for p in lm._leaves(params)]
    lm.make_train_step(cfg, device="cpu")(params, opt_state, batch)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, lm._leaves(params)))
    assert adamw.counts() == {"updates": 0, "launches": 0, "leaves": 0,
                              "elements": 0, "bytes": 0}


def test_lists_of_other_lengths_or_devices_raise():
    x = [torch.zeros(4)]
    with pytest.raises(ValueError, match="one length"):
        adamw.adamw_(x, x + x, x, x, **HYPER, weight_decay=0.0, t=1)
    meta = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="one device"):
        adamw.adamw_(x, meta, x, x, **HYPER, weight_decay=0.0, t=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        adamw.adamw_(meta, meta, meta, meta, **HYPER, weight_decay=0.0, t=1)
    adamw.adamw_([], [], [], [], **HYPER, weight_decay=0.0, t=1)


def test_kernel_bears_the_benchmarks_name_mark():
    """The benchmark tells the update's kernel by this name."""
    src = (build.CSRC / "adamw.cu").read_text()
    assert "adamw_kernel(" in src


# --- on the card ---------------------------------------------------------

LENGTHS = [1, 3, 7, 8, 9, 4095, 4097, (1 << 20) + 5]
#: Element offsets of g, p, mu, nu, out in their buffers: all aligned;
#: all one element in (the vector path from the third or fourth
#: element); no index at which all align (the scalar path).
LAYOUTS = {"aligned": (0, 0, 0, 0, 0), "same": (1, 1, 1, 1, 1),
           "none": (1, 2, 3, 0, 1)}
SENTINEL = 7.0


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _view(values: torch.Tensor, offset: int, dtype) -> tuple:
    """``values`` as ``dtype`` at ``offset`` elements into a buffer of
    sentinels; ``(view, buffer)``."""
    n = values.numel()
    buf = torch.full((n + 8,), SENTINEL, dtype=dtype, device="cuda")
    view = buf[offset:offset + n]
    view.copy_(values)
    return view, buf


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One f32 ulp at each ``|x|`` (float64)."""
    x = x.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 23)


def _inputs(n: int, gdtype, gen):
    g = torch.randn(n, generator=gen, device="cuda").to(gdtype)
    p = torch.randn(n, generator=gen, device="cuda")
    mu = torch.randn(n, generator=gen, device="cuda") * 0.1
    nu = torch.rand(n, generator=gen, device="cuda") * 0.01
    return g, p, mu, nu


def _assert_close(got: tuple, want: tuple, inputs: tuple, t: int,
                  wd: float) -> None:
    """The kernel's ``(p, mu, nu)`` within 2 f32 ulps of the plain
    chain's, each judged by the largest term of the sum that made it,
    from the same ``inputs`` ``(g, p, mu, nu)``."""
    (p, mu, nu), (wp, wmu, wnu), (g0, p0, mu0, nu0) = got, want, inputs
    b1, b2, lr = HYPER["b1"], HYPER["b2"], HYPER["lr"]
    mu_scale = torch.maximum((b1 * mu0.double()).abs(),
                             ((1 - b1) * g0.double()).abs())
    assert ((mu.double() - wmu.double()).abs()
            <= 2 * _ulp(mu_scale)).all()
    assert ((nu.double() - wnu.double()).abs() <= 2 * _ulp(wnu)).all()
    den = (wnu.double() / (1 - b2 ** t)).sqrt() + HYPER["eps"]
    u_scale = mu_scale / (1 - b1 ** t) / den + wd * p0.double().abs()
    p_scale = torch.maximum(p0.double().abs(), lr * u_scale)
    assert ((p.double() - wp.double()).abs() <= 2 * _ulp(p_scale)).all()


def _plain(inputs: tuple, mixed: bool, **hyper) -> tuple:
    """The plain chain on copies of ``inputs``: ``(p, mu, nu, out)``."""
    g0, p0, mu0, nu0 = inputs
    wp, wmu, wnu = p0.clone(), mu0.clone(), nu0.clone()
    wout = torch.empty(g0.shape, dtype=g0.dtype, device="cuda") \
        if mixed else None
    adamw.adamw_plain([wp], [g0.clone()], [wmu], [wnu], **hyper,
                      out=None if wout is None else [wout])
    return wp, wmu, wnu, wout


@pytest.mark.cuda
@pytest.mark.parametrize("t,wd", [(1, 0.0), (1, 0.01), (1000, 0.0),
                                  (1000, 0.01)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_the_plain_chain(gen, gdtype, n, layout, t, wd):
    inputs = _inputs(n, gdtype, gen)
    mixed = gdtype is torch.bfloat16
    offs = LAYOUTS[layout]
    views = [_view(x, off, x.dtype) for x, off in zip(inputs, offs)]
    if mixed:
        views.append(_view(torch.zeros(n, device="cuda"), offs[4], gdtype))
    (g, _), (p, _), (mu, _), (nu, _) = views[:4]
    out = views[4][0] if mixed else None
    hyper = dict(HYPER, weight_decay=wd, t=t)
    adamw.adamw_([p], [g], [mu], [nu], **hyper,
                 out=None if out is None else [out])
    wp, wmu, wnu, wout = _plain(inputs, mixed, **hyper)
    torch.cuda.synchronize()
    _assert_close((p, mu, nu), (wp, wmu, wnu), inputs, t, wd)
    if mixed:
        assert torch.equal(out, p.to(torch.bfloat16))
        assert torch.equal(wout, wp.to(torch.bfloat16))
    for (_, buf), off in zip(views, offs):
        outside = torch.cat([buf[:off], buf[off + n:]])
        assert (outside == SENTINEL).all()


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_many_leaves_over_several_launches(gen, gdtype):
    sizes = [1 + (i * 37) % 300 for i in range(129)]
    sizes[5] = 3 * 16384 + 5   # several chunks
    sizes.insert(70, 0)         # an empty leaf: no chunk
    mixed = gdtype is torch.bfloat16
    inputs = [_inputs(n, gdtype, gen) for n in sizes]
    p = [x[1].clone() for x in inputs]
    mu = [x[2].clone() for x in inputs]
    nu = [x[3].clone() for x in inputs]
    out = [torch.empty(n, dtype=gdtype, device="cuda")
           for n in sizes] if mixed else None
    hyper = dict(HYPER, weight_decay=0.01, t=7)
    adamw.zero_counts()
    adamw.adamw_(p, [x[0] for x in inputs], mu, nu, **hyper, out=out)
    assert adamw.counts() == {
        "updates": 1, "leaves": 129, "launches": 3,   # 64 leaves a launch
        "elements": sum(sizes), "bytes": 28 * sum(sizes)}
    for i, x in enumerate(inputs):
        wp, wmu, wnu, _ = _plain(x, mixed, **hyper)
        _assert_close((p[i], mu[i], nu[i]), (wp, wmu, wnu), x, 7, 0.01)
        if mixed:
            assert torch.equal(out[i], p[i].to(torch.bfloat16))


@pytest.mark.cuda
def test_refusals(gen):
    cuda = "cuda"
    f32 = torch.float32

    def leaf(n=16, g=torch.bfloat16, p=f32, m=f32, o=torch.bfloat16,
             gdev=cuda):
        return ([torch.zeros(n, dtype=p, device=cuda)],
                [torch.zeros(n, dtype=g, device=gdev)],
                [torch.zeros(n, dtype=m, device=cuda)],
                [torch.zeros(n, dtype=m, device=cuda)],
                None if o is None else [torch.zeros(n, dtype=o,
                                                     device=cuda)])

    def run(params, grads, mu, nu, out):
        adamw.adamw_(params, grads, mu, nu, **HYPER, weight_decay=0.0, t=1,
                     out=out)

    params, mu, nu = ([torch.zeros(8, 2, device=cuda)] for _ in range(3))
    grads = [torch.zeros(2, 8, dtype=torch.bfloat16, device=cuda).t()]
    out = [torch.zeros(8, 2, dtype=torch.bfloat16, device=cuda)]
    assert not grads[0].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        run(params, grads, mu, nu, out)
    for bad in [dict(o=None),                         # bf16 g, no out
                dict(g=f32),                          # f32 g with an out
                dict(g=torch.float16, o=torch.float16),
                dict(m=torch.bfloat16),               # bf16 moments
                dict(p=torch.bfloat16, g=f32, o=None)]:
        with pytest.raises(TypeError):
            run(*leaf(**bad))
    with pytest.raises(ValueError, match="one device"):
        run(*leaf(gdev="cpu"))
    params, grads, mu, nu, out = leaf()
    with pytest.raises(ValueError, match="one device"):
        run([params[0].cpu()], grads, mu, nu, out)


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
def test_train_step_goes_through_the_kernel(gen, param_dtype):
    cfg = lm.LMConfig(**{**TINY, "attn_impl": "flash"},
                      param_dtype=param_dtype)
    params, opt_state = lm.init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                               cfg, 2, 16, device="cuda")
    leaves = lm._leaves(params)
    elements = sum(p.numel() for p in leaves)
    adamw.zero_counts()
    lm.make_train_step(cfg, device="cuda")(params, opt_state, batch)
    torch.cuda.synchronize()
    assert adamw.counts() == {
        "updates": 1, "leaves": len(leaves), "launches": 1,
        "elements": elements, "bytes": 28 * elements}
    if param_dtype is torch.bfloat16:
        _, master = opt_state
        for p, m in zip(leaves, lm._leaves(master)):
            assert torch.equal(p, m.to(torch.bfloat16))
