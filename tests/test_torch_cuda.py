"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture, never at import). This file imports no JAX, so it runs on a
GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: vector add is exact (both add in f32 and round once), at
lengths around its 16-byte vectors and on views at odd offsets; the
flash kernel's ``o`` within 1e-2 + 2^-6 |o| (both round ``o`` to bf16,
the kernel also rounds P to bf16), its ``lse`` within 1e-3 (f32 in
both, sums in another order). The backward kernel's dq, dk, dv within
the same 1e-2 + 2^-6 |g| of the plain backward on the same inputs: both
round the result to bf16; the kernel sums in another order and takes P
and dS as two bf16 parts (hi + lo, ~16 bits). At every shape, tile
edges and the main path's shapes included, each gradient's deviation
from the f32 gradient stays within 2x the largest and 1.5x the mean
deviation of the plain backward on the same bf16 inputs (the rule of
``chip_smoke.py``).

The shapes: ragged tails; T at the edges of the kernels' 64- and
128-row tiles and of the 64-row TMA boxes (1, 127, 128, 129, 255, 257)
at every head dim; many heads and a batch (the grid's y and z axes);
and the main path's t2k and t8k shapes.

Two tests capture a launch in a CUDA graph and replay it after changing
the inputs in place: they show that the wrappers launch on PyTorch's
current stream, which the capture makes a side stream.
"""
import dataclasses

import pytest
import torch

from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm
from kubernetes_tpu_torch.workloads import vector_add as va
from kubernetes_tpu_torch.workloads.ring_attention import (
    reference_attention, reference_attention_with_lse)

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 1, 32), (1, 2, 63, 32), (2, 1, 64, 64), (1, 3, 129, 128),
          (2, 2, 200, 64), (1, 1, 1000, 128)]
EDGE_SHAPES = [(1, 2, t, d) for d in (32, 64, 128)
               for t in (1, 127, 128, 129, 255, 257)] + [(8, 32, 129, 64)]
MAIN_SHAPES = [(4, 16, 2048, 128), (1, 16, 8192, 128)]
#: Vector-add lengths: around one 16-byte vector and its ragged tail,
#: the payload's 2^16 and its neighbours, and the timed 2^26.
VECTOR_ADD_NS = [1, 3, 4, 5, 1000, 65535, 65536, 65537, (1 << 20) + 3,
                 1 << 26]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_add_kernel_is_exact(gen, n, dtype):
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    y = torch.randn(n, generator=gen, device="cuda").to(dtype)
    before = va.launches
    out = va.vector_add(x, y)
    assert va.launches == before + 1
    assert torch.equal(out, x + y)


@pytest.mark.parametrize("n", VECTOR_ADD_NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_add_kernel_is_exact_at_vector_edges(gen, n, dtype):
    """Lengths around the 16-byte vectors (4 f32, 8 bf16) and their tail,
    the payload's n and one past, and the 2^26 of the timed case."""
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    y = torch.randn(n, generator=gen, device="cuda").to(dtype)
    out = va.vector_add(x, y)
    assert torch.equal(out, va.vector_add_plain(x, y))


@pytest.mark.parametrize("n", [5, 65537, (1 << 20) + 3])
@pytest.mark.parametrize("x_off,y_off", [(1, 1), (1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_add_kernel_is_exact_on_offset_views(gen, n, x_off, y_off,
                                                    dtype):
    """Contiguous views at an odd offset, which no 16-byte vector fits:
    the kernel's element path, also with x and y at different offsets."""
    xs = torch.randn(n + x_off, generator=gen, device="cuda").to(dtype)
    ys = torch.randn(n + y_off, generator=gen, device="cuda").to(dtype)
    x, y = xs[x_off:], ys[y_off:]
    assert x.data_ptr() % 16 and x.is_contiguous()
    before = va.launches
    out = va.vector_add(x, y)
    assert va.launches == before + 1
    assert torch.equal(out, va.vector_add_plain(x, y))


def test_vector_add_kernel_rejects_what_it_does_not_take(gen):
    with pytest.raises(TypeError):
        va.vector_add(torch.ones(4, device="cuda", dtype=torch.float64),
                      torch.ones(4, device="cuda", dtype=torch.float64))
    x = torch.ones(4, 4, device="cuda")
    with pytest.raises(ValueError):
        va.vector_add(x.T, x.T)
    before = va.launches
    with pytest.raises(ValueError, match="matching tensors"):
        va.vector_add(torch.ones(4, device="cuda"), torch.ones(4))
    with pytest.raises(ValueError, match="matching tensors"):
        va.vector_add(torch.ones(4, device="cuda"),
                      torch.ones(4, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="matching tensors"):
        va.vector_add(torch.ones(4, device="cuda"),
                      torch.ones(5, device="cuda"))
    assert va.vector_add(x[:0], x[:0]).shape == (0, 4)
    assert va.launches == before


def _replayed(fn, *inputs):
    """Captures ``fn(*inputs)`` in a CUDA graph, which runs the capture
    on a side stream made current, then writes new values into the
    inputs in place and replays. Returns the output the replay wrote."""
    fn(*inputs)  # first launch outside the capture: build and resolve
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*inputs)
    for x in inputs:
        x.copy_(torch.randn(x.shape, device="cuda").to(x.dtype))
    graph.replay()
    torch.cuda.synchronize()
    return out


def test_vector_add_launches_on_the_current_stream(gen):
    """A launch on any stream but the capturing one either breaks the
    capture or leaves ``out`` stale after the replay."""
    x, y = (torch.randn(4099, generator=gen, device="cuda") for _ in range(2))
    out = _replayed(va.vector_add, x, y)
    assert torch.equal(out, x + y)


def test_flash_fwd_launches_on_the_current_stream(gen):
    q, k, v = (torch.randn((1, 2, 129, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = _replayed(fa.flash_attention_fwd, q, k, v)
    o_ref, lse_ref = reference_attention_with_lse(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES + MAIN_SHAPES)
def test_flash_kernel_matches_plain(gen, shape):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert fa.launches == before + 1
    o_ref, lse_ref = reference_attention_with_lse(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_kernel_rejects_what_it_does_not_take(gen):
    q = torch.zeros((1, 1, 8, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.float(), q.float(), q.float())
    bad_d = torch.zeros((1, 1, 8, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(bad_d, bad_d, bad_d)
    t = torch.zeros((1, 8, 2, 32), device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    assert not t.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(t, t, t)


def _bwd_inputs(gen, shape):
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
def test_flash_bwd_kernel_matches_plain(gen, shape):
    q, k, v, o, lse, do = _bwd_inputs(gen, shape)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa.bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape, name
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2,
                                   rtol=2 ** -6, msg=name)


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES + MAIN_SHAPES)
def test_flash_bwd_kernel_drift_from_f32(gen, shape):
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    o32, lse32 = reference_attention_with_lse(*x32[:3])
    exact = fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3])
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        assert bool(torch.isfinite(g).all()), name
        dev, dev_plain = (g.float() - e).abs(), (p.float() - e).abs()
        if name in ("dq", "dk") and shape[2] == 1:
            # At T = 1 a softmax over one key has no score gradient: dS,
            # dq and dk are 0, and both deviations are f32 rounding of
            # the cancelling dP - delta, whose ratio says nothing. The
            # kernel is held to the 1e-2 bound it keeps against the plain
            # version.
            assert float(dev.max()) <= 1e-2, name
            continue
        assert float(dev.max()) <= 2 * float(dev_plain.max()), name
        assert float(dev.mean()) <= 1.5 * float(dev_plain.mean()), name


def test_flash_bwd_kernel_rejects_what_it_does_not_take(gen):
    q, k, v, o, lse, do = _bwd_inputs(gen, (1, 2, 8, 32))
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, o, lse, do.float())
    bad_d = torch.zeros((1, 1, 8, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(bad_d, bad_d, bad_d, bad_d,
                               torch.zeros((1, 1, 8), device="cuda"), bad_d)
    strided = torch.zeros((1, 8, 2, 32), device="cuda",
                          dtype=torch.bfloat16).transpose(1, 2)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, v, o, lse, strided)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :1], do)


def test_flash_function_grads_match_local_autograd(gen):
    """FlashAttention through autograd against autograd through the
    plain attention, with a strided dO as the LM's backward gives it."""
    shape = (2, 3, 100, 64)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    w = torch.randn((2, 100, 3, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    fwd, bwd = fa.launches, fa.bwd_launches
    out = fa.FlashAttention.apply(q, k, v)
    (out.transpose(1, 2) * w).float().sum().backward()
    assert (fa.launches, fa.bwd_launches) == (fwd + 1, bwd + 1)
    got = [x.grad.float() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    ref = reference_attention(q, k, v)
    (ref.transpose(1, 2) * w).float().sum().backward()
    for g, x in zip(got, (q, k, v)):
        torch.testing.assert_close(g, x.grad.float(), atol=2e-2, rtol=2 ** -6)


def test_lm_flash_forward_matches_local(gen):
    """Small LM on the card: the kernel path against plain attention,
    at the reference tests' bf16 bound (5e-2)."""
    cfg = lm.LMConfig(vocab=128, d_model=128, n_layers=2, n_heads=4,
                      d_ff=256, attn_impl="flash")
    params = lm.init_params(gen, cfg)
    tokens = lm.synthetic_batch(gen, cfg, 2, 97)[:, :-1]
    before = fa.launches
    got = lm.make_forward(cfg)(params, tokens)
    assert fa.launches == before + cfg.n_layers
    want = lm.make_forward(dataclasses.replace(cfg, attn_impl="local"))(
        params, tokens)
    torch.testing.assert_close(got, want, atol=5e-2, rtol=0)


def test_lm_train_step_on_the_card_matches_local(gen):
    """A small LM train step through both kernels: its launches per step
    (two forward launches per layer under remat, one backward), then
    loss and grads against the same params with plain attention. The
    loss at the reference tests' bf16 bound (5e-2); each grad within 5%
    of that leaf's largest plain grad (the two differ only in where
    attention rounds to bf16)."""
    cfg = lm.LMConfig(vocab=128, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, param_dtype=torch.bfloat16,
                      attn_impl="flash")
    local = dataclasses.replace(cfg, attn_impl="local")
    batch = lm.synthetic_batch(gen, cfg, 2, 130)
    params, opt_state = lm.init_train_state(
        torch.Generator("cuda").manual_seed(1), cfg)
    va.launches = fa.launches = fa.bwd_launches = 0
    lm.make_train_step(cfg)(params, opt_state, batch)
    torch.cuda.synchronize()
    assert (va.launches, fa.launches, fa.bwd_launches) == (
        0, 2 * cfg.n_layers, cfg.n_layers)

    loss_f, grads_f = lm.loss_and_grads(params, batch, cfg)
    loss_l, grads_l = lm.loss_and_grads(params, batch, local)
    assert abs(float(loss_f) - float(loss_l)) < 5e-2
    for g_f, g_l in zip(lm._leaves(grads_f), lm._leaves(grads_l)):
        assert g_f.dtype == g_l.dtype == torch.bfloat16
        scale = float(g_l.float().abs().max())
        assert float((g_f.float() - g_l.float()).abs().max()) \
            <= 0.05 * scale + 1e-6
