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
at every head dim (16, 32, 64, 128); many heads and a batch (the grid's
y and z axes); the trainer's default LM (B4 H2 T16 D16); and the main
path's t2k and t8k shapes.

Every instance, forward and backward, at head dims that are no tile's
width (8, 24, 25, 40, 48, 80, 96, 112, 136, 144, 200, 250, at T 1, 127,
129 and 257), at the W-256 tile's own 256, at Phi-3-mini's attention (B4
H32 T2048 D96) and at GPT-J-6B's (B4 H16 T2048 D256), under the same
tolerances and drift rule; head dim 0 raises (a head dim over 256 takes
the wide kernels, below).

The non-causal instances, which the ring (``workloads/ring_attention.py``)
runs for a block of keys before its queries, are held to the same
tolerances and the same drift rule at every head dim and T at the tile
and TMA edges (1, 100, 127, 128, 129, 1000): keys past T are masked by
the kernels, not by a causal mask, there. The loopback ring (every
rank's share of a ring of 2 and 4 in one process, through the kernels)
is held to the drift rule against f32 attention of the whole sequence,
with its launch counts. The f32-output instances, which the ring runs so
that it rounds each sum once, give the bf16 instances' outputs bit for
bit once rounded.

The MoE forward at ``MoEConfig()`` and at the ``dryrun_multichip``
MoE config (head dim 16) passes the layer-wise gate of
``perf/gates.py`` against the plain paths on the CPU, and one
full-width MoE train step fits the card.

One test, which skips with fewer than two cards, launches the kernels
on tensors of device 1 while device 0 is current: each launches on its
tensors' device.
Another, which also skips with fewer than two cards, runs the fsdp
gather and the tp pair (``workloads/collectives.py``) on two cards over
NCCL against two gloo ranks on the CPU.

Two tests capture a launch in a CUDA graph and replay it after changing
the inputs in place: they show that the wrappers launch on PyTorch's
current stream, which the capture makes a side stream.

The f32 instances (f32 q, k, v, o, dO; head dims up to 128), forward and
backward, causal and not, at every tile width and at head dims between
(24, 48, 96; 100 through the padded copy), T at the tile edges and 2048:
each output's largest deviation from a float64 plain version at most
``gates.F32_RULE`` (1/256; 1/16 for the former 16-bit route) of the bf16
instance's (f32 out) on the bf16 rounding of the same inputs; f16, f64
and mixed dtypes raise ``TypeError``. The f32 LM (params and compute)
through the ring at sp = 1 and through "flash" within 1e-4 of plain f32
attention on logits and loss, counted on the f32 instances. The MoE at
its full width in f32, 3 train steps through the kernels, within
``gates.f32_steps_rule`` and 1e-4 of plain f32 at every step.

The wide kernels (head dims over one tile: bf16 over 256, f32 over 128):
every bf16 instance at head dims 264, 272, 384 and 512 under the one-tile
kernels' tolerances and drift rule, and the f32 instances at 136, 200
and 256 under ``gates.F32_RULE``, each counted on the wide instances.
"""
import dataclasses

import pytest
import torch

from kubernetes_tpu_torch.perf import gates
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm
from kubernetes_tpu_torch.workloads import ring_attention as ra
from kubernetes_tpu_torch.workloads import vector_add as va
from kubernetes_tpu_torch.workloads.ring_attention import (
    reference_attention, reference_attention_with_lse)

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 1, 32), (1, 2, 63, 32), (2, 1, 64, 64), (1, 3, 129, 128),
          (2, 2, 200, 64), (1, 1, 1000, 128), (4, 2, 16, 16),
          (2, 4, 1000, 16)]
EDGE_SHAPES = [(1, 2, t, d) for d in (16, 32, 64, 128)
               for t in (1, 127, 128, 129, 255, 257)] + [(8, 32, 129, 64),
                                                         (8, 32, 129, 16)]
MAIN_SHAPES = [(4, 16, 2048, 128), (1, 16, 8192, 128)]
#: The non-causal instances: T at the tile and TMA edges at every head
#: dim, many heads and a batch, and the 600M LM's t8k blocks at sp 2
#: and 4.
NON_CAUSAL_SHAPES = ([(1, 2, t, d) for d in (16, 32, 64, 128)
                      for t in (1, 100, 127, 128, 129, 1000)]
                     + [(8, 32, 129, 64), (1, 16, 2048, 128),
                        (1, 16, 4096, 128)])
#: Head dims that are no tile's width, each run by the smallest tile
#: that holds it (25 and 250 through a zero-padded copy), and the W-256
#: tile's 256, at T over the tile and TMA edges; then Phi-3-mini's
#: attention (32 heads of 96) and GPT-J-6B's (16 heads of 256) at B4
#: T2048.
ODD_HEAD_DIM_SHAPES = ([(1, 2, t, d)
                        for d in (8, 24, 25, 40, 48, 80, 96, 112, 136, 144,
                                  200, 250, 256)
                        for t in (1, 127, 129, 257)]
                       + [(4, 32, 2048, 96), (4, 16, 2048, 256)])
#: Vector-add lengths: around one 16-byte vector and its ragged tail,
#: the payload's 2^16 and its neighbours, and the timed 2^26.
VECTOR_ADD_NS = [1, 3, 4, 5, 1000, 65535, 65536, 65537, (1 << 20) + 3,
                 1 << 26]


def _launched() -> tuple:
    """All forward and all backward attention launches so far, over
    every kernel instance."""
    c = fa.counts()
    return tuple(sum(n for name, n in c.items()
                     if name.startswith(f"flash_attn_{d}"))
                 for d in ("fwd", "bwd"))


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


def test_kernels_launch_on_their_tensors_device(gen):
    """With device 0 current, K1, the flash forward and its backward on
    tensors of device 1 launch on device 1 (a launch on device 0 would
    fault on device 1's memory or leave the outputs unwritten), agree
    with their plain versions, and leave device 0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    g1 = torch.Generator(device=dev).manual_seed(0)
    x, y = (torch.randn(100_003, generator=g1, device=dev) for _ in range(2))
    out = va.vector_add(x, y)
    q, k, v, do = (torch.randn((1, 2, 257, 64), generator=g1, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert out.device == dev and torch.equal(out, x + y)
    o_ref, lse_ref = reference_attention_with_lse(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.device == dev, name
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2,
                                   rtol=2 ** -6, msg=name)


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES + MAIN_SHAPES)
def test_flash_kernel_matches_plain(gen, shape):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = _launched()[0]
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert _launched()[0] == before + 1
    o_ref, lse_ref = reference_attention_with_lse(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_kernel_rejects_what_it_does_not_take(gen):
    q = torch.zeros((1, 1, 8, 32), device="cuda", dtype=torch.bfloat16)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            fa.flash_attention_fwd(q.to(dtype), q.to(dtype), q.to(dtype))
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.float(), q, q)
    # Head dim 264 took a ValueError before the wide kernels; now only
    # head dim 0 raises.
    bad_d = torch.zeros((1, 1, 8, 0), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims from 1, not 0"):
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
    before = _launched()[1]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert _launched()[1] == before + 1
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
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            fa.flash_attention_bwd(*(x.to(dtype) for x in (q, k, v, o)), lse,
                                   do.to(dtype))
    bad_d = torch.zeros((1, 1, 8, 0), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims from 1, not 0"):
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
    fwd, bwd = _launched()
    out = fa.FlashAttention.apply(q, k, v)
    (out.transpose(1, 2) * w).float().sum().backward()
    assert _launched() == (fwd + 1, bwd + 1)
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
    before = _launched()[0]
    got = lm.make_forward(cfg)(params, tokens)
    assert _launched()[0] == before + cfg.n_layers
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
    va.launches = 0
    fa.zero_counts()
    lm.make_train_step(cfg)(params, opt_state, batch)
    torch.cuda.synchronize()
    assert (va.launches, *_launched()) == (
        0, 2 * cfg.n_layers, cfg.n_layers)

    loss_f, grads_f = lm.loss_and_grads(params, batch, cfg)
    loss_l, grads_l = lm.loss_and_grads(params, batch, local)
    assert abs(float(loss_f) - float(loss_l)) < 5e-2
    for g_f, g_l in zip(lm._leaves(grads_f), lm._leaves(grads_l)):
        assert g_f.dtype == g_l.dtype == torch.bfloat16
        scale = float(g_l.float().abs().max())
        assert float((g_f.float() - g_l.float()).abs().max()) \
            <= 0.05 * scale + 1e-6


@pytest.mark.parametrize("shape", NON_CAUSAL_SHAPES)
def test_flash_kernel_non_causal_matches_plain(gen, shape):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = _launched()[0]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    assert _launched()[0] == before + 1
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, causal=False)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape", NON_CAUSAL_SHAPES)
def test_flash_bwd_kernel_non_causal_drift_from_f32(gen, shape):
    """Against the plain non-causal backward on the same inputs (1e-2 +
    2^-6 |g|), and each gradient's deviation from the f32 gradient within
    2x the largest and 1.5x the mean deviation of the plain one's."""
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    before = _launched()[1]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert _launched()[1] == before + 1
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    o32, lse32 = reference_attention_with_lse(*x32[:3], causal=False)
    exact = fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3],
                                         causal=False)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), p.float(), atol=1e-2,
                                   rtol=2 ** -6, msg=name)
        dev, dev_plain = (g.float() - e).abs(), (p.float() - e).abs()
        if name in ("dq", "dk") and shape[2] == 1:
            assert float(dev.max()) <= 1e-2, name  # as in the causal test
            continue
        assert float(dev.max()) <= 2 * float(dev_plain.max()), name
        assert float(dev.mean()) <= 1.5 * float(dev_plain.mean()), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, t, d) for d in (16, 32, 64, 128)
                                   for t in (1, 100, 129, 1000)]
                         + [(8, 32, 129, 64)])
def test_flash_kernels_f32_output_is_the_unrounded_output(gen, shape, causal):
    """The f32-output instances (the ring's): the same arithmetic as the
    bf16 ones, not rounded at the end, so rounding their output gives the
    bf16 instance's bit for bit, forward and backward."""
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o32, lse32 = fa.flash_attention_fwd(q, k, v, causal, torch.float32)
    assert o32.dtype == torch.float32 and torch.equal(lse32, lse)
    assert torch.equal(o32.to(torch.bfloat16), o)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    grads32 = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                     torch.float32)
    for name, g, g32 in zip(("dq", "dk", "dv"), grads, grads32):
        assert g32.dtype == torch.float32, name
        assert torch.equal(g32.to(torch.bfloat16), g), name


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ODD_HEAD_DIM_SHAPES)
def test_flash_kernels_at_any_head_dim(gen, shape, causal, out_dtype):
    """Every instance (causal or not, bf16 or f32 out) at a head dim that
    is no tile's width, counted: the forward within 1e-2 + 2^-6 |o| and
    1e-3 on lse of the plain version, each gradient's deviation from the
    f32 gradient within 2x the largest and 1.5x the mean deviation of the
    plain backward's; at T = 1, dq and dk (0 in exact arithmetic) within
    1e-2. Columns past D are never written: the outputs are [B, H, T,
    D]."""
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    before = fa.counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out_dtype)
    got = fa.flash_attention_bwd(q, k, v, o.to(q.dtype), lse, do, causal,
                                 out_dtype)
    suffix = "" if causal else "_non_causal"
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd{suffix}": 1,
        f"flash_attn_bwd{suffix}": 1}
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, causal, out_dtype)
    assert o.shape == shape and o.dtype == out_dtype
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    o = o.to(q.dtype)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         out_dtype)
    o32, lse32 = reference_attention_with_lse(*x32[:3], causal)
    exact = fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3],
                                         causal)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        assert g.shape == shape and g.dtype == out_dtype, name
        assert bool(torch.isfinite(g).all()), name
        dev, dev_plain = (g.float() - e).abs(), (p.float() - e).abs()
        if name in ("dq", "dk") and shape[2] == 1:
            assert float(dev.max()) <= 1e-2, name  # as in the causal test
            continue
        assert float(dev.max()) <= 2 * float(dev_plain.max()), name
        assert float(dev.mean()) <= 1.5 * float(dev_plain.mean()), name


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_loopback_on_the_card_matches_f32(gen, sp):
    """Every rank's share of a ring of ``sp`` at B1 H4 T1024 D64, in one
    process through the kernels: sp(sp+1)/2 launches each way; o, dq, dk
    and dv no further from f32 attention of the whole sequence than the
    plain bf16 path (2x its largest, 1.5x its mean deviation); lse within
    1e-3 of the plain path's."""
    shape = (1, 4, 1024, 64)
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    blocks = [list(x.chunk(sp, dim=2)) for x in (q, k, v, do)]
    blocks = [[b.contiguous() for b in bl] for bl in blocks]
    fwd, bwd = _launched()
    out = ra.loopback_forward(*blocks[:3])
    grads = ra.loopback_backward(*blocks[:3], [o for o, _ in out],
                                 [lse for _, lse in out], blocks[3])
    torch.cuda.synchronize()
    assert (_launched()[0] - fwd, _launched()[1] - bwd) == (
        sp * (sp + 1) // 2, sp * (sp + 1) // 2)
    got = {"o": torch.cat([o for o, _ in out], dim=2),
           **{n: torch.cat([g[i] for g in grads], dim=2)
              for i, n in enumerate(("dq", "dk", "dv"))}}
    lse = torch.cat([lse for _, lse in out], dim=2)
    o_p, lse_p = reference_attention_with_lse(q, k, v)
    plain = {"o": o_p, **dict(zip(("dq", "dk", "dv"),
                                  fa.flash_attention_bwd_plain(
                                      q, k, v, o_p, lse_p, do)))}
    o32, lse32 = reference_attention_with_lse(*x32[:3])
    exact = {"o": o32, **dict(zip(("dq", "dk", "dv"),
                                  fa.flash_attention_bwd_plain(
                                      *x32[:3], o32, lse32, x32[3])))}
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)
    for name in ("o", "dq", "dk", "dv"):
        g = got[name]
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        dev = (g.float() - exact[name].float()).abs()
        dev_plain = (plain[name].float() - exact[name].float()).abs()
        assert float(dev.max()) <= 2 * float(dev_plain.max()), name
        assert float(dev.mean()) <= 1.5 * float(dev_plain.mean()), name


def test_one_member_ring_on_the_card_is_the_flash_path(gen):
    """Without a mesh, ``ring_attention`` through autograd is one causal
    launch each way, equal to ``FlashAttention`` bit for bit."""
    shape = (2, 3, 200, 64)
    x = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
         for _ in range(4)]
    leaves = [t.clone().requires_grad_() for t in x[:3]]
    fwd, bwd = _launched()
    o = ra.ring_attention(*leaves, None)
    o.backward(x[3])
    assert (_launched()[0] - fwd, _launched()[1] - bwd) == (1, 1)
    ref = [t.clone().requires_grad_() for t in x[:3]]
    o_ref = fa.FlashAttention.apply(*ref)
    o_ref.backward(x[3])
    assert torch.equal(o, o_ref)
    for a, b in zip(leaves, ref):
        assert torch.equal(a.grad, b.grad)


# -- The MoE (workloads/moe.py) on the card. --

#: The reference's ``MoEConfig()`` (4 heads of 32) and the MoE config of
#: its ``dryrun_multichip`` at ep 2 (``__graft_entry__.py:69``: 2 heads
#: of 16, 4 experts), each at B4 T512: enough tokens that the layer
#: gate's 1% bound on routing flips is not one token's worth.
MOE_CONFIGS = {"default": {},
               "dryrun_multichip": dict(vocab=64, d_model=32, n_layers=1,
                                        n_heads=2, d_ff=64, n_experts=4,
                                        top_k=2)}


@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_moe_forward_on_the_card_passes_the_layer_gate(gen, name):
    """The MoE forward through the flash kernels, one causal launch a
    layer, held layer by layer (``perf/gates.moe_layer_gate``) against
    the plain bf16 and f32 paths on the CPU; its loss within 1e-2 of the
    CPU's plain forward, relative."""
    from kubernetes_tpu_torch.perf import gates
    from kubernetes_tpu_torch.workloads import moe
    cfg = moe.MoEConfig(**MOE_CONFIGS[name])
    params = moe.init_params(gen, cfg)
    batch = moe.synthetic_batch(gen, cfg, 4, 512)
    cpu = lm._tree_map(lambda p: p.cpu(), params)
    before = _launched()[0]
    logits, _ = moe.make_forward(cfg)(params, batch[:, :-1])
    assert _launched()[0] == before + cfg.n_layers
    assert logits.shape == (4, 512, cfg.vocab)
    for row in gates.moe_layer_gate(params, batch[:, :-1], cfg,
                                    plain_params=cpu):
        assert row["ok"], row
    with torch.inference_mode():
        loss = float(moe.loss_fn(params, batch, cfg))
        plain = float(moe.loss_fn(cpu, batch.cpu(), cfg))
    assert abs(loss - plain) <= 1e-2 * abs(plain)


def test_moe_full_width_step_fits_the_card(gen):
    """One train step of the 600M-wide MoE (8 layers, 4 experts, top-2,
    f32 params and AdamW state, bf16 compute) at B4 T2048: two forward
    and one backward launch a layer under remat, a finite loss, and a
    peak of allocated memory within 90% of the card's."""
    from kubernetes_tpu_torch.perf import chip_bench
    from kubernetes_tpu_torch.workloads import moe
    cfg = moe.MoEConfig(n_layers=8, **chip_bench.MOE_WIDTHS)
    params, opt_state = moe.init_train_state(gen, cfg)
    batch = moe.synthetic_batch(gen, cfg, *chip_bench.MOE_BATCH)
    step = moe.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd, bwd = _launched()
    params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize()
    assert (_launched()[0] - fwd, _launched()[1] - bwd) == (
        2 * cfg.n_layers, cfg.n_layers)
    assert torch.isfinite(loss)
    total = torch.cuda.get_device_properties(0).total_memory
    assert torch.cuda.max_memory_allocated() <= 0.9 * total


#: One rank of a two-rank group, NCCL on its card or gloo on the CPU: the
#: fsdp gather along dim 1 and the tp pair, forward and backward, its
#: outputs and gradients saved to OUT<rank>.pt on the host.
_COLLECTIVES_RANK = r"""
import os, torch
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import collectives, rendezvous
rank, cuda = int(os.environ["RANK"]), os.environ["DEV"] == "cuda"
dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
if cuda:
    torch.cuda.set_device(rank)
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]), rank, 2,
                              "nccl" if cuda else "gloo", 120.0, "127.0.0.1")
g = torch.Generator().manual_seed(rank)
w = torch.randn((4, 6), generator=g).to(dev).requires_grad_()
x = torch.randn((3, 8), generator=g).to(dev).requires_grad_()
c = torch.randn((3, 12), generator=torch.Generator().manual_seed(9)).to(dev)
group = dist.group.WORLD
whole = collectives.gather(w, group, 1)
part = collectives.enter_tp(x, group)[:, 4 * rank:4 * rank + 4] @ whole
out = collectives.leave_tp(part, group)
(out * c).sum().backward()
torch.save({"whole": whole.detach().cpu(), "out": out.detach().cpu(),
            "w_grad": w.grad.cpu(), "x_grad": x.grad.cpu()},
           os.environ["OUT"] + f"{rank}.pt")
dist.destroy_process_group()
"""


def test_fsdp_gather_and_tp_pair_over_nccl_match_gloo(tmp_path):
    """The fsdp gather (all-gather along dim 1, reduce-scatter of the
    gradient) and the tp pair ("enter": gradient all-reduced; "leave":
    f32 all-reduce) on two cards over NCCL give what two gloo ranks on
    the CPU give from the same inputs: the gathered weight and the
    output exactly, the gradients within 1e-6 (f32 sums of two terms)."""
    import os
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = {}
    for backend in ("cuda", "cpu"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = str(tmp_path / f"{backend}-")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _COLLECTIVES_RANK], cwd=root,
            env={**os.environ, "PYTHONPATH": root, "RANK": str(r),
                 "DEV": backend, "PORT": str(port), "OUT": out},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            for proc in procs:
                log, _ = proc.communicate(timeout=300)
                assert proc.returncode == 0, log
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        results[backend] = [torch.load(f"{out}{r}.pt") for r in range(2)]
    for rank, (got, want) in enumerate(zip(results["cuda"],
                                           results["cpu"])):
        assert torch.equal(got["whole"], want["whole"]), rank
        torch.testing.assert_close(got["out"], want["out"], atol=1e-6,
                                   rtol=1e-6)
        for key in ("w_grad", "x_grad"):
            torch.testing.assert_close(got[key], want[key], atol=1e-6,
                                       rtol=1e-6, msg=f"{key} rank {rank}")


# -- The f32 instances. --

#: f32 shapes: every tile width and head dims between (100 through the
#: padded copy), T at the tile and TMA edges, a batch of heads, and the
#: 600M LM's t2k attention.
F32_SHAPES = ([(1, 2, t, d) for d in (16, 24, 32, 48, 64, 96, 100, 128)
               for t in (1, 127, 129, 257)]
              + [(2, 4, 1000, 64), (1, 2, 2048, 128), (4, 16, 2048, 128)])


def _run(q, k, v, do, causal, out_dtype=None):
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out_dtype)
    grads = fa.flash_attention_bwd(q, k, v, o.to(q.dtype), lse, do, causal,
                                   out_dtype)
    return {"o": o, "lse": lse, **dict(zip(("dq", "dk", "dv"), grads))}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", F32_SHAPES)
def test_f32_kernels_within_a_sixteenth_of_bf16(gen, shape, causal):
    """The f32 instances, counted, outputs f32 of the input's shape, each
    output's deviation from float64 at most ``gates.F32_RULE`` (1/256
    since the 22-bit route; 1/16 before) of the bf16 instance's on the
    bf16 rounding of the same inputs; at T = 1, where dq and dk are 0 in
    exact arithmetic, those two within 1e-5."""
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    before = fa.counts()
    got = _run(*x32, causal)
    suffix = "" if causal else "_non_causal"
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd_f32{suffix}": 1,
        f"flash_attn_bwd_f32{suffix}": 1}
    bf16 = _run(*(x.to(torch.bfloat16) for x in x32), causal, torch.float32)
    for name, want in gates.plain64(*x32, causal).items():
        g = got[name]
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        assert bool(torch.isfinite(g).all()), name
        dev = float((g.double() - want).abs().max())
        if shape[2] == 1 and name in ("dq", "dk"):
            assert dev <= 1e-5, name
            continue
        ref = float((bf16[name].double() - want).abs().max())
        assert dev <= gates.F32_RULE * ref, (name, dev, ref)


def test_f32_kernels_refuse_a_head_dim_over_128(gen):
    """f32 over head dim 128 raised ``ValueError`` before the wide
    kernels; now it launches them, counted on the wide f32 instances,
    and what the kernels still refuse is another dtype: f64, f16 and
    mixed dtypes raise ``TypeError`` at that head dim, counting
    nothing."""
    wide = torch.zeros((1, 2, 8, 136), device="cuda")
    before = fa.counts()
    o, lse = fa.flash_attention_fwd(wide, wide, wide)
    fa.flash_attention_bwd(wide, wide, wide, o, lse, wide)
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), "flash_attn_fwd_wide_f32": 1,
        "flash_attn_bwd_wide_f32": 1}
    before = fa.counts()
    for args in ((wide.double(),) * 3, (wide.half(),) * 3,
                 (wide, wide.bfloat16(), wide.bfloat16())):
        with pytest.raises(TypeError):
            fa.flash_attention_fwd(*args)
    assert fa.counts() == before


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_lm_f32_through_the_kernels_matches_local(gen, attn):
    """The LM in f32 (params and compute, head dim 64) through the f32
    instances, counted, against plain f32 attention: logits and loss
    within 1e-4."""
    cfg = lm.LMConfig(vocab=128, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, param_dtype=torch.float32,
                      compute_dtype=torch.float32, attn_impl=attn)
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               2, 257)
    local = dataclasses.replace(cfg, attn_impl="local")
    before = fa.counts()["flash_attn_fwd_f32"]
    logits = lm.make_forward(cfg)(params, batch[:, :-1])
    assert fa.counts()["flash_attn_fwd_f32"] == before + cfg.n_layers
    want = lm.make_forward(local)(params, batch[:, :-1])
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=0)
    loss, _ = lm.loss_and_grads(params, batch, cfg)
    want_loss, _ = lm.loss_and_grads(params, batch, local)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))


# -- The wide kernels: head dims over one tile (bf16 over 256, f32 over
#    128). --

#: bf16 head dims over 256 (264, 272: the dryrun at 17 devices, 384, 512)
#: at T over the tile and TMA edges.
WIDE_SHAPES = [(1, 2, t, d) for d in (264, 272, 384, 512)
               for t in (1, 127, 129, 257)]
#: f32 head dims over 128 (136, 200, 256: GPT-J-6B's), at T over the
#: tiles and at 1000, and GPT-J-6B's attention shape.
WIDE_F32_SHAPES = ([(1, 2, t, d) for d in (136, 200, 256)
                    for t in (127, 129, 1000)] + [(4, 16, 2048, 256)])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_kernels_match_plain(gen, shape, causal, out_dtype):
    """The wide bf16 instances (causal or not, bf16 or f32 out), counted
    on the wide instances alone, under the rules of the one-tile
    kernels: the forward within 1e-2 + 2^-6 |o| and 1e-3 on lse of the
    plain version, each gradient's deviation from the f32 gradient
    within 2x the largest and 1.5x the mean of the plain backward's; at
    T = 1 dq and dk within 1e-2."""
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    before = fa.counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out_dtype)
    got = fa.flash_attention_bwd(q, k, v, o.to(q.dtype), lse, do, causal,
                                 out_dtype)
    suffix = "" if causal else "_non_causal"
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd_wide{suffix}": 1,
        f"flash_attn_bwd_wide{suffix}": 1}
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, causal, out_dtype)
    assert o.shape == shape and o.dtype == out_dtype
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    o = o.to(q.dtype)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         out_dtype)
    o32, lse32 = reference_attention_with_lse(*x32[:3], causal)
    exact = fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3],
                                         causal)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        assert g.shape == shape and g.dtype == out_dtype, name
        assert bool(torch.isfinite(g).all()), name
        dev, dev_plain = (g.float() - e).abs(), (p.float() - e).abs()
        if name in ("dq", "dk") and shape[2] == 1:
            assert float(dev.max()) <= 1e-2, name
            continue
        assert float(dev.max()) <= 2 * float(dev_plain.max()), name
        assert float(dev.mean()) <= 1.5 * float(dev_plain.mean()), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", WIDE_F32_SHAPES)
def test_wide_f32_kernels_within_f32_rule(gen, shape, causal):
    """The wide f32 instances, counted, outputs f32 of the input's
    shape, each output's deviation from float64 at most
    ``gates.F32_RULE`` of the bf16 instance's (f32 out) on the bf16
    rounding of the same inputs."""
    x32 = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
    before = fa.counts()
    got = _run(*x32, causal)
    suffix = "" if causal else "_non_causal"
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd_wide_f32{suffix}": 1,
        f"flash_attn_bwd_wide_f32{suffix}": 1}
    bf16 = _run(*(x.to(torch.bfloat16) for x in x32), causal, torch.float32)
    rule = gates.f32_rule(got, bf16, gates.plain64(*x32, causal))
    assert rule["ok"], rule
    for name, g in got.items():
        assert g.dtype == torch.float32 and g.shape[:3] == shape[:3], name


def test_moe_f32_steps_at_full_width_within_the_step_rule(gen):
    """The MoE at ``chip_bench.MOE_WIDTHS`` (head dim 128) in f32 at
    B4 T2048, 3 train steps through the kernels' f32 instances, counted,
    against the same steps with plain f32 and f64 attention: within
    ``gates.f32_steps_rule`` and within 1e-4 of plain f32 at every
    step (the 16-bit route drifted 4.97e-3 by step 3)."""
    from kubernetes_tpu_torch.perf import chip_bench, moe_f32_routing
    from kubernetes_tpu_torch.workloads import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe.MoEConfig(n_layers=8, **chip_bench.MOE_WIDTHS,
                        compute_dtype=torch.float32)
    fa.zero_counts()
    out = moe_f32_routing.readings(cfg, *chip_bench.MOE_BATCH, 3,
                                   routing=False)
    rule = out["steps_rule"]["kernels"]
    assert rule["ok"], rule
    assert max(rule["kernels_vs_plain"]) <= 1e-4, rule
    assert fa.counts()["flash_attn_bwd_f32"] >= 3 * cfg.n_layers
