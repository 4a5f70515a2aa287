"""The port's checkpoint/restore and elastic train loop, on the CPU.

The semantics of ``tests/workloads/test_checkpoint.py`` held for
``kubernetes_tpu_torch.workloads.checkpoint`` and ``lm.train``, and the
on-disk contracts shared with the reference: the job-keyed directory,
the preemption request, and the checkpoint-complete marker, which the
reference's JAX-free ``kubernetes_tpu.preemption`` readers must read.
"""
import os

import pytest
import torch

from kubernetes_tpu import preemption as jax_preemption
from kubernetes_tpu.workloads import checkpoint as jax_ckpt
from kubernetes_tpu_torch import preemption as torch_preemption
from kubernetes_tpu_torch.workloads import checkpoint as ckpt
from kubernetes_tpu_torch.workloads import lm


def small_cfg(**kw):
    return lm.LMConfig(vocab=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                       attn_impl="flash", **kw)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _equal_trees(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_save_restore_round_trip(tmp_path, param_dtype):
    cfg = small_cfg(param_dtype=param_dtype)
    params, opt_state = lm.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator().manual_seed(1), cfg, 4, 16,
                               device="cpu")
    params, opt_state, _ = lm.make_train_step(cfg, device="cpu")(
        params, opt_state, batch)
    d = str(tmp_path / "job-a")
    ckpt.save(3, {"params": params, "opt_state": opt_state}, d)
    assert ckpt.latest_step(d) == 3
    like = dict(zip(("params", "opt_state"), lm.init_train_state(
        torch.Generator().manual_seed(9), cfg)))
    restored = ckpt.restore(d, like)
    _equal_trees(restored, {"params": params, "opt_state": opt_state})
    # A skeleton template restores the same state.
    _equal_trees(ckpt.restore(d, ckpt.as_template(like)), restored)


def test_restore_lands_on_the_template_device(tmp_path):
    d = str(tmp_path / "job-dev")
    ckpt.save(0, {"x": torch.arange(4.0)}, d)
    like = {"x": ckpt.TensorSpec((4,), torch.float32, torch.device("meta"))}
    got = ckpt.restore(d, like)
    assert got["x"].device.type == "meta" and got["x"].shape == (4,)


def test_restore_refuses_another_layout(tmp_path):
    d = str(tmp_path / "job-x")
    ckpt.save(0, {"x": torch.zeros(4)}, d)
    for like in ({"x": torch.zeros(5)}, {"x": torch.zeros(4, dtype=torch.int32)},
                 {"y": torch.zeros(4)}):
        with pytest.raises(ValueError):
            ckpt.restore(d, like)


def test_resume_or_init_idiom(tmp_path):
    cfg = small_cfg()
    d = str(tmp_path / "job-b")

    def init():
        return {"params": lm.init_params(torch.Generator().manual_seed(0),
                                         cfg)}

    state, start = ckpt.resume_or_init(d, init)
    assert start == 0  # fresh job
    state["marker"] = torch.tensor(42.0)
    ckpt.save(7, state, d)

    def init2():
        fresh = init()
        fresh["marker"] = torch.tensor(0.0)
        return fresh

    state2, start2 = ckpt.resume_or_init(d, init2)
    assert start2 == 8
    assert float(state2["marker"]) == 42.0
    state3, start3 = ckpt.resume_or_init(
        d, init2, template_fn=lambda: ckpt.as_template(init2()))
    assert start3 == 8 and float(state3["marker"]) == 42.0


def test_max_to_keep_prunes(tmp_path):
    d = str(tmp_path / "job-c")
    for s in range(5):
        ckpt.save(s, {"x": torch.arange(4.0) + s}, d, max_to_keep=2)
    assert ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["3", "4"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"x": torch.zeros(4)}, step=0)
    assert float(ckpt.restore(d, {"x": torch.zeros(4)}, step=3)["x"][0]) == 3


def test_restore_missing_dir_raises(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(missing, {"x": torch.zeros(1)})
    assert not os.path.exists(missing)
    assert ckpt.latest_step(missing) is None
    assert not os.path.exists(missing)


def test_a_save_cut_short_leaves_the_previous_step(tmp_path):
    """A process killed mid-save leaves a temporary directory, which no
    reader takes for a step."""
    d = tmp_path / "job-d"
    ckpt.save(1, {"x": torch.ones(2)}, str(d))
    torn = d / ".tmp-2-999"
    torn.mkdir()
    (torn / ckpt.STATE_FILE).write_bytes(b"torn")
    (d / "2").mkdir()  # a step directory without its state file
    assert ckpt.latest_step(str(d)) == 1
    assert torch.equal(ckpt.restore(str(d), {"x": torch.zeros(2)})["x"],
                       torch.ones(2))


def test_lm_train_resumes(tmp_path):
    cfg = small_cfg()
    d = str(tmp_path / "lm-job")
    first = lm.train(cfg, steps=4, batch=2, seq=16, ckpt_dir=d,
                     checkpoint_every=2, device="cpu")
    assert first["resumed_from"] == 0 and first["final_step"] == 4
    second = lm.train(cfg, steps=6, batch=2, seq=16, ckpt_dir=d,
                      checkpoint_every=2, device="cpu")
    assert second["resumed_from"] == 4  # saved at step 3 -> resume at 4
    assert second["final_step"] == 6
    assert second["preempted"] is False


def test_resumed_run_reaches_the_unbroken_runs_loss(tmp_path):
    """Batches depend only on (seed, step) and the restored state is the
    saved one bit for bit, so 4 steps + a resume to 6 end where 6 steps
    straight do."""
    cfg = small_cfg(param_dtype=torch.bfloat16)
    straight = lm.train(cfg, steps=6, batch=2, seq=16,
                        ckpt_dir=str(tmp_path / "straight"),
                        checkpoint_every=0, device="cpu")
    d = str(tmp_path / "broken")
    lm.train(cfg, steps=4, batch=2, seq=16, ckpt_dir=d, checkpoint_every=2,
             device="cpu")
    resumed = lm.train(cfg, steps=6, batch=2, seq=16, ckpt_dir=d,
                       checkpoint_every=2, device="cpu")
    assert resumed["resumed_from"] == 4
    assert resumed["loss"] == straight["loss"]


def test_preemption_saves_and_publishes_the_marker(tmp_path, monkeypatch):
    cfg = small_cfg()
    d = str(tmp_path / "pre-job")
    monkeypatch.setenv("KTPU_PREEMPT", "1")
    out = lm.train(cfg, steps=5, batch=2, seq=16, ckpt_dir=d,
                   checkpoint_every=0, device="cpu")
    assert out == {"final_step": 1, "resumed_from": 0,
                   "loss": out["loss"], "preempted": True}
    # The reference's JAX-free reader sees the port's marker.
    assert jax_preemption.read_marker(d) == 0
    assert ckpt.latest_step(d) == 0
    monkeypatch.delenv("KTPU_PREEMPT")
    again = lm.train(cfg, steps=3, batch=2, seq=16, ckpt_dir=d,
                     checkpoint_every=0, device="cpu")
    assert again["resumed_from"] == 1 and again["final_step"] == 3
    # The new incarnation cleared the old round's marker at start.
    assert ckpt.read_marker(d) is None


def test_periodic_saves_publish_markers_when_asked(tmp_path):
    cfg = small_cfg()
    d = str(tmp_path / "pub-job")
    steps_seen = []
    lm.train(cfg, steps=4, batch=2, seq=16, ckpt_dir=d, checkpoint_every=2,
             publish_marker=True, step_callback=steps_seen.append,
             device="cpu")
    assert steps_seen == [0, 1, 2, 3]
    assert jax_preemption.read_marker(d) == 3
    info = jax_preemption.read_marker_info(d)
    assert info == torch_preemption.read_marker_info(d) and info[1] > 0


def test_markers_cross_between_port_and_reference(tmp_path):
    d = str(tmp_path / "m")
    ckpt.write_marker(d, 12)
    assert jax_preemption.read_marker(d) == torch_preemption.read_marker(d) \
        == 12
    jax_ckpt.write_marker(d, 13)
    assert ckpt.read_marker(d) == 13
    ckpt.clear_marker(d)
    assert jax_preemption.read_marker(d) is None
    assert not [n for n in os.listdir(d) if ".tmp" in n]
    assert torch_preemption.MARKER_NAME == jax_preemption.MARKER_NAME
    assert torch_preemption.marker_path(d) == jax_preemption.marker_path(d)


@pytest.mark.parametrize("text", ['{"step": -1}', '{"step": "3"}', "{torn",
                                  '{"step": 4}'])
def test_marker_readers_agree_on_odd_files(tmp_path, text):
    d = tmp_path / "odd"
    d.mkdir()
    (d / torch_preemption.MARKER_NAME).write_text(text)
    assert torch_preemption.read_marker_info(str(d)) \
        == jax_preemption.read_marker_info(str(d))


@pytest.mark.parametrize("env", [
    {}, {"KTPU_JOB_NAME": "gang-a"}, {"POD_NAME": "pod-b"},
    {"KTPU_JOB_NAME": "gang-a", "POD_NAME": "pod-b",
     "KTPU_CHECKPOINT_DIR": "/ckpt"}])
def test_checkpoint_dir_matches_reference(monkeypatch, env):
    for key in ("KTPU_JOB_NAME", "POD_NAME", "KTPU_CHECKPOINT_DIR"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    assert ckpt.checkpoint_dir() == jax_ckpt.checkpoint_dir()
    assert ckpt.checkpoint_dir("/b", "j") == jax_ckpt.checkpoint_dir("/b", "j")
    assert torch_preemption.job_checkpoint_dir("j") \
        == jax_preemption.job_checkpoint_dir("j")


def test_preempt_requested_matches_reference(monkeypatch, tmp_path):
    monkeypatch.delenv("KTPU_PREEMPT", raising=False)
    flag = tmp_path / "preempt"
    monkeypatch.setenv("KTPU_PREEMPT_FILE", str(flag))
    assert ckpt.preempt_requested() is jax_ckpt.preempt_requested() is False
    flag.write_text("")
    assert ckpt.preempt_requested() is jax_ckpt.preempt_requested() is True
    monkeypatch.delenv("KTPU_PREEMPT_FILE")
    monkeypatch.setenv("KTPU_PREEMPT", "1")
    assert ckpt.preempt_requested() is jax_ckpt.preempt_requested() is True
