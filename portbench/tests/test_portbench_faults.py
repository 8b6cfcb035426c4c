"""Each cell's run, the look for a chip skipped and the rest driven on the
CPU at a tiny size, with its timed path broken underneath: ``correct``
has to come out false for every fault the cell can have (a step that
leaves its state unchanged; half of the batch left out, the mean taken
over the rest). One card, so no exchange between chips to leave out; the
training cell produces no answers to alter. The port computes in float32
here, so only the fault separates it from the reference."""
import pytest
import torch

from conftest import run_tiny


def _half(t):
    return t[: t.shape[0] // 2]


@pytest.fixture
def port():
    import human_pose_estimation_tpu_torch.data.pipeline as pipeline
    import human_pose_estimation_tpu_torch.train.step as step

    return pipeline, step


def _expect_incorrect(cell, failing):
    line, notes = run_tiny(cell, encoder_dtype="float32")
    assert line["correct"] is False, notes.get("all numbers")
    assert any(not (float(c["value"]) <= c["limit"]) for k, c in line["checks"].items() if k in failing), line["checks"]


def test_train_state_left_unchanged(monkeypatch, port):
    _, step = port
    monkeypatch.setattr(step, "_apply", lambda opt, sched, params, grads: None)
    _expect_incorrect("hybrid-train-b8", {"change_gap", "change_med"})


def test_train_half_batch(monkeypatch, port):
    pipeline, step = port
    call, mocap = pipeline.DevicePreprocessor.__call__, step.mocap_batch
    monkeypatch.setattr(pipeline.DevicePreprocessor, "__call__",
                        lambda self, host, gen=None: type(call(self, host, gen))(*map(_half, call(self, host, gen))))
    monkeypatch.setattr(step, "mocap_batch", lambda body, pose, shape: mocap(body, _half(pose), _half(shape)))
    _expect_incorrect("hybrid-train-b8", {"mr1_gap"})
