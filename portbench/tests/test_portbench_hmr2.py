"""The cell ``vith-train-b48`` (HMR 2.0's ViT-H and transformer-decoder
head, ``drivers/train_hmr2.py``) driven through ``run_cell`` on the CPU at
a tiny size (a ViT of depth 2 and width 64, a head of depth 2 and width 64,
64 px crops, batch 4, a 200-vertex body), with its timed path broken
underneath: ``correct`` has to come out false for a step that leaves its
state unchanged and for half of the batch left out. The port computes in
float32 here, so only a fault separates it from the reference. Its new
readers return nothing without a device trace."""
import pytest
import torch

from portbench import flops_vit
from portbench import harness as H
from portbench import trace
from portbench.run import run_cell

CELL = "vith-train-b48"
TINY = {"vit_depth": 2, "vit_width": 64, "vit_heads": 4, "vit_mlp": 256, "head_depth": 2, "head_width": 64,
        "head_heads": 4, "head_dim_head": 16, "head_mlp": 64, "img_size": 64, "num_verts": 200,
        "max_silhouette_points": 256, "batch_size": 4}
NEW = ("mfu.vit.train", "attn_roofline_pct", "head_ms.train")


def _run(seed=2718281828459, **extra):
    line, _, notes = run_cell(CELL, seed, 1.0, False, device="cpu", overrides={**TINY, "encoder_dtype": "float32", **extra},
                              traffic={"pool_batches": 4})
    return line, notes


def test_the_port_in_float32_matches_the_reference():
    line, notes = _run()
    numbers = notes["all numbers"]
    for k, v in {"loss_gap": 1e-4, "mr1_gap": 1e-4, "grad1_gap": 1e-4, "change_gap": 5e-2}.items():
        assert numbers[k] < v, (k, numbers[k])
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}


@pytest.fixture
def step():
    import human_pose_estimation_tpu_torch.train.step as step

    return step


def test_a_state_left_unchanged_is_not_correct(monkeypatch, step):
    monkeypatch.setattr(step, "_apply", lambda opt, sched, params, grads: None)
    line, notes = _run()
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"], notes["all numbers"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch, step):
    import human_pose_estimation_tpu_torch.data.pipeline as pipeline

    half = lambda t: t[: t.shape[0] // 2]  # noqa: E731
    call, mocap = pipeline.DevicePreprocessor.__call__, step.mocap_batch
    monkeypatch.setattr(pipeline.DevicePreprocessor, "__call__",
                        lambda self, host, gen=None: type(call(self, host, gen))(*map(half, call(self, host, gen))))
    monkeypatch.setattr(step, "mocap_batch", lambda body, pose, shape: mocap(body, half(pose), half(shape)))
    line, notes = _run()
    assert line["correct"] is False
    assert line["checks"]["mr1_gap"]["value"] > line["checks"]["mr1_gap"]["limit"], notes["all numbers"]


def test_the_control_and_faults_at_a_tiny_size():
    out = H.load_module("drivers", "train_hmr2").control(CELL, 7, torch.device("cpu"), TINY)
    limits = H.cell(H.benchmark(), CELL)[2]["limits"]
    for name in ("control_fp8", "fault_half_batch", "fault_state_unchanged", "bf16_simulated"):
        assert set(limits) <= set(out[name]), name
    assert out["control_fp8"]["grad1_gap"] > 2 * out["bf16_simulated"]["grad1_gap"]
    assert out["control_fp8"]["grad1_cos_med"] > 10 * out["bf16_simulated"]["grad1_cos_med"]
    assert out["control_fp8"]["correct"] is False
    assert out["fault_half_batch"]["correct"] is False and out["fault_state_unchanged"]["correct"] is False
    assert out["fault_state_unchanged"]["change_gap"] == pytest.approx(1.0)


def test_the_new_readers_return_nothing_without_a_device_trace():
    s = trace.TraceSummary(2.0, 0.0, {}, {}, [], [], {"images": 96, "steps": 2})
    s.lead_s, s.lead_counts = 1.0, {"images": 96}

    class Ctx:
        config = H.cell(H.benchmark(), CELL)[1]
        extra = {}

    for name in NEW:
        assert H.load_module("metrics", name).read(Ctx, s) is None, name
    Ctx.config = H.cell(H.benchmark(), "hybrid-train-b8")[1]  # no ViT: nothing to read, nothing raised
    s.busy_s = 1.0
    for name in NEW:
        assert H.load_module("metrics", name).read(Ctx, s) is None, name


def test_the_operation_counts_at_the_published_widths():
    cfg = H.cell(H.benchmark(), CELL)[1]
    assert flops_vit.tokens(cfg) == 192
    assert 2 * flops_vit.vit_macs(cfg) == pytest.approx(248.0e9, rel=1e-3)  # an image forward
    # the ViT's attention is bound by its bytes at s = 192, d = 80: 512 (layer,
    # head) pairs of 123.6 kB forward and 246.5 kB backward at 3.35 TB/s
    vit = 512 * (123648 + 246528) / 3.35e12
    assert vit < flops_vit.attention_bound_s(cfg) < 1.05 * vit
