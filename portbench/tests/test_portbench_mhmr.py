"""The cell ``mhmr-train-b8`` (Multi-HMR's ViT-L/14, Human Prediction Head and
SMPL-X on person slots, ``drivers/train_mhmr.py``) driven through
``run_cell`` on the CPU at a tiny size (a ViT of depth 2 and width 32 on
56 px images of 4 x 4 patches, a head of depth 2 and width 32, 3 slots an
image, batch 2, a 64-vertex body, people 20 to 40 px tall), with its timed
path broken underneath: ``correct`` has to come out false for a step that
leaves its state unchanged, for half of the batch left out, and for a step
that counts the padded slots as people. The port computes in float32
here, so only a fault separates it from the reference. Its new readers
return nothing without a device trace."""
import pytest
import torch

from portbench import flops_mhmr
from portbench import harness as H
from portbench import trace
from portbench.run import run_cell

CELL = "mhmr-train-b8"
TINY = {"vit_depth": 2, "vit_width": 32, "vit_heads": 2, "vit_mlp": 64, "head_depth": 2, "head_width": 32,
        "head_heads": 2, "head_dim_head": 16, "head_mlp": 32, "img_size": 56, "num_verts": 64,
        "max_silhouette_points": 256, "batch_size": 2, "person_slots": 3}
TRAFFIC = {"pool_batches": 3, "canvas": 56, "min_height": 20, "max_height": 40}
NEW = ("mfu.mhmr.train", "attn_roofline_pct.mhmr", "queries_ms.train")


def _run(seed=2718281828459, **extra):
    line, _, notes = run_cell(CELL, seed, 1.0, False, device="cpu", overrides={**TINY, "encoder_dtype": "float32", **extra},
                              traffic=TRAFFIC)
    return line, notes


def test_the_port_in_float32_matches_the_reference():
    line, notes = _run()
    numbers = notes["all numbers"]
    for k, v in {"loss_gap": 1e-4, "mr1_gap": 1e-4, "det1_gap": 1e-4, "grad1_gap": 1e-4, "change_gap": 5e-2}.items():
        assert numbers[k] < v, (k, numbers[k])
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert set(line["checks"]) == {"mr1_gap", "grad1_cos_med", "change_gap", "change_med", "det1_gap"}


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

    half_images = lambda t: t[: t.shape[0] // 2]  # noqa: E731
    call, mocap = pipeline.SlotPreprocessor.__call__, step.mocap_batch

    def halved(self, host, gen=None):
        b = call(self, host, gen)  # the slot rows of the first images are the first half of the rows
        return type(b)(*map(half_images, b))

    monkeypatch.setattr(pipeline.SlotPreprocessor, "__call__", halved)
    monkeypatch.setattr(step, "mocap_batch", lambda body, pose, shape: mocap(body, half_images(pose), half_images(shape)))
    line, notes = _run()
    assert line["correct"] is False
    assert line["checks"]["mr1_gap"]["value"] > line["checks"]["mr1_gap"]["limit"], notes["all numbers"]


def test_padded_slots_counted_as_people_is_not_correct(monkeypatch):
    """The masked means' bookkeeping skipped: every slot valid, the padded
    ones at the image's first patch with empty silhouettes."""
    import human_pose_estimation_tpu_torch.data.pipeline as pipeline

    call = pipeline.SlotPreprocessor.__call__
    monkeypatch.setattr(pipeline.SlotPreprocessor, "__call__",
                        lambda self, host, gen=None: call(self, host, gen)._replace(
                            valid=torch.ones_like(call(self, host, gen).valid)))
    line, notes = _run()
    assert line["correct"] is False
    bad = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert bad, notes["all numbers"]


def test_the_control_and_faults_at_a_tiny_size(monkeypatch):
    cell = H.cell

    def tiny_traffic(bench, name, root=H.ROOT):
        entry, cfg, wl = cell(bench, name, root)
        return entry, cfg, {**wl, "traffic": {**wl["traffic"], **TRAFFIC}}

    monkeypatch.setattr(H, "cell", tiny_traffic)
    out = H.load_module("drivers", "train_mhmr").control(CELL, 7, torch.device("cpu"), TINY)
    limits = H.cell(H.benchmark(), CELL)[2]["limits"]
    for name in ("control_fp8", "fault_half_batch", "fault_state_unchanged", "fault_padded_as_people",
                 "fault_detection_per_image", "bf16_simulated"):
        assert set(limits) <= set(out[name]), name
    assert out["control_fp8"]["grad1_cos_med"] > 10 * out["bf16_simulated"]["grad1_cos_med"]
    assert out["fault_half_batch"]["correct"] is False and out["fault_state_unchanged"]["correct"] is False
    # this seed's first batch has no padded slot; the later steps' have
    assert out["fault_padded_as_people"]["loss_gap"] > 100 * out["bf16_simulated"]["loss_gap"]
    assert out["fault_state_unchanged"]["change_gap"] == pytest.approx(1.0)
    # two images: the per-image means sum to twice the loss
    assert out["fault_detection_per_image"]["correct"] is False
    assert out["fault_detection_per_image"]["det1_gap"] == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("key", ["fov_deg", "ray_bands", "drop_path_rate"])
def test_the_program_config_refuses_a_file_the_program_does_not_follow(key):
    """The camera's field of view, the ray bands and the stochastic depth
    are fixed in the program: a configuration file that states others is
    refused before any weight is made, as is a pair the program lacks."""
    driver = H.load_module("drivers", "train_mhmr")
    cfg = H.cell(H.benchmark(), CELL)[1]
    driver.model_config(cfg, 1)
    with pytest.raises(ValueError, match=key):
        driver.model_config({**cfg, key: cfg[key] + 1}, 1)
    with pytest.raises(ValueError, match="no model"):
        driver.model_config({**cfg, "head": "transformer"}, 1)


def test_the_new_readers_return_nothing_without_a_device_trace():
    s = trace.TraceSummary(2.0, 0.0, {}, {}, [], [], {"images": 16, "steps": 2})
    s.lead_s, s.lead_counts = 1.0, {"images": 16}

    class Ctx:
        config = H.cell(H.benchmark(), CELL)[1]
        extra = {}

    for name in NEW:
        assert H.load_module("metrics", name).read(Ctx, s) is None, name
    Ctx.config = H.cell(H.benchmark(), "vith-train-b48")[1]  # no person slots: nothing to read, nothing raised
    s.busy_s = 1.0
    for name in NEW:
        assert H.load_module("metrics", name).read(Ctx, s) is None, name


def test_the_operation_counts_at_the_published_widths():
    cfg = H.cell(H.benchmark(), CELL)[1]
    assert flops_mhmr.tokens(cfg) == 4097
    s, d = 4097, 1024
    linear, attention = 24 * s * d * d, 4 * s * s * d  # a block's forward
    assert 2 * flops_mhmr.vit_macs(cfg) == pytest.approx(24 * (linear + attention) + 2 * 4096 * 3 * 14 * 14 * d)
    assert attention / (linear + attention) == pytest.approx(0.40, abs=0.01)
    assert flops_mhmr.train_flops(cfg) == pytest.approx(12.4e12, rel=0.02)  # an image, training
    # the ViT's attention is bound by its operations at s = 4097, d = 64: 384
    # (block, head) pairs of 4.3 GFLOP forward and 8.6 GFLOP backward at 989
    # TFLOP/s; the head's 16 cross-attention calls by their bytes, 3 thousandths more
    vit = 384 * 12 * s * s * 64 / 989e12
    assert vit < flops_mhmr.attention_bound_s(cfg) < 1.005 * vit
