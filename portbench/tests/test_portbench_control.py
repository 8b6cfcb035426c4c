"""The control that the limits of ``correct`` were set from, judged by the
harness's own rule against the cell's limits: float8 training, the
reference in float8 put in the training step's place. At a tiny size on
the CPU it runs, reports every compared number of the cell, and loses
precision against the float32 reference; on a card, at the cell's own
size, it comes out not correct."""
import pytest
import torch

from conftest import SIZES, TINY
from portbench import control
from portbench import harness as H


def test_training_control_and_half_batch_fault():
    out = H.load_module("drivers", "train").control("hybrid-train-b8", 7, torch.device("cpu"),
                                                    {**TINY, **SIZES["hybrid-train-b8"]})
    limits = H.cell(H.benchmark(), "hybrid-train-b8")[2]["limits"]
    for name in ("control_fp8", "fault_half_batch", "bf16_simulated"):
        assert set(limits) <= set(out[name]), name
    # float8 training's first gradient is further from float32's than bfloat16's
    assert out["control_fp8"]["grad1_gap"] > 2 * out["bf16_simulated"]["grad1_gap"]
    # half of the batch left out halves the silhouette loss, a sum over the batch
    assert out["fault_half_batch"]["correct"] is False
    assert out["fault_half_batch"]["mr1_gap"] > limits["mr1_gap"]


@pytest.mark.cuda
def test_the_training_control_is_not_correct_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is read at the cell's own size")
    for seed in (101, 102, 103):
        out = control.readings("hybrid-train-b8", seed, 2.0, torch.device("cuda"))
        assert out["program"]["correct"] is True, out["program"]
        assert out["control_fp8"]["correct"] is False, out["control_fp8"]
        assert out["fault_half_batch"]["correct"] is False, out["fault_half_batch"]
