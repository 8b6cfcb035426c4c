"""The yardstick's arithmetic against hand-worked values."""
import pytest

from portbench import flops, roofline
from portbench import harness as H


def test_resnet50_forward_macs():
    # ResNet-50 v1 at 224 px (the stride on the first 1x1 of a block, as He
    # et al. 2016 and Keras place it): 3.86 GMAC of convolutions, the
    # paper's "3.8 x 10^9 FLOPs" of multiply-adds. The often quoted 4.1 GMAC
    # is v1.5's, with the stride on the 3x3.
    macs = flops.resnet_macs((3, 4, 6, 3), 224)
    assert macs == 3_855_925_248


def test_stem_and_first_block_by_hand():
    # stem: 112 x 112 x (7 x 7 x 3) x 64; one block of stage 1 at 56 x 56:
    # shortcut 64->256, 1x1 64->64, 3x3 64->64, 1x1 64->256
    stem = 112 * 112 * 147 * 64
    block = 56 * 56 * (64 * 256 + 64 * 64 + 9 * 64 * 64 + 64 * 256)
    stage1_rest = 2 * 56 * 56 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert flops.resnet_macs((3,), 224) == stem + block + stage1_rest


def test_ief_and_smpl_counts():
    assert flops.ief_macs(2048, 1024, 3) == 3 * ((2048 + 85) * 1024 + 1024 * 1024 + 1024 * 85)
    v = 6890
    assert flops.smpl_macs(v, 10, 24, 207, 14) == 10 * 3 * v + v * 24 * 3 + 207 * 3 * v + v * 24 * 12 + v * 9 + v * 14 * 3


def test_training_is_three_forwards():
    cfg = H.cell(H.benchmark(), "hybrid-train-b8")[1]
    assert flops.train_flops(cfg) == pytest.approx(3 * flops.forward_flops(cfg, cfg["num_stage"]))
    # three body-model calls are under 1% of the image's forward
    assert flops.forward_flops(cfg, 3) / flops.forward_flops(cfg, 0) < 1.01


def test_chamfer_bound_at_the_kernel_phase_inputs():
    # 27,506 valid pixels against 6890 vertices: 7 operations a pair over
    # 67 TFLOP/s is 0.0198 ms; the bytes (~2.5 MB) take 0.0008 ms
    bound = roofline.chamfer_bound_s(27506, 8, 16384, 6890, with_grad=False)
    assert bound == pytest.approx(7 * 27506 * 6890 / 67e12)
    assert bound * 1e3 == pytest.approx(0.0198, abs=5e-5)
    # an empty batch is bound by its bytes, and the gradient adds its output
    empty = roofline.chamfer_bound_s(0, 8, 16384, 6890, with_grad=False)
    assert empty == pytest.approx(4 * (8 * 16384 * 3 + 8 * 6890 * 2 + 8) / 3.35e12)
    assert roofline.chamfer_bound_s(0, 8, 16384, 6890, with_grad=True) > empty
