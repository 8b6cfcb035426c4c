"""Shared settings of the benchmark's CPU tests: a tiny size of each cell
that the same harness path runs on the CPU."""
import pytest
import torch

# ResNet of one block per stage at 64 px, a 200-vertex body, 256 silhouette
# slots; the widths of the IEF, SMPL's 24 joints and 10 betas stay
TINY = {"encoder_stage_sizes": [1, 1, 1, 1], "shallow": True, "img_size": 64, "num_verts": 200,
        "max_silhouette_points": 256}
TRAFFIC = {"hybrid-train-b8": {"pool_batches": 4}}
SIZES = {"hybrid-train-b8": {"batch_size": 4}}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


def run_tiny(cell, seed=1234567890123, seconds=1.0, **extra):
    """One run of ``cell`` on the CPU at the tiny size; (line, notes)."""
    from portbench.run import run_cell

    overrides = {**TINY, **SIZES[cell], **extra}
    line, _, notes = run_cell(cell, seed, seconds, False, device="cpu", overrides=overrides, traffic=TRAFFIC[cell])
    return line, notes
