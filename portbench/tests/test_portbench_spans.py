"""The reduction of the program's spans with a traced window's device
activity (``portbench/spans.py``), on a hand-made trace: idle gaps, self
time, device work and host syncs each go to the innermost span that holds
them, and every span reader gives None without spans."""
import pytest

from portbench import harness as H
from portbench import roofline, spans

MS = 1_000_000  # ns

# loop.iter [0, 1000] holds loop.next [10, 100], step [100, 800] and
# loop.fetch [800, 950]; the step holds gen.forward [120, 400], which holds
# chamfer.k2 [200, 300]; a later step [2000, 2500] lies outside the window
SPANS = [
    ("loop.iter", -1, 7, 0, 1000 * MS),
    ("loop.next", 0, 7, 10 * MS, 100 * MS),
    ("step", 0, 7, 100 * MS, 800 * MS),
    ("gen.forward", 2, 7, 120 * MS, 400 * MS),
    ("chamfer.k2", 3, 7, 200 * MS, 300 * MS),
    ("loop.fetch", 0, 7, 800 * MS, 950 * MS),
    ("step", -1, 7, 2000 * MS, 2500 * MS),
]
# device work and the runtime calls that launched it, by correlation id
DEVICE = [(150 * MS, 250 * MS, "gemm", 1), (310 * MS, 350 * MS, "assign_kernel", 2),
          (820 * MS, 900 * MS, "Memcpy DtoH", 3)]
RUNTIME = [(130 * MS, 131 * MS, "cudaLaunchKernel", 1), (210 * MS, 211 * MS, "cudaLaunchKernel", 2),
           (150 * MS, 151 * MS, "cudaStreamSynchronize", 9), (805 * MS, 806 * MS, "cudaMemcpyAsync", 3),
           (810 * MS, 900 * MS, "cudaStreamSynchronize", 10)]
METRICS = ["loop_ms.train", "fetch_wait_ms.train", "syncs_per_step.train", "prep_ms.train", "gen_ms.train",
           "critic_ms.train", "adam_ms.train", "k2_call_roofline_pct"]


def _window():
    return spans.reduce_events(SPANS, DEVICE, RUNTIME, 0, 1000 * MS)


class Ctx:
    def __init__(self, extra, tracer=None):
        self.extra, self.tracer = extra, tracer
        self.config = H.cell(H.benchmark(), "hybrid-train-b8")[1]


def test_the_window_keeps_its_spans_and_their_self_time():
    w = _window()
    assert w.steps == 1 and w.calls["loop.iter"] == 1
    assert w.total_ms["step"] == pytest.approx(700)
    assert w.self_ms["step"] == pytest.approx(700 - 280)  # less gen.forward
    assert w.self_ms["gen.forward"] == pytest.approx(280 - 100)
    assert w.self_ms["loop.iter"] == pytest.approx(1000 - 90 - 700 - 150)


def test_an_idle_gap_goes_to_the_innermost_span_at_its_midpoint():
    w = _window()
    # gaps (250, 310): midpoint 280 in chamfer.k2; (350, 820): 585, in the
    # step after gen.forward ended
    assert w.idle_ms == {"chamfer.k2": pytest.approx(60), "step": pytest.approx(470)}


def test_device_work_goes_to_its_launchs_span():
    w = _window()
    # the kernel that ran after chamfer.k2 ended still belongs to it
    assert w.device_ms == {"gen.forward": pytest.approx(100), "chamfer.k2": pytest.approx(40),
                           "loop.fetch": pytest.approx(80)}
    assert w.early == {} and w.unlaunched == 0


def test_a_sync_is_counted_in_its_span():
    w = _window()
    assert w.syncs == {"gen.forward": 1, "loop.fetch": 1}
    assert w.step_syncs == 1 and w.runtime_calls == 5


def test_the_readers_read_the_window():
    ctx = Ctx({"spans": _window(), "chamfer_calls": [(20000, 8)]})
    got = {m: H.load_module("metrics", m).read(ctx, None) for m in METRICS}
    bound = roofline.chamfer_bound_s(20000, 8, ctx.config["max_silhouette_points"], ctx.config["num_verts"], True)
    assert got == {
        "loop_ms.train": pytest.approx(1000 - 700 - 150), "fetch_wait_ms.train": pytest.approx(150),
        "syncs_per_step.train": 1, "prep_ms.train": 0, "gen_ms.train": pytest.approx(280),
        "critic_ms.train": 0, "adam_ms.train": 0, "k2_call_roofline_pct": pytest.approx(100 * bound / 0.040),
    }


def test_every_span_reader_gives_none_without_spans(monkeypatch):
    from human_pose_estimation_tpu_torch.utils import tracing

    class Tracer:
        prof, t_start, t_stop = object(), 0.0, 1e9

    monkeypatch.setattr(spans, "profile_events", lambda prof: (DEVICE, RUNTIME))
    no_step = [("other",) + s[1:] if s[0] == "step" else s for s in SPANS]
    assert spans.reduce_events(no_step, DEVICE, RUNTIME, 0, 1000 * MS).steps == 0
    for taken in ([], no_step):
        monkeypatch.setattr(tracing, "take", lambda: list(taken))
        for ctx in (Ctx({}), Ctx({}, Tracer()), Ctx({"chamfer_calls": [(1, 1)]}, Tracer())):
            for m in METRICS:
                assert H.load_module("metrics", m).read(ctx, None) is None, m
