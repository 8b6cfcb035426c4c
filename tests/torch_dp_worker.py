"""Worker of the port's two-process tests (tests/test_torch_train.py,
tests/test_torch_parallel.py): one rank of a gloo group on the CPU.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dp_worker.py TASK.pt OUT_DIR

The environment is torchrun's, read by ``parallel.mesh.
maybe_initialize_distributed``. The task is a ``torch.save``d dict whose
``kind`` names a ``run_*`` function; the worker writes that function's
result to ``OUT_DIR/rank<r>.pt``. Each ``run_*`` function is also what the
parent runs in one process over the whole batch: under a process group it
keeps this rank's rows of the global inputs it is given. Imports torch and
the port only.

``spawn(task, tmp_path)`` starts the ranks and returns their results.
"""
from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from human_pose_estimation_tpu_torch.config import Config  # noqa: E402
from human_pose_estimation_tpu_torch.data.pipeline import DevicePreprocessor  # noqa: E402
from human_pose_estimation_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from human_pose_estimation_tpu_torch.train import step as tstep  # noqa: E402
from human_pose_estimation_tpu_torch.train.state import create_train_state  # noqa: E402
from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model  # noqa: E402

TIMEOUT = 120  # seconds per spawn: a hung rendezvous fails one test, not the run


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(task: dict, tmp_path, world: int = 2):
    """Run ``task`` on ``world`` gloo ranks in fresh processes; their
    results in rank order. A rank that fails or outlives ``TIMEOUT``
    raises with every rank's output."""
    task_path, out_dir = os.path.join(tmp_path, "task.pt"), os.path.join(tmp_path, "out")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(task, task_path)
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(
            os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port), PYTHONPATH=REPO, OMP_NUM_THREADS="1",
        )
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the loopback, whatever the host name resolves to
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task_path, out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n----\n".join(f"rank {r}:\n{log}" for r, log in enumerate(logs)))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


# --------------------------------------------------------------------------
# tasks


def make_state(cfg: Config, weights=None, dtype=torch.float32, sgd=False, dropout_rate=0.5):
    """The seeded CPU state of the tests (the 120-vertex asset), with
    ``weights`` ({'hmr', 'critic', 'mean_theta'} state dicts) loaded, in
    ``dtype``, optionally with SGD(1) optimizers (``before - after`` is the
    gradient) and the last stage's dropout rate."""
    from torch.optim.lr_scheduler import LambdaLR

    state = create_train_state(synthetic_model(num_verts=120, seed=0), synthetic_mean_params(), cfg, device="cpu")
    if weights is not None:
        state.hmr.load_state_dict(weights["hmr"])
        state.critic.load_state_dict(weights["critic"])
        with torch.no_grad():
            state.mean_theta.copy_(weights["mean_theta"])
    state.hmr.to(dtype)
    state.hmr.smpl = state.hmr.smpl.to("cpu", dtype)
    state.critic.to(dtype)
    state.mean_theta.data = state.mean_theta.data.to(dtype)
    state.hmr.regressor.dropout_rate = dropout_rate
    if sgd:
        state.gen_opt = torch.optim.SGD(state.gen_params(), lr=1.0)
        state.critic_opt = torch.optim.SGD(list(state.critic.parameters()), lr=1.0)
        state.gen_sched = LambdaLR(state.gen_opt, lambda count: 1.0)
        state.critic_sched = LambdaLR(state.critic_opt, lambda count: 1.0)
    return state  # else the state's Adam pair (the conversions keep the Parameter objects)


def snapshot(state) -> dict:
    """Every tensor of the state after a step, as numpy: the weights and
    BN statistics, the mean theta, the critic."""
    out = {f"hmr.{k}": v.detach().numpy().copy() for k, v in state.hmr.state_dict().items()}
    out.update({f"critic.{k}": v.detach().numpy().copy() for k, v in state.critic.state_dict().items()})
    out["mean_theta"] = state.mean_theta.detach().numpy().copy()
    return out


def run_step(case: dict) -> dict:
    """One ``make_train_step`` from ``case['weights']`` on this rank's rows
    of ``case['batch']`` (GenBatch arrays) and ``case['mocap']`` (blocks of
    ``num_stage``); ``case['uniforms']`` (the global batch's penalty
    uniforms) replace the generator's draws when given."""
    dtype = case["dtype"]
    cfg = Config(**case["cfg"])
    state = make_state(cfg, case["weights"], dtype, sgd=case["sgd"], dropout_rate=case["dropout"])
    batch = tstep.GenBatch(*(pmesh.local_rows(torch.as_tensor(a).to(dtype)) for a in case["batch"]))
    mocap = tstep.MocapBatch(*(pmesh.local_rows(torch.as_tensor(a).to(dtype), cfg.num_stage) for a in case["mocap"]))
    drawn = tstep._gp_uniforms
    if case.get("uniforms") is not None:
        tstep._gp_uniforms = lambda *a: [torch.as_tensor(u).to(dtype) for u in case["uniforms"]]
    try:
        metrics = tstep.make_train_step(cfg, device="cpu")(state, batch, mocap, torch.Generator().manual_seed(0))
    finally:
        tstep._gp_uniforms = drawn
    return {"metrics": {k: v.numpy() for k, v in vars(metrics).items()}, "state": snapshot(state)}


def run_fused(case: dict) -> dict:
    """One ``make_fused_train_step`` in ``case['dtype']`` on this rank's
    rows of ``case['host']`` (HostBatch arrays) and ``case['raw']``
    ((pose, shape), blocks of ``num_stage``), generator seed 3: the
    augmentation, the dropout and the penalty's uniforms all drawn; SGD(1),
    whose update is the gradient itself (Adam's first update divides
    rounding noise on exact-zero gradients by eps 1e-7)."""
    dtype = case["dtype"]
    cfg = Config(**case["cfg"])
    state = make_state(cfg, None, dtype, sgd=True)
    host = tstep.HostBatch(*(pmesh.local_rows(torch.as_tensor(a)) for a in case["host"]))
    raw = tuple(pmesh.local_rows(torch.as_tensor(a), cfg.num_stage).to(dtype) for a in case["raw"])
    smpl = synthetic_model(num_verts=120, seed=0).to("cpu", dtype)
    fused = tstep.make_fused_train_step(cfg, smpl, augment=True, device="cpu")
    with _preprocessed_in(dtype):
        metrics = fused(state, host, raw, torch.Generator().manual_seed(3))
    return {"metrics": {k: v.numpy() for k, v in vars(metrics).items()}, "state": snapshot(state)}


@contextlib.contextmanager
def _preprocessed_in(dtype):
    """``DevicePreprocessor``'s f32 batch cast to ``dtype`` as it leaves
    (the step's state is in ``dtype``)."""
    call = DevicePreprocessor.__call__

    def cast(self, *args):
        return tstep.GenBatch(*(t.to(dtype) if t.is_floating_point() else t for t in call(self, *args)))

    DevicePreprocessor.__call__ = cast
    try:
        yield
    finally:
        DevicePreprocessor.__call__ = call


def run_cases(task: dict) -> dict:
    runner = {"step": run_step, "fused": run_fused}[task["kind"]]
    return {name: runner(case) for name, case in task["cases"].items()}


class Batches:
    """An in-memory stream of (GenBatch, n_valid), resumable by position."""

    def __init__(self, batches):
        self.batches, self.pos = batches, 0

    def get_state(self):
        return {"pos": self.pos}

    def set_state(self, state):
        self.pos = int(state["pos"])

    def __iter__(self):
        while self.pos < len(self.batches):
            self.pos += 1
            yield self.batches[self.pos - 1]


def run_trainer(task: dict) -> dict:
    """A ``Trainer`` over this rank's rows of ``task['train']`` (global
    batches) for one epoch of ``task['steps']`` steps, validating on the
    last, with a checkpoint at the epoch's end; then a fresh ``Trainer``
    restores it and sweeps ``task['val']`` with ``validate_checkpoint``."""
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    cfg = Config(**task["cfg"])
    smpl = synthetic_model(num_verts=120, seed=0)
    to_batch = lambda arrays: tstep.GenBatch(*(pmesh.local_rows(torch.as_tensor(a)) for a in arrays))  # noqa: E731
    train = Batches([(to_batch(b), cfg.batch_size) for b in task["train"]])
    mocap = [tstep.MocapBatch(*(torch.as_tensor(a) for a in m)) for m in task["mocap"]]
    val = [(to_batch(b), cfg.batch_size) for b in task["val"]]
    trainer = Trainer(cfg, dataset=train, mocap_dataset=mocap, val_dataset=val, smpl=smpl, device="cpu")
    history = trainer.train()
    trained = snapshot(trainer.state)
    fresh = Trainer(cfg, dataset=Batches([]), val_dataset=val, smpl=smpl, device="cpu")
    step = fresh.restore()
    results = fresh.validate_checkpoint(restore=False)
    return {
        "history": history,
        "trained": trained,
        "restored": snapshot(fresh.state),
        "restored_step": step,
        "input_pos": train.pos,
        "validate": results,
        "val_history": trainer._writer("val").history,
        "itr_per_epoch": trainer.num_itr_per_epoch,
    }


def main(task_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    pmesh.maybe_initialize_distributed("cpu")
    task = torch.load(task_path, weights_only=False)
    result = run_trainer(task) if task["kind"] == "trainer" else run_cases(task)
    torch.save(result, os.path.join(out_dir, f"rank{pmesh.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
