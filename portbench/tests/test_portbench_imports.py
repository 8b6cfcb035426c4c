"""Nothing the benchmark runs is JAX, Flax or the JAX package, compared by
whole top-level module names; the reference imports nothing of the port."""
import ast
import sys
import types

from portbench import harness as H


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("human_pose_estimation_tpu_torch", "human_pose_estimation_tpu_torchx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert H.forbidden_modules() == sorted(m for m in H.FORBIDDEN if m in {k.split(".")[0] for k in sys.modules})
    monkeypatch.setitem(sys.modules, "human_pose_estimation_tpu.ops", types.ModuleType("x"))
    assert "human_pose_estimation_tpu" in H.forbidden_modules()


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (H.ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & set(H.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "dataclasses", "math", "typing", "torch", ""}
    for path in (H.ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.module in (None, "augment", "losses", "model"), path  # its own modules
        assert _imports(path) <= allowed, (path, _imports(path))
