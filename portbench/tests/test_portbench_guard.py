"""The import guard: no module of JAX or of the JAX package in a run,
compared by whole top-level names; the reference, and every
architecture's module beside it, imports nothing of the port."""
import ast
import json
import pathlib
import subprocess
import sys

from portbench.harness.guard import forbidden

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent


def test_top_level_names_compared_whole():
    assert forbidden(["repro_torch", "repro_torch.engine", "reprox",
                      "jaxtyping", "torch"]) == []
    assert forbidden(["repro.engine", "jax.numpy", "flax", "jaxlib.xla"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    paths = sorted((PB / "reference").glob("*.py")) \
        + sorted((PB / "archs").glob("*.py"))
    assert PB / "archs" / "gqa.py" in paths
    for path in paths:
        names = set(_imports(path))
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"repro_torch", "repro", "jax", "flax", "jaxlib"}, \
            path
        assert tops <= {"__future__", "math", "zlib", "typing", "torch",
                        "portbench"}, (path, tops)
        # of the benchmark, only the reference, the architectures and
        # the yardstick: not the harness, which drives the port
        ours = {n.split(".")[1] for n in names
                if n.startswith("portbench.")}
        assert ours <= {"reference", "archs", "yardstick"}, (path, ours)
    for path in sorted(PB.rglob("*.py")):
        if "tests" in path.parts:
            continue
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"repro", "jax", "flax", "jaxlib"}, path


def test_loading_the_harness_loads_no_jax():
    code = ("import sys, json; sys.path[:0] = [%r, %r];"
            "import portbench.reference.model, portbench.harness.cell,"
            " portbench.harness.check, portbench.harness.main;"
            "import repro_torch.engine.engine;"
            "ref = [m for m in sys.modules if m.startswith('repro_torch')];"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    code = ("import sys; sys.path[:0] = [%r];"
            "import portbench.reference.model, portbench.reference.weights,"
            " portbench.archs.gqa;"
            "from portbench.harness.spec import Bench;"
            "Bench(%r).arch('gqa');"
            "print(sorted(m for m in sys.modules if m.startswith('repro')))"
            % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_module_loaded_after_the_window_withholds_the_result(
        monkeypatch, capsys):
    """A module of JAX that appears after the window (in tear-down, the
    reference or a metric reader) stops the run before its result line."""
    import types

    import torch

    from portbench.harness import cell, main

    def run(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cell, "run", run)
    rc = main.main(["--workload", "ds67b.halo_nodes", "--seed", "1",
                    "--seconds", "1"], 0.0, ROOT)
    out = capsys.readouterr()
    assert rc == main.EXIT_FORBIDDEN
    assert out.out == "" and "jax" in out.err
