"""The port's copies of the JAX package's pure-Python modules stay equal to
their originals.

``repro_torch/core/``, ``repro_torch/workloads/``, the runtime modules
that the port takes over unchanged and ``training/data.py`` are copies of
the JAX package's modules of the same name: once ``repro.`` is read as ``repro_torch.`` and the
module docstring is dropped, each must parse to the same syntax tree as
its original, so a copy cannot drift from the reference unnoticed.  The
two runtime modules the port changes on purpose are compared statement
by statement, down to each class's members, and may differ only in the
statements ``CHANGED`` names.
"""
import ast
import itertools
import pathlib
import re

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

SUBPACKAGES = ("core", "workloads", "runtime", "training")
# modules of these JAX subpackages that the port does not copy, with why:
# left out, or rewritten for PyTorch (then the port has a module of the
# same name that is not compared)
NOT_COPIED = {
    # training: the JAX modules work on pytrees of jax arrays
    "training/__init__.py": "rewritten: imports the rewritten modules",
    "training/optimizer.py": "rewritten: AdamW on dicts of torch tensors",
    "training/trainer.py": "rewritten: autograd, an nn.Module's params",
    "training/checkpoint.py": "rewritten: torch tensors, named leaves",
    "training/grad_compress.py": "rewritten: dicts of torch tensors",
}
REWRITTEN = {n for n, why in NOT_COPIED.items()
             if why.startswith("rewritten")}
# copies that differ from their original on purpose: only the named
# statements differ (a top-level name, ``Class.member``, or an import by
# the module it imports from), each with why; every other statement, down
# to each class's members, must equal the original's
CHANGED = {
    "runtime/executors.py": {
        "from typing": "the weights loader's type (Callable)",
        "import torch": "the card check",
        "EngineHost.__init__": "takes the engines' weights (a loader: the "
                               "port's init draws differ from JAX's) and "
                               "raises without a card",
        "EngineHost.engine_for": "loads the weights at every switch "
                                 "(unload() sends them to 'meta')",
    },
    "runtime/session.py": {
        "ProcessorConfig.hardware": "the cost model plans on the port's "
                                    "card, not always on h200",
        "ProcessorSession._build_cm": "plans on config.hardware",
    },
}
COPIED = sorted(
    str(p.relative_to(JAX_PKG))
    for sub in SUBPACKAGES
    for p in (JAX_PKG / sub).glob("*.py")
    if str(p.relative_to(JAX_PKG)) not in NOT_COPIED
    and str(p.relative_to(JAX_PKG)) not in CHANGED)


def _statements(source: str, rewrite_prefix: bool) -> list:
    """The module's top-level statements, without its docstring;
    ``rewrite_prefix`` reads ``repro.`` as ``repro_torch.`` first."""
    if rewrite_prefix:
        source = re.sub(r"\brepro\.", "repro_torch.", source)
    body = ast.parse(source).body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    return body


def _body(source: str, rewrite_prefix: bool) -> list:
    """The module's top-level statements as ``ast.dump`` strings."""
    return [ast.dump(node) for node in _statements(source, rewrite_prefix)]


def _key(node: ast.stmt) -> str:
    """A statement's name: a def, class or assigned name; an import by
    the module it imports from; else its whole syntax tree."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and len(node.targets) == 1 \
            and isinstance(node.targets[0], ast.Name):
        return node.targets[0].id
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return node.target.id
    if isinstance(node, ast.ImportFrom):
        return f"from {node.module}"
    if isinstance(node, ast.Import):
        return "import " + ",".join(a.name for a in node.names)
    return ast.dump(node)


def _members(source: str, rewrite_prefix: bool) -> list:
    """The module's statements as (name, ``ast.dump``) pairs, each class
    split into its header and its members (``Class.member``)."""
    out = []
    for node in _statements(source, rewrite_prefix):
        if isinstance(node, ast.ClassDef):
            head = ast.ClassDef(name=node.name, bases=node.bases,
                                keywords=node.keywords, body=[],
                                decorator_list=node.decorator_list)
            out.append((node.name, ast.dump(head)))
            out += [(f"{node.name}.{_key(m)}", ast.dump(m))
                    for m in node.body]
        else:
            out.append((_key(node), ast.dump(node)))
    return out


def _differences(mine: list, ref: list, allowed) -> list:
    """Names whose statements differ, are missing, extra or out of order,
    other than ``allowed``."""
    a = [kv for kv in mine if kv[0] not in allowed]
    b = [kv for kv in ref if kv[0] not in allowed]
    ka, kb = [k for k, _ in a], [k for k, _ in b]
    if ka != kb:
        return [next(x or y for x, y in itertools.zip_longest(ka, kb)
                     if x != y)]
    return [k for (k, x), (_, y) in zip(a, b) if x != y]


def test_every_module_of_the_three_packages_is_accounted_for():
    """Each module of the compared subpackages (``SUBPACKAGES``) is copied,
    changed where listed, rewritten or left out, and the port has no module
    there that the JAX package lacks."""
    left_out = set(NOT_COPIED) - REWRITTEN
    for sub in SUBPACKAGES:
        mine = {p.name for p in (PORT / sub).glob("*.py")}
        ref = {p.name for p in (JAX_PKG / sub).glob("*.py")}
        assert mine == ref - {pathlib.Path(n).name for n in left_out
                              if n.startswith(sub + "/")}, sub
    assert set(CHANGED) <= {str(p.relative_to(PORT))
                            for p in PORT.rglob("*.py")}
    assert "training/data.py" in COPIED
    assert len(COPIED) >= 27


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_original(rel):
    mine = _body((PORT / rel).read_text(), rewrite_prefix=False)
    ref = _body((JAX_PKG / rel).read_text(), rewrite_prefix=True)
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a == b, (f"{rel}: top-level statement {i + 1} differs from "
                        f"the JAX package's:\nport: {a[:300]}\nJAX:  "
                        f"{b[:300]}")
    assert len(mine) == len(ref), f"{rel}: {len(mine)} statements, JAX " \
                                  f"package {len(ref)}"


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_copy_differs_only_where_listed(rel):
    """Every statement of a deliberately changed copy equals its
    original's, class members included, except the listed ones; each
    listed one is really there and really differs."""
    mine = _members((PORT / rel).read_text(), rewrite_prefix=False)
    ref = _members((JAX_PKG / rel).read_text(), rewrite_prefix=True)
    allowed = CHANGED[rel]
    assert _differences(mine, ref, allowed) == [], \
        f"{rel}: differs from the JAX package outside {sorted(allowed)}"
    mine_d, ref_d = dict(mine), dict(ref)
    for name in allowed:
        assert mine_d.get(name) != ref_d.get(name), \
            f"{rel}: {name} is listed as changed but equals the original"


def test_the_member_check_sees_a_changed_member():
    """A change in a member the list does not name fails the comparison
    of a changed copy; one in a listed member does not."""
    rel = "runtime/executors.py"
    src = (PORT / rel).read_text()
    ref = _members((JAX_PKG / rel).read_text(), rewrite_prefix=True)
    allowed = CHANGED[rel]
    for old, new, name in (
            ("class GPUWorkerThread(", "class GPUWorkerThread(object, ",
             "GPUWorkerThread"),
            ("return self._engines.get(model)",
             "return self._engines.get(model, None)",
             "EngineHost.peek_engine")):
        moved = src.replace(old, new, 1)
        assert moved != src
        assert _differences(_members(moved, False), ref, allowed) == [name]
    listed = src.replace("def engine_for(self, model: str)",
                         "def engine_for(self, model: str, _x=0)", 1)
    assert listed != src
    assert _differences(_members(listed, False), ref, allowed) == []


def test_the_check_sees_a_changed_copy():
    """A copy whose code moved from the original fails the comparison; a
    changed docstring or import prefix alone does not."""
    src = (JAX_PKG / "core" / "plan.py").read_text()
    ref = _body(src, rewrite_prefix=True)
    port = re.sub(r"\brepro\.", "repro_torch.", src)
    port = port.replace('"""ExecutionPlan', '"""A copy. ExecutionPlan', 1)
    assert _body(port, rewrite_prefix=False) == ref
    assert _body(port.replace("return out", "return out[:1]", 1),
                 rewrite_prefix=False) != ref
