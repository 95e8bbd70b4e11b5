"""The port's package boundary: it stands apart from JAX and from the JAX
package, its registry holds only what is ported, and it never moves to
the CPU on its own."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("repro_torch.configs.recurrentgemma_2b",
              "repro_torch.engine.models.rglru",
              "repro_torch.engine.models.xlstm",
              "repro_torch.kernels.decode_attention.ops",
              "repro_torch.kernels.rglru_scan.ops",
              "repro_torch.kernels.shared_prefix_attention.ops",
              "repro_torch.kernels.shared_prefix_attention.ref"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120, capture_output=True)


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    sources = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    assert PKG / "configs" / "recurrentgemma_2b.py" in sources
    assert PKG / "engine" / "models" / "rglru.py" in sources
    assert PKG / "kernels" / "shared_prefix_attention" / "ops.py" in sources
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path}:{node.lineno}: {n}")
    assert not offenders, offenders


def test_engine_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(get_smoke("qwen3-1.7b"))


def test_registry_holds_the_ported_config_only():
    """The registry holds qwen3-1.7b and recurrentgemma-2b, each equal to
    the JAX package's config (full and smoke), and nothing else."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke as jax_smoke
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == ("qwen3-1.7b", "recurrentgemma-2b")
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim",
              "rope_theta", "qk_norm", "tie_embeddings", "norm_eps",
              "dtype", "block_pattern", "local_attn_window", "lru_width",
              "conv1d_width", "swa_window")
    for arch, vocab in (("qwen3-1.7b", 152064),
                        ("recurrentgemma-2b", 256000)):
        for mine, ref in ((get_config(arch), jax_config(arch)),
                          (get_smoke(arch), jax_smoke(arch))):
            for f in fields:
                assert getattr(mine, f) == getattr(ref, f), (arch, f)
            assert mine.param_count() == ref.param_count()
            assert mine.attention_impl == "cuda"
        assert get_config(arch).padded_vocab == vocab
    with pytest.raises(KeyError):
        get_config("llama3.2-3b")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """The smoke script prints no result and exits non-zero where there is
    no CUDA device, and where it stands without the rest of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
