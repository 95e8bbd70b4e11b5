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
              "repro_torch.configs.deepseek_moe_16b",
              "repro_torch.configs.qwen3_8b",
              "repro_torch.configs.llama32_3b",
              "repro_torch.engine.models.moe",
              "repro_torch.engine.models.rglru",
              "repro_torch.engine.models.xlstm",
              "repro_torch.engine.models.encdec",
              "repro_torch.configs.internvl2_2b",
              "repro_torch.configs.xlstm_350m",
              "repro_torch.configs.whisper_tiny",
              "repro_torch.kernels.decode_attention.ops",
              "repro_torch.kernels.rglru_scan.ops",
              "repro_torch.kernels.shared_prefix_attention.ops",
              "repro_torch.kernels.shared_prefix_attention.ref",
              "repro_torch.core", "repro_torch.core.solver",
              "repro_torch.workloads", "repro_torch.workloads.library",
              "repro_torch.runtime", "repro_torch.runtime.executors",
              "repro_torch.runtime.session", "repro_torch.runtime.migrate",
              "repro_torch.launch.serve", "repro_torch.training",
              "repro_torch.training.trainer",
              "repro_torch.training.optimizer",
              "repro_torch.training.checkpoint",
              "repro_torch.training.grad_compress",
              "repro_torch.training.data", "repro_torch.launch.train",
              "repro_torch.launch.mesh", "repro_torch.distribution",
              "repro_torch.distribution.sharding",
              "repro_torch.distribution.collectives",
              "repro_torch.launch.op_cost", "repro_torch.launch.dryrun",
              "repro_torch.launch.roofline", "repro_torch.cost_hooks"):
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
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.stem for p in examples] == [
        "torch_batch_analytics", "torch_mixed_batch", "torch_online_serving",
        "torch_quickstart", "torch_train_lm"]
    sources = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py", *examples]
    assert PKG / "kernels" / "paged_decode_attention" / "tune.py" in sources
    assert PKG / "configs" / "recurrentgemma_2b.py" in sources
    assert PKG / "engine" / "models" / "rglru.py" in sources
    assert PKG / "engine" / "models" / "moe.py" in sources
    assert PKG / "engine" / "models" / "encdec.py" in sources
    assert PKG / "engine" / "models" / "xlstm.py" in sources
    assert PKG / "configs" / "whisper_tiny.py" in sources
    assert PKG / "configs" / "deepseek_moe_16b.py" in sources
    assert PKG / "kernels" / "shared_prefix_attention" / "ops.py" in sources
    for sub in ("core", "workloads", "runtime", "launch"):
        assert PKG / sub / "__init__.py" in sources, sub
    assert PKG / "runtime" / "executors.py" in sources
    assert PKG / "launch" / "serve.py" in sources
    assert PKG / "launch" / "train.py" in sources
    assert PKG / "training" / "trainer.py" in sources
    assert PKG / "launch" / "mesh.py" in sources
    for mod in ("__init__", "sharding", "collectives"):
        assert PKG / "distribution" / f"{mod}.py" in sources, mod
    for mod in ("op_cost", "dryrun", "roofline"):
        assert PKG / "launch" / f"{mod}.py" in sources, mod
    assert PKG / "cost_hooks.py" in sources
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                       "benchmarks"):
                    offenders.append(f"{path}:{node.lineno}: {n}")
    assert not offenders, offenders


def test_engine_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(get_smoke("qwen3-1.7b"))


@pytest.mark.parametrize("arch", ["internvl2-2b", "xlstm-350m",
                                  "whisper-tiny"])
def test_multimodal_and_recurrent_engines_raise_without_a_card(arch):
    """The VLM, ssm and encoder-decoder engines ask for the card by
    default too; the CPU is reached only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(get_smoke(arch))
    eng = InferenceEngine(get_smoke(arch), device="cpu")
    assert eng.model.device.type == "meta" and eng.device.type == "cpu"


def test_processor_entry_points_default_to_cuda_and_raise_without_a_card():
    """An engine host, a session's open() and the launcher with default
    arguments ask for the card, and raise where there is none: none falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve
    from repro_torch.runtime import ProcessorSession
    from repro_torch.runtime.executors import EngineHost
    from repro_torch.workloads.datagen import build_database
    from repro_torch.workloads.tools import ToolRuntime
    models = {"qwen3-14b": get_smoke("qwen3-1.7b").replace(name="qwen3-14b")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineHost(models)
    session = ProcessorSession(models, ToolRuntime(build_database("tpch")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session.open()
    assert session.hosts is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    # the CPU is reached only when asked for
    host = EngineHost(models, engine_kwargs={"device": "cpu"})
    assert host.engine_for("qwen3-14b").device.type == "cpu"
    host.shutdown()


def test_training_entry_points_default_to_cuda_and_raise_without_a_card():
    """``train_loop`` and the training launcher with default arguments ask
    for the card, and raise where there is none; the CPU is reached only
    when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train
    from repro_torch.training import (DataConfig, TrainerConfig,
                                      train_loop)
    cfg = get_smoke("qwen3-1.7b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(cfg, TrainerConfig(), dcfg, num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-1.7b", "--steps", "1"])
    out = train_loop(cfg, TrainerConfig(), dcfg, num_steps=1, device="cpu")
    assert out["model"].device.type == "cpu"


def test_distribution_entry_points_default_to_cuda_and_raise_without_a_card(
        tmp_path):
    """The meshes ask for the card by default and raise where there is
    none; on the CPU, asked for, a one-rank gloo group's debug mesh and
    ``sharded_decode_attention`` over it run the decode's plain version
    (no kernel launch) and give the unsharded result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import torch.distributed as dist
    from repro_torch.distribution.collectives import (
        sharded_decode_attention)
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    for make in (make_debug_mesh, make_production_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_debug_mesh()
        mesh = make_debug_mesh(device="cpu")
        assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1, 1)
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 16, generator=g)
        k, v = (torch.randn(2, 12, 2, 16, generator=g) for _ in range(2))
        qp = torch.tensor([11, 4], dtype=torch.int32)
        kp = torch.arange(12, dtype=torch.int32).expand(2, 12).contiguous()
        da_ops.reset_counts()
        out = sharded_decode_attention(q, k, v, qp, kp,
                                       group=mesh.get_group("model"))
        assert da_ops.launches == 0
        ref = da_ops.decode_attention(q, k, v, q_positions=qp,
                                      kv_positions=kp)
        torch.testing.assert_close(out, ref, atol=2e-6, rtol=2e-6)
    finally:
        dist.destroy_process_group()


def test_training_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.training, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120, capture_output=True)


def test_dry_run_imports_no_jax():
    """The dry run, its counter and the roofline import no JAX and nothing
    of the JAX package, and importing them opens no process group."""
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120, capture_output=True)


def test_registry_holds_the_ported_config_only():
    """The registry holds the JAX package's ten archs, each equal to its
    config (full and smoke), and nothing else: an arch name neither
    registry has raises in both."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke as jax_smoke
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS == (
        "deepseek-moe-16b", "mixtral-8x22b", "whisper-tiny", "deepseek-67b",
        "llama3.2-3b", "qwen3-1.7b", "qwen3-8b", "internvl2-2b",
        "xlstm-350m", "recurrentgemma-2b")
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim",
              "rope_theta", "qk_norm", "tie_embeddings", "norm_eps",
              "dtype", "block_pattern", "local_attn_window", "lru_width",
              "conv1d_width", "swa_window", "moe", "enc_layers",
              "enc_max_len", "num_patches", "supports_partial_prefix")
    for arch, vocab in (("qwen3-1.7b", 152064),
                        ("recurrentgemma-2b", 256000),
                        ("deepseek-moe-16b", 102400), ("qwen3-8b", 152064),
                        ("llama3.2-3b", 128256), ("internvl2-2b", 92672),
                        ("xlstm-350m", 50432), ("whisper-tiny", 51968),
                        ("mixtral-8x22b", 32768), ("deepseek-67b", 102400)):
        for mine, ref in ((get_config(arch), jax_config(arch)),
                          (get_smoke(arch), jax_smoke(arch))):
            for f in fields:
                a, b = getattr(mine, f), getattr(ref, f)
                if f == "moe" and a is not None:
                    a, b = vars(a), vars(b)
                assert a == b, (arch, f)
            assert mine.param_count() == ref.param_count()
            assert mine.attention_impl == "cuda"
        assert get_config(arch).padded_vocab == vocab
    for get in (get_config, jax_config):
        with pytest.raises(KeyError):
            get("mixtral-8x7b")


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


def test_models_and_kernels_do_not_import_the_launch_layer():
    """The models and kernels reach the op-cost counter through
    ``repro_torch.cost_hooks`` only: nothing under ``engine/models/`` or
    ``kernels/`` imports ``repro_torch.launch``."""
    offenders = []
    for sub in (PKG / "engine" / "models", PKG / "kernels"):
        for path in sub.rglob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    continue
                offenders += [f"{path}:{node.lineno}: {n}" for n in names
                              if n.startswith("repro_torch.launch")]
    assert not offenders, offenders
