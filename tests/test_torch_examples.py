"""The port's examples (``examples/torch_*.py``) on the CPU.

The two that touch no device print what their JAX namesakes print: both
sides run in subprocesses under one ``PYTHONHASHSEED`` (the simulator
keys its jitter by Python's salted ``hash``), the JAX side with
``PYTHONPATH=src:.``; only the solver's wall time may differ.  The three
that run engines or a trainer run to their end on the CPU when asked
(the analytics example's resume assert included), and ask for the card by
default, raising where there is none.
"""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script, pythonpath):
    env = dict(os.environ, PYTHONHASHSEED="0", CUDA_VISIBLE_DEVICES="",
               JAX_PLATFORMS="cpu", PYTHONPATH=pythonpath)
    res = subprocess.run([sys.executable, str(EXAMPLES / script)], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True, cwd=ROOT)
    return res.stdout


@pytest.mark.parametrize("name", ["quickstart", "online_serving"])
def test_simulated_examples_print_what_the_jax_ones_print(name):
    src = str(ROOT / "src")
    jax_out = _run(f"{name}.py", src + os.pathsep + str(ROOT))
    port_out = _run(f"torch_{name}.py", src)

    def masked(text):
        return re.sub(r"\(\d+\.\d ms solve\)", "(ms solve)", text)

    assert masked(port_out) == masked(jax_out)
    assert "halo" in port_out or "online:" in port_out


def test_batch_analytics_runs_and_resumes_on_the_cpu(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _load("torch_batch_analytics").main(["--queries", "2", "--device",
                                         "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"plan: \d+ epochs", out)
    assert "completed 2 queries" in out
    assert re.search(r"resume from checkpoint: .*\((\d+) results restored",
                     out)
    assert (tmp_path / "halo_example_ckpt.json").exists()


def test_mixed_batch_runs_on_the_cpu(capsys):
    _load("torch_mixed_batch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "templates:" in out and "makespan:" in out
    assert re.search(r"pages_shared: \d+ tokens_reused: \d+", out)


def test_train_lm_takes_two_steps_and_resumes(tmp_path, capsys):
    mod = _load("torch_train_lm")
    cfg = get_smoke("qwen3-1.7b")
    args = ["--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    first = mod.main(["--steps", "2", *args], cfg=cfg)
    assert [h["step"] for h in first["history"]] == [0, 1]
    assert (tmp_path / "step_000000002").exists()
    resumed = mod.main(["--steps", "3", *args], cfg=cfg)
    assert [h["step"] for h in resumed["history"]] == [2]
    assert "loss" in capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("torch_batch_analytics", ["--queries", "2"]),
    ("torch_mixed_batch", []),
    ("torch_train_lm", ["--steps", "1"])])
def test_examples_ask_for_the_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
