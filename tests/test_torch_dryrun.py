"""The port's dry run (``repro_torch.launch.dryrun``) and what it lowers:
the chunked plain attention and the sequence-parallel hints of
``engine/models/layers.py``, the configs' cell helpers, the dry run's
arithmetic against the JAX package's, its CLI, and full-size cells on a
fake 256-rank group.  Every fake group runs in a subprocess."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 input_shapes, shape_applicable)
from repro_torch.engine.models import layers as L  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


# ------------------------------------------------------ chunked attention
def _inputs(rng, B, Sq, Skv, H, Hkv, Dh):
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32)
    return q, k, v


def _jax_chunked(q, k, v, qp, kp, **kw):
    import jax.numpy as jnp

    from repro.engine.models.layers import attention_xla_chunked
    out = attention_xla_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_positions=jnp.asarray(qp),
                                kv_positions=jnp.asarray(kp), **kw)
    return np.asarray(out)


def _torch_chunked(q, k, v, qp, kp, **kw):
    t = torch.from_numpy
    return L.attention_torch_chunked(t(q), t(k), t(v),
                                     q_positions=t(qp), kv_positions=t(kp),
                                     **kw).numpy()


# f32 on both sides; the logits' sums run in another order (XLA's dot,
# torch's einsum), so elements agree to a few f32 ulps of their scale
TOL = dict(atol=2e-5, rtol=2e-5)


def test_chunked_static_causal_matches_jax():
    rng = np.random.default_rng(0)
    B, S, H, Hkv, Dh = 2, 64, 4, 2, 16
    q, k, v = _inputs(rng, B, S, S, H, Hkv, Dh)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(causal=True, window=0, block_q=16, static_causal=True)
    out = _torch_chunked(q, k, v, pos, pos, **kw)
    np.testing.assert_allclose(out, _jax_chunked(q, k, v, pos, pos, **kw),
                               **TOL)
    # the same rows as unchunked attention
    t = torch.from_numpy
    full = L.attention_torch(t(q), t(k), t(v), q_positions=t(pos),
                             kv_positions=t(pos)).numpy()
    np.testing.assert_allclose(out, full, **TOL)


def test_chunked_window_matches_jax():
    """A window: the loop over query blocks (static slicing is for
    window 0 in the dispatcher; here both sides take the loop)."""
    rng = np.random.default_rng(1)
    B, S, H, Hkv, Dh = 2, 48, 6, 3, 8
    q, k, v = _inputs(rng, B, S, S, H, Hkv, Dh)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(causal=True, window=7, block_q=8)
    np.testing.assert_allclose(_torch_chunked(q, k, v, pos, pos, **kw),
                               _jax_chunked(q, k, v, pos, pos, **kw), **TOL)
    # and the static slicing under a window, on both sides
    kw = dict(causal=True, window=7, block_q=8, static_causal=True)
    np.testing.assert_allclose(_torch_chunked(q, k, v, pos, pos, **kw),
                               _jax_chunked(q, k, v, pos, pos, **kw), **TOL)


def test_chunked_loop_over_any_positions_matches_jax():
    """Sq != Skv over a ring of shuffled positions with empty slots (-1)
    and a query row with no valid key."""
    rng = np.random.default_rng(2)
    B, Sq, Skv, H, Hkv, Dh = 2, 32, 40, 4, 1, 16
    q, k, v = _inputs(rng, B, Sq, Skv, H, Hkv, Dh)
    kp = np.stack([rng.permutation(Skv) for _ in range(B)]).astype(np.int32)
    kp[:, ::7] = -1
    qp = np.broadcast_to(np.arange(8, 8 + Sq, dtype=np.int32),
                         (B, Sq)).copy()
    qp[0, 0] = -1
    for causal in (True, False):
        kw = dict(causal=causal, window=0, block_q=8)
        np.testing.assert_allclose(_torch_chunked(q, k, v, qp, kp, **kw),
                                   _jax_chunked(q, k, v, qp, kp, **kw),
                                   **TOL)


def test_dispatch_takes_the_chunked_path_as_jax(monkeypatch):
    """``attention(impl="torch")`` chunks under JAX's own condition, Sq > 1
    and Sq * Skv > _CHUNK_TARGET_ELEMS (lowered here on both sides so a
    small shape passes it), and matches ``attention(impl="xla")``."""
    import jax.numpy as jnp

    import repro.engine.models.layers as jl
    monkeypatch.setattr(jl, "_CHUNK_TARGET_ELEMS", 256)
    monkeypatch.setattr(L, "_CHUNK_TARGET_ELEMS", 256)
    calls = []
    inner = L.attention_torch_chunked

    def spy(*a, **kw):
        calls.append(kw["static_causal"])
        return inner(*a, **kw)

    monkeypatch.setattr(L, "attention_torch_chunked", spy)
    rng = np.random.default_rng(3)
    B, S, H, Hkv, Dh = 1, 64, 4, 2, 8
    q, k, v = _inputs(rng, B, S, S, H, Hkv, Dh)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for window in (0, 16):
        ref = np.asarray(jl.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
            window=window, impl="xla"))
        t = torch.from_numpy
        out = L.attention(t(q), t(k), t(v), q_positions=t(pos),
                          kv_positions=t(pos), window=window,
                          impl="torch").numpy()
        np.testing.assert_allclose(out, ref, **TOL)
    assert calls == [True, False]
    # one query token is never chunked
    L.attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                torch.from_numpy(v), q_positions=torch.from_numpy(pos[:, :1]),
                kv_positions=torch.from_numpy(pos), impl="torch")
    assert len(calls) == 2


def test_chunked_loop_gradients_match_unchunked():
    """The loop path checkpoints each block under autograd: its gradients
    are the unchunked attention's."""
    rng = np.random.default_rng(4)
    B, S, H, Hkv, Dh = 2, 32, 4, 2, 8
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(rng, B, S, S, H, Hkv, Dh))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    w = torch.from_numpy(rng.normal(size=(B, S, H, Dh)).astype(np.float32))
    grads = []
    for fn in (lambda: L.attention_torch_chunked(
                   q, k, v, q_positions=pos, kv_positions=pos, window=5,
                   block_q=8),
               lambda: L.attention_torch(q, k, v, q_positions=pos,
                                         kv_positions=pos, window=5)):
        grads.append(torch.autograd.grad((fn() * w).sum(), [q, k, v]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


def test_hints_are_an_identity_without_a_mesh():
    assert L._ACT_CTX["mesh"] is None
    x = torch.randn(2, 16, 8)
    assert L.constrain_hidden(x) is x
    assert L.constrain_rows(x) is x
    assert L._constrain(x, (None, "model", None)) is x
    assert L._sp_attention_specs(x[..., None], x[..., None]) is None
    assert L._pick_q_block(64, 64) == 64
    assert L._pick_q_block(8192, 8192) == 512
    torch.testing.assert_close(L.log_sigmoid(x),
                               torch.nn.functional.logsigmoid(x),
                               atol=0, rtol=0)
    cache = torch.zeros(2, 5, 3)
    vals = torch.randn(2, 3)
    rows, slot = torch.arange(2), torch.tensor([4, 1])
    L.write_slots_(cache, rows, slot, vals)
    ref = torch.zeros(2, 5, 3)
    ref[rows, slot] = vals
    assert torch.equal(cache, ref)


# ------------------------------------------------- configs and arithmetic
@pytest.mark.parametrize("shape", list(SHAPES))
def test_shape_applicable_and_inputs_equal_jax(shape):
    from repro.configs import get_config as jax_config
    from repro.configs import input_specs
    from repro.configs.base import SHAPES as JAX_SHAPES
    from repro.configs.base import shape_applicable as jax_applicable
    skipped = set()
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert cfg.full_attention == jcfg.full_attention
        ok = shape_applicable(cfg, SHAPES[shape])
        assert ok == jax_applicable(jcfg, JAX_SHAPES[shape])
        if not ok[0]:
            skipped.add(arch)
        mine = input_shapes(cfg, SHAPES[shape])
        ref = input_specs(jcfg, JAX_SHAPES[shape])
        assert list(mine) == list(ref)
        for name, (shp, dt) in mine.items():
            assert shp == ref[name].shape
            assert str(dt).split(".")[-1] == str(ref[name].dtype)
    assert skipped == ({"deepseek-moe-16b", "whisper-tiny", "deepseek-67b",
                        "llama3.2-3b", "qwen3-1.7b", "qwen3-8b",
                        "internvl2-2b"} if shape == "long_500k" else set())


_JAX_RESIDENCY = textwrap.dedent(r"""
    import json, sys
    sys.path.insert(0, "src")
    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.launch.dryrun import _activation_residency

    class Mesh:
        def __init__(self, shape):
            self.shape = shape

    out = {}
    for m in ({"data": 16, "model": 16},
              {"pod": 2, "data": 16, "model": 16}):
        for arch in ARCH_IDS:
            for s in SHAPES:
                out[f"{arch}/{s}/{len(m)}"] = _activation_residency(
                    get_config(arch), SHAPES[s], Mesh(m))
    print(json.dumps(out))
""")


def test_activation_residency_equals_jax():
    """10 archs x 4 shapes x both production meshes; the JAX dry-run
    module forces 512 host devices when imported, so it runs in a
    subprocess."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_RESIDENCY], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(ref) == 80
    for key, val in ref.items():
        arch, s, n = key.split("/")
        mesh = dryrun.MESHES["pod16x16" if n == "2" else "pod2x16x16"]
        sizes = type("Mesh", (), {"shape": dict(zip(mesh[1], mesh[0]))})()
        assert dryrun._activation_residency(get_config(arch), SHAPES[s],
                                            sizes) == val, key


# ----------------------------------------------------------------- the CLI
_ERROR_SCRIPT = textwrap.dedent(r"""
    import json, sys
    from repro_torch.launch import dryrun

    def broken(*a, **kw):
        raise ValueError("no placement for this cell")

    dryrun.build_step = broken
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--single-pod",
                      "--out", sys.argv[1]])
    print("RC", rc)
""")


def test_cli_records_a_failing_cell_and_exits_1(tmp_path):
    """A cell that fails is written with ``status: "error"`` and its
    traceback, counted, and the CLI exits 1; the full-attention arch's
    long_500k is skipped (and not written, as in JAX)."""
    res = subprocess.run([sys.executable, "-c", _ERROR_SCRIPT,
                          str(tmp_path)], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert "RC 1" in res.stdout, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[")]
    assert sum(ln.startswith("[error") for ln in lines) == 3
    assert sum(ln.startswith("[skipped") for ln in lines) == 1
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"qwen3-1.7b__{s}__pod16x16.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
    cell = json.loads((tmp_path / files[0]).read_text())
    assert cell["status"] == "error"
    assert "no placement" in cell["error"] and "Traceback" in \
        cell["traceback"]


def _qwen3_prefill_flops_per_device() -> float:
    """qwen3-1.7b's prefill at prefill_32k, per device of 256: the
    projections and FFNs of every token, the head at the last position,
    and the static causal attention of 16 blocks of 2048 queries (block
    i reads (i + 1) * 2048 keys; the sequence-parallel budget is 16 x 4M
    logits, so bq = 2048)."""
    c = get_config("qwen3-1.7b")
    d, H, Hkv, Dh = c.d_model, c.num_heads, c.num_kv_heads, \
        c.resolved_head_dim
    B, S, L_ = 32, 32768, c.num_layers
    proj = 2 * B * S * L_ * (d * H * Dh + 2 * d * Hkv * Dh + H * Dh * d
                             + 3 * d * c.d_ff)
    head = 2 * B * d * c.padded_vocab
    bq, nq = 2048, 16
    attn = L_ * 4 * B * H * Dh * bq * bq * nq * (nq + 1) // 2
    return (proj + head + attn) / 256


def test_full_size_cells_on_a_fake_256_rank_group(tmp_path):
    """Full width on the 16 x 16 mesh: qwen3-1.7b at prefill_32k counts,
    per device, exactly the FLOPs of the arithmetic above, 1.98x
    ``model_flops / 256`` (attention at 32k is 59% of it, and
    ``model_flops`` counts 2 N a token); recurrentgemma-2b at prefill_32k
    (26 scans of 32768 steps, counted as one step each through
    ``steps``) finishes inside the subprocess's limit."""
    from repro_torch.launch.roofline import model_flops
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--shape",
         "prefill_32k", "--single-pod", "--out", str(tmp_path), "--arch",
         "qwen3-1.7b"], env=_env(), capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    cell = json.loads(
        (tmp_path / "qwen3-1.7b__prefill_32k__pod16x16.json").read_text())
    assert cell["status"] == "ok" and cell["devices"] == 256
    assert cell["flops"] == _qwen3_prefill_flops_per_device()
    ratio = cell["flops"] / (model_flops("qwen3-1.7b", "prefill_32k") / 256)
    assert 1.9 < ratio < 2.05, ratio
    assert cell["hbm_fit"] and cell["collectives"]["collective_count"] > 0
    assert cell["memory"]["argument_bytes"] > 0
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--shape",
         "prefill_32k", "--single-pod", "--out", str(tmp_path), "--arch",
         "recurrentgemma-2b"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    hyb = json.loads((tmp_path / "recurrentgemma-2b__prefill_32k__pod16x16"
                      ".json").read_text())
    assert hyb["status"] == "ok" and hyb["flops"] > 0
