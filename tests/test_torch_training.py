"""The port's training substrate (``repro_torch.training``) against the JAX
package's.

* ``cosine_lr`` and one ``adamw_update`` from a bridged optimizer state
  equal JAX's within 1e-6 (parameters, moments, learning rate, gradient
  norm), with clipping on and off;
* ``make_train_step`` with ``grad_accum=2`` (float32 sums of the
  microbatches' gradients) equals JAX's step on bridged weights, and with
  ``grad_accum=1`` too;
* compressed gradients: the int8 values and scales equal JAX's;
* the ports of ``tests/test_training.py``: the loss falls and the run
  resumes, the checkpoint round trip is exact, the commit is atomic, the
  error feedback reconstructs the gradient, the data is deterministic,
  the schedule has its shape;
* the launcher with ``--device cpu`` exits 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa
from repro.training.grad_compress import (  # noqa: E402
    compress_tree as jax_compress_tree)
from repro.training.optimizer import adamw_update as jax_adamw_update  # noqa
from repro.training.optimizer import cosine_lr as jax_cosine_lr  # noqa
from repro_torch.bridge import opt_state_from_jax, params_from_jax  # noqa
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.training import (AdamWConfig, DataConfig,  # noqa: E402
                                  SyntheticLMData, TrainerConfig,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint, train_loop)
from repro_torch.training import trainer as trainer_mod  # noqa: E402
from repro_torch.training.checkpoint import latest_checkpoint  # noqa: E402
from repro_torch.training.grad_compress import (  # noqa: E402
    compress_tree, decompress_tree, init_error_state)
from repro_torch.training.optimizer import (adamw_init, adamw_update,  # noqa
                                            cosine_lr)

from test_torch_train_models import _f32, batch_for  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, tol=1e-6):
    a = t.detach().float().numpy()
    b = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 130])
def test_cosine_lr_equals_jax(step):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JaxAdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(cosine_lr(cfg, step)) == pytest.approx(
        float(jax_cosine_lr(jcfg, jnp.int32(step))), rel=1e-6, abs=1e-12)


def _random_state(rng, params):
    """A JAX AdamW state three steps in: moments drawn from ``rng``."""
    m = jax.tree.map(lambda p: jnp.asarray(
        0.01 * rng.normal(size=p.shape), jnp.float32), params)
    v = jax.tree.map(lambda p: jnp.asarray(
        1e-4 * rng.random(size=p.shape), jnp.float32), params)
    return {"m": m, "v": v, "step": jnp.int32(3)}


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_equals_jax_from_a_bridged_state(clip):
    jcfg, cfg = _f32("qwen3-1.7b")
    rng = np.random.default_rng(0)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jg = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape),
                                            jnp.float32), jp)
    jstate = _random_state(rng, jp)
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=20, grad_clip=clip)
    jp2, jstate2, jmet = jax_adamw_update(JaxAdamWConfig(**kw), jp, jg,
                                          jstate)
    params = params_from_jax(_np(jp), cfg)
    grads = params_from_jax(_np(jg), cfg)
    state = opt_state_from_jax(_np(jstate), cfg)
    params, state, met = adamw_update(AdamWConfig(**kw), params, grads,
                                      state)
    for got, want in ((params, jp2), (state["m"], jstate2["m"]),
                      (state["v"], jstate2["v"])):
        want = params_from_jax(_np(want), cfg, dtype=torch.float32)
        for name, t in got.items():
            _close(t, want[name].numpy())
    assert int(state["step"]) == int(jstate2["step"]) == 4
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-6)


def test_adamw_keeps_f32_moments_and_the_parameter_dtype():
    p = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st["m"]["w"].dtype == torch.float32 and int(st["step"]) == 0
    g = {"w": torch.full((4, 3), 0.5, dtype=torch.bfloat16)}
    p, st, _ = adamw_update(AdamWConfig(), p, g, st)
    assert p["w"].dtype == torch.bfloat16 and st["v"]["w"].dtype == \
        torch.float32 and int(st["step"]) == 1


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_equals_jax(grad_accum):
    """One step of each package on the same weights, optimizer state and
    batch: the loss, the gradient norm and the updated parameters (the
    microbatches' gradients summed in float32 and divided by their count).
    The state is three steps in: from zero moments the first step divides
    each gradient by its own magnitude, which turns the rounding of a
    near-zero gradient into a whole learning rate."""
    jcfg, cfg = _f32("qwen3-1.7b")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    jstate = _random_state(np.random.default_rng(6), jp)
    nb = batch_for(cfg, seed=4)
    adamw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax_make_train_step(jcfg, JaxTrainerConfig(
        remat=False, grad_accum=grad_accum, adamw=JaxAdamWConfig(**adamw)))
    jp2, _, jmet = jstep(jp, jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(_np(jp), cfg))
    tm.requires_grad_(True)
    step = make_train_step(tm, TrainerConfig(
        remat=True, grad_accum=grad_accum, adamw=AdamWConfig(**adamw)))
    state = opt_state_from_jax(_np(jstate), cfg)
    state, met = step(state, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-4)
    want = params_from_jax(_np(jp2), cfg)
    for name, p in tm.named_parameters():
        _close(p, want[name].numpy(), tol=1e-5)


def test_grad_accum_sums_in_float32_not_in_the_parameter_dtype(monkeypatch):
    """bf16 parameters: the step's gradient is the float32 mean of the
    microbatches' gradients, as two calls of ``loss_and_grads`` give it."""
    _, cfg = _f32("qwen3-1.7b")
    cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    tm = build_model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tm.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch_for(cfg, seed=5).items()}
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
              for i in range(2)]
    g = [trainer_mod.loss_and_grads(tm, h)[1] for h in halves]
    want = {n: (g[0][n].float() + g[1][n].float()) / 2 for n in g[0]}
    seen = {}

    def spy(cfg_, params, grads, state):
        seen.update(grads)
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(trainer_mod, "adamw_update", spy)
    step = make_train_step(tm, TrainerConfig(remat=False, grad_accum=2))
    step(adamw_init(dict(tm.named_parameters())), tb)
    for n, w in want.items():
        assert seen[n].dtype == torch.float32
        assert torch.equal(seen[n], w), n


def test_compressed_gradients_equal_jax():
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(64, 32)).astype(np.float32),
         "b": (rng.normal(size=(17,)) * 1e-3).astype(np.float32),
         "z": np.zeros((5,), np.float32)}
    # halves on the grid: round half to even in both packages
    g["h"] = (np.arange(-6, 7, dtype=np.float32) + 0.5) * (6.5 / 127.0)
    jq, js, je = jax_compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                                   {k: jnp.zeros_like(jnp.asarray(v))
                                    for k, v in g.items()})
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    q, s, e = compress_tree(tg, init_error_state(tg))
    for k in g:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        assert float(s[k]) == float(js[k])
        np.testing.assert_array_equal(e[k].numpy(), np.asarray(je[k]))


# ------------------------------------------------ ports of test_training.py

def test_loss_decreases_and_resumes(tmp_path):
    cfg = get_smoke("qwen3-1.7b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                      structure=0.9)
    tcfg = TrainerConfig(remat=False, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=3, total_steps=30))
    out = train_loop(cfg, tcfg, dcfg, num_steps=12, ckpt_dir=str(tmp_path),
                     ckpt_every=6, log_every=4, device="cpu")
    assert out["losses"][-1][1] < out["losses"][0][1]
    out2 = train_loop(cfg, tcfg, dcfg, num_steps=14, ckpt_dir=str(tmp_path),
                      ckpt_every=6, log_every=1, device="cpu")
    assert out2["losses"][0][0] >= 12          # resumed, not restarted


def test_resumed_steps_equal_the_continuous_run(tmp_path):
    """Steps 4 and 5 after a resume at step 4 equal the continuous run's:
    the weights, the moments and the step counter come back exactly, and
    the data is a function of the step."""
    cfg = get_smoke("qwen3-1.7b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=10))
    full = train_loop(cfg, tcfg, dcfg, num_steps=6, device="cpu")
    train_loop(cfg, tcfg, dcfg, num_steps=4, ckpt_dir=str(tmp_path),
               ckpt_every=4, device="cpu")
    resumed = train_loop(cfg, tcfg, dcfg, num_steps=6,
                         ckpt_dir=str(tmp_path), device="cpu")
    assert [r["step"] for r in resumed["history"]] == [4, 5]
    assert [r["loss"] for r in resumed["history"]] == \
        [r["loss"] for r in full["history"][4:]]


def test_checkpoint_roundtrip_exact(tmp_path):
    cfg = get_smoke("xlstm-350m")
    model = build_model(cfg, device="cpu").init(torch.Generator()
                                                .manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    opt["m"] = {n: torch.randn_like(t) for n, t in opt["m"].items()}
    d = save_checkpoint(str(tmp_path), 7, params, opt, extra={"k": 1})
    step, p2, o2, extra = load_checkpoint(d, (params, opt))
    assert step == 7 and extra == {"k": 1}
    for n, t in params.items():
        assert p2[n].dtype == t.dtype and torch.equal(p2[n], t.detach())
    for n, t in opt["m"].items():
        assert torch.equal(o2["m"][n], t)
    assert int(o2["step"]) == 0


def test_checkpoint_atomicity(tmp_path):
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg, device="cpu").init(torch.Generator()
                                                .manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    save_checkpoint(str(tmp_path), 1, params, opt)
    save_checkpoint(str(tmp_path), 2, params, opt)
    # a leftover temporary directory (a writer killed mid-save) is not read
    (tmp_path / ".ckpt_tmp_x").mkdir()
    (tmp_path / "step_000000003").mkdir()      # never committed
    latest = latest_checkpoint(str(tmp_path))
    assert latest.endswith("step_000000002")


def test_grad_compress_error_feedback_exact():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))}
    err = init_error_state(g)
    q, s, err2 = compress_tree(g, err)
    deq = decompress_tree(q, s)
    assert q["w"].dtype == torch.int8
    # dequantized + residual reconstructs the corrected gradient exactly
    np.testing.assert_allclose((deq["w"] + err2["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)
    # 2 rounds: the residual shrinks the long-run bias
    q2, s2, _ = compress_tree(g, err2)
    deq2 = decompress_tree(q2, s2)
    two_round = ((deq["w"] + deq2["w"]) / 2).numpy()
    target = g["w"].numpy()
    assert np.abs(two_round - target).mean() <= \
        np.abs(deq["w"].numpy() - target).mean() + 1e-7


def test_data_determinism_and_sharding():
    dcfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    data = SyntheticLMData(dcfg)
    a, b = data.batch_at(5), data.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(data.batch_at(6)["tokens"], a["tokens"])
    h0 = data.batch_at(5, host_id=0, num_hosts=2)
    h1 = data.batch_at(5, host_id=1, num_hosts=2)
    assert h0["tokens"].shape[0] == 4
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_lr(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]                 # warmup ascends
    assert lrs[2] >= lrs[3] >= lrs[4]               # cosine descends
    assert lrs[4] >= 0.1 * 1e-3 - 1e-9


def test_launcher_on_the_cpu_exits_0(tmp_path, capsys):
    rc = train_launcher.main(["--arch", "qwen3-1.7b", "--steps", "12",
                              "--seq", "32", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    assert "device=cpu" in capsys.readouterr().out
    assert latest_checkpoint(str(tmp_path)).endswith("step_000000012")
