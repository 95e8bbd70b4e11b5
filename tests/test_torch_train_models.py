"""Each family's training loss and gradients in the port against JAX's.

For every family's smoke config in float32 (qwen3 dense, deepseek-moe,
internvl2 with ``patch_embeds``, the recurrentgemma hybrid, xlstm, and
whisper with ``frames``) the JAX init is bridged into the port, a batch of
``SyntheticLMData`` tokens (plus patches or frames drawn from a numpy
seed) goes through JAX's ``loss_fn`` under ``jax.value_and_grad`` and
through the port's ``loss_fn`` under autograd (on the CPU the flash and
scan ``Function``s run their plain versions):

* the losses agree within 1e-5 relative;
* every gradient leaf, mapped through the bridge, agrees within 1e-4 of
  its norm (sums run in other orders in the two packages);
* rematerialization does not change the port's gradients (bitwise on the
  CPU: the recompute runs the same ops in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticLMData  # noqa
from repro_torch.training.trainer import loss_and_grads  # noqa: E402

ARCHS = ("qwen3-1.7b", "deepseek-moe-16b", "internvl2-2b",
         "recurrentgemma-2b", "xlstm-350m", "whisper-tiny")
B, S = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(arch):
    return (jax_smoke(arch).replace(dtype="float32", param_dtype="float32"),
            get_smoke(arch).replace(dtype="float32", param_dtype="float32"))


def batch_for(cfg, seed=0, batch=B, seq=S):
    """A numpy batch: SyntheticLMData tokens, and the family's stub
    frontend input (patch embeddings, frames) from a numpy seed."""
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch,
                                      seed=seed))
    out = data.batch_at(3)
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(batch, cfg.enc_max_len, cfg.d_model)).astype(np.float32)
    return out


def models(arch, seed=0):
    jcfg, cfg = _f32(arch)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    tm.requires_grad_(True)
    return jm, jp, tm, cfg


def _grads_close(grads, jgrads, cfg, tol=1e-4):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                           dtype=torch.float32)
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name]
        scale = float(torch.linalg.vector_norm(w))
        diff = float((g.float() - w).abs().max())
        assert diff <= tol * max(scale, 1e-6), (name, diff, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(arch):
    jm, jp, tm, cfg = models(arch)
    nb = batch_for(cfg)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = loss_and_grads(
        tm, {k: torch.from_numpy(v) for k, v in nb.items()}, remat=True)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(grads, jgrads, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_does_not_change_the_gradients(arch):
    _, _, tm, cfg = models(arch, seed=1)
    tb = {k: torch.from_numpy(v) for k, v in batch_for(cfg, seed=1).items()}
    loss0, g0 = loss_and_grads(tm, tb, remat=False)
    loss1, g1 = loss_and_grads(tm, tb, remat=True)
    assert torch.equal(loss0, loss1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_every_parameter_of_each_family_gets_a_gradient():
    """No leaf is cut off from the loss (a kernel without a backward would
    leave its inputs' weights at zero gradient)."""
    for arch in ("qwen3-1.7b", "recurrentgemma-2b"):
        _, _, tm, cfg = models(arch, seed=2)
        tb = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
        _, grads = loss_and_grads(tm, tb)
        zero = [n for n, g in grads.items() if float(g.abs().max()) == 0.0]
        assert not zero, (arch, zero)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m",
                                  "whisper-tiny"])
def test_loss_mask_is_shifted_where_the_jax_loss_fails(arch):
    """The JAX hybrid, xLSTM and whisper losses hand the (B, S) mask to a
    cross-entropy over S-1 positions, which fails on the shapes (ROADMAP
    Queue 3 item 11); the port shifts it as the transformer's loss does:
    its loss equals JAX's masked cross-entropy of JAX's logits."""
    from repro.engine.models.layers import cross_entropy as jax_ce
    jm, jp, tm, cfg = models(arch, seed=3)
    nb = batch_for(cfg, seed=3)
    nb["loss_mask"] = (np.random.default_rng(9).random(
        nb["tokens"].shape) > 0.3).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    with pytest.raises((TypeError, ValueError)):
        jm.loss_fn(jp, jb)
    args = (jb["frames"],) if "frames" in jb else ()
    logits, _ = jm.forward(jp, jb["tokens"], *args)
    want = jax_ce(logits[:, :-1], jb["labels"][:, 1:], cfg.vocab_size,
                  mask=jb["loss_mask"][:, 1:])
    with torch.no_grad():
        got = tm.loss_fn({k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
