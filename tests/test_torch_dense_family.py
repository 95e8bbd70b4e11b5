"""The rest of the port's dense family against the JAX package, on the CPU.

``qwen3-8b`` (four query heads per KV head, qk-norm, an untied head),
``llama3.2-3b`` (three query heads per KV head, no qk-norm, tied) and
``deepseek-67b`` (eight query heads per KV head, no qk-norm, untied) need
no code of their own: the smoke configs in float32 run through the port's
``TransformerLM`` (logits within 1e-4 of JAX's on bridged weights) and
its ``InferenceEngine`` (the JAX engine's greedy tokens, request for
request, on the paged path and on the dense view, with a prefix-sharing
pair, a duplicate and a request admitted mid-decode).  The analytic
parameter counts of every ported arch, and the cost model's profile
built on them, equal the JAX package's.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402

DENSE = ("qwen3-8b", "llama3.2-3b", "deepseek-67b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-8b", "llama3.2-3b",
                                  "deepseek-moe-16b", "recurrentgemma-2b",
                                  "internvl2-2b", "xlstm-350m",
                                  "whisper-tiny", "mixtral-8x22b",
                                  "deepseek-67b"])
def test_param_counts_equal_jax(arch):
    """The counts, and the cost model's profile built on them (resident
    bytes, active parameters per token), equal the JAX package's."""
    from repro.core.cost_model import profile_from_config as jax_profile
    from repro_torch.core.cost_model import profile_from_config
    assert arch in ARCH_IDS
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke(arch), jax_smoke(arch))):
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert vars(profile_from_config(mine)) == vars(jax_profile(ref))
    if arch == "deepseek-moe-16b":
        full = get_config(arch)
        assert 16.3e9 < full.param_count() < 16.5e9
        assert full.active_param_count() < full.param_count() / 5
    if arch in ("mixtral-8x22b", "deepseek-67b"):
        # more than one 80 GB card holds in bf16 at full depth
        assert get_config(arch).param_count() * 2 > 80e9


@pytest.fixture(scope="module", params=DENSE)
def weights(request):
    arch = request.param
    eng = JaxEngine(jax_smoke(arch).replace(dtype="float32"), seed=0)
    eng.load()
    cfg = get_smoke(arch).replace(dtype="float32")
    return arch, eng, cfg, params_from_jax(
        jax.tree.map(np.asarray, eng.params), cfg)


def test_bridge_and_logits_match_jax(weights):
    arch, jeng, cfg, sd = weights
    assert ("lm_head" in sd) == (not cfg.tie_embeddings) \
        == (arch in ("qwen3-8b", "deepseek-67b"))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(sd)
    jm = jax_build(jax_smoke(arch).replace(dtype="float32"))
    toks = np.random.default_rng(4).integers(0, 256, (2, 11)).astype(
        np.int32)
    jl, _ = jm.forward(jeng.params, jnp.asarray(toks))
    tl, aux = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert float(aux) == 0.0


PREFIX = list(range(10, 30))                     # 20 tokens: 2.5 pages
PROMPTS = [PREFIX + [100, 101], PREFIX + [102], list(range(40, 53)),
           PREFIX + [100, 101]]                  # the last a duplicate
LONG, SHORT = list(range(60, 71)), [5, 6, 7, 8]
STATS = ("prefix_hits", "tokens_reused", "pages_shared",
         "coalesced_requests", "prefill_tokens", "prefill_tokens_saved")


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


def _scenario(eng):
    out = {"fresh": eng.generate(PROMPTS, max_new_tokens=5)}
    out["warm"] = eng.generate(PROMPTS, max_new_tokens=5)
    out["stats"] = {k: getattr(eng.stats, k) for k in STATS}
    n0 = eng.stats.decode_tokens
    h1 = eng.submit(LONG, max_new_tokens=16)
    _wait(lambda: eng.stats.decode_tokens > n0)
    h2 = eng.submit(SHORT, max_new_tokens=4)
    out["mid"] = (h1.result(), h2.result())
    return out


@pytest.fixture(scope="module")
def jax_run(weights):
    eng = weights[1]
    try:
        return _scenario(eng)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [True, False])
def test_greedy_tokens_equal_jax(weights, jax_run, paged):
    """The dense family's tokens do not depend on prefix sharing: warm
    equals fresh, on both arms, and both equal the JAX engine's."""
    _, _, cfg, sd = weights
    eng = InferenceEngine(cfg, seed=0, device="cpu", paged_decode=paged)
    eng.load(sd)
    try:
        out = _scenario(eng)
        assert out == jax_run
        assert out["warm"] == out["fresh"]
        assert out["fresh"][0] == out["fresh"][3]
        assert out["stats"]["prefix_hits"] >= 4
        assert out["stats"]["coalesced_requests"] >= 2
        assert (eng.stats.view_rebuilds == 0) == paged
    finally:
        eng.shutdown()
