"""The port's op-cost counter (``repro_torch.launch.op_cost``): dot FLOPs,
trip counts through ``steps``, score-class bytes and collective bytes,
and its FLOPs against the JAX package's HLO analyzer.

Bytes are held to JAX's only where noted: the port counts an eager op's
operands and result, XLA a fusion's, so the two differ by design."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.cost_hooks import active, steps, steps_out  # noqa: E402
from repro_torch.launch.op_cost import OpCounter, analyze_ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta",
                       requires_grad=grad)


# ------------------------------------------------- the cases of test_hlo_cost
def test_dot_flops_exact():
    r = analyze_ops(lambda a, b: a @ b, meta(128, 256), meta(256, 64))
    assert r["flops"] == 2 * 128 * 256 * 64
    # one kernel: both operands read, the result written
    assert r["bytes"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)
    bmm = analyze_ops(torch.bmm, meta(3, 8, 16), meta(3, 16, 4))
    assert bmm["flops"] == 2 * 3 * 8 * 16 * 4
    addmm = analyze_ops(torch.addmm, meta(4), meta(8, 16), meta(16, 4))
    assert addmm["flops"] == 2 * 8 * 16 * 4


def test_scan_body_trip_multiplication():
    def scan10(a):
        for _ in steps(10):
            a = a @ a
        return a

    r10 = analyze_ops(scan10, meta(512, 512))
    r1 = analyze_ops(lambda a: a @ a, meta(512, 512))
    assert r10["flops"] == 10 * r1["flops"]
    assert r10["bytes"] == 10 * r1["bytes"]


def test_nested_steps_multiply():
    def nested(a):
        for _ in steps(4):
            for _ in steps(3):
                a = a @ a
        return a

    r = analyze_ops(nested, meta(256, 256))
    one = analyze_ops(lambda a: a @ a, meta(256, 256))
    assert r["flops"] == 12 * one["flops"]


def test_steps_is_range_without_a_counter():
    assert active() is None
    assert steps(5) == range(5)
    assert steps_out([1, 2, 3], 3) == [1, 2, 3]
    with pytest.raises(ValueError):
        steps_out([1], 3)


def test_steps_backward_is_multiplied():
    """A loop's backward FLOPs under ``steps`` are the loop over range(n)'s
    when every step differentiates the same operands (here the carry's
    start needs grad, as every later carry does).  Its bytes are not: the
    one step's nodes do not see the gradient sums between steps."""
    w = meta(64, 64, grad=True)
    h0 = meta(8, 64, grad=True)

    def loop(it):
        h, hs = h0, []
        for _ in it:
            h = torch.tanh(h @ w)
            hs.append(h)
        return hs

    def counted():
        hs = steps_out(loop(steps(10)), 10)
        return torch.autograd.grad(torch.stack(hs, 1).sum(), [w, h0])

    def plain():
        hs = loop(range(10))
        return torch.autograd.grad(torch.stack(hs, 1).sum(), [w, h0])

    a, b = analyze_ops(counted), analyze_ops(plain)
    assert a["flops"] == b["flops"] == 3 * 10 * 2 * 8 * 64 * 64


def test_score_class_separation():
    """rank-4 f32 with a score-dim trailing axis goes to score_bytes"""
    def attn_like(q, k):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)   # (B,H,Sq,Skv)
        return s.sum()

    q, k = meta(2, 64, 4, 32), meta(2, 2048, 4, 32)
    r = analyze_ops(attn_like, q, k, score_dims={2048})
    assert r["score_bytes"] > 0
    assert r["bytes"] < r["bytes_xla_path"]
    assert r["bytes_xla_path"] == r["bytes"] + r["score_bytes"]
    none = analyze_ops(attn_like, q, k)
    assert none["score_bytes"] == 0
    assert none["bytes"] == r["bytes_xla_path"]


def test_views_are_free_and_gathers_count_their_slice():
    x = meta(64, 128)
    r = analyze_ops(lambda t: t.view(128, 64).t().expand(2, 64, 128)[0, :3],
                    x)
    assert r["flops"] == r["bytes"] == 0
    idx = meta(10, dtype=torch.int64)
    g = analyze_ops(lambda t, i: t[i], x, idx)
    assert g["bytes"] == 2 * 10 * 128 * 4


def test_partial_writes_count_what_is_written():
    cache = meta(8, 1024, 2, 16)
    rows, slots = meta(8, dtype=torch.int64), meta(8, dtype=torch.int64)
    vals = meta(8, 2, 16)

    def write(c, r, s, v):
        c[r, s] = v

    w = analyze_ops(write, cache, rows, slots, vals)
    assert w["bytes"] == 2 * (8 * 8 + 8 * 8 + 8 * 2 * 16 * 4)
    out = meta(4, 6)
    c = analyze_ops(lambda o, v: o[:, 2].copy_(v), out, meta(4))
    assert c["bytes"] == 2 * 4 * 4


def test_host_tensors_are_not_counted():
    """Host bookkeeping (an optimizer's step counter, DTensor's integer
    shard offsets) runs uncounted, and a meta op beside a host scalar is
    counted; any other tensor that holds data raises, so ``analyze_ops``
    never returns a count of zero for real work."""
    step = torch.tensor(3.0)
    r = analyze_ops(lambda s: s.add_(1), step)
    assert r["flops"] == r["bytes"] == 0 and step.item() == 4.0
    o = analyze_ops(lambda: torch.arange(64) * 16 + 3)
    assert o["flops"] == o["bytes"] == 0
    e = analyze_ops(lambda: torch.empty((0,), requires_grad=True))
    assert e["flops"] == e["bytes"] == 0
    s = analyze_ops(lambda a, b: a * b, meta(4, 4), torch.tensor(2.0))
    assert s["bytes"] == 4 * 4 * 4 * 2 + 4
    with pytest.raises(RuntimeError, match="meta tensors only"):
        analyze_ops(lambda a: a @ a, torch.ones(4, 4))
    with pytest.raises(RuntimeError, match="meta tensors only"):
        analyze_ops(lambda: torch.zeros(4, 4))


# -------------------------------------------------- hand kernels on meta
def test_flash_kernel_on_meta_charges_its_traffic():
    """The flash wrapper on meta tensors launches nothing: it gives the
    output's shape and charges its kernel's work, each input read once
    and each output written once, QK^T and PV (and in the backward five
    products) over the pairs the causal mask leaves."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    B, S, H, Hkv, Dh = 2, 64, 4, 2, 64
    q = meta(B, S, H, Dh, dtype=torch.bfloat16)
    k = meta(B, S, Hkv, Dh, dtype=torch.bfloat16)
    pos = meta(B, S, dtype=torch.int32)
    pairs = S * (S + 1) // 2
    r = analyze_ops(lambda: fa_ops.flash_attention(
        q, k, k, q_positions=pos, kv_positions=pos))
    assert r["flops"] == 4 * Dh * H * B * pairs
    assert r["bytes"] == 2 * q.numel() * 2 + 2 * k.numel() * 2 + 2 * B * S * 4
    lse = meta(B, H, S)
    g = analyze_ops(lambda: fa_ops.flash_attention_bwd(
        q, k, k, q, lse, q_positions=pos, kv_positions=pos))
    assert g["flops"] == 10 * Dh * H * B * pairs
    assert g["bytes"] == 3 * q.numel() * 2 + 4 * k.numel() * 2 \
        + lse.numel() * 4 + 2 * B * S * 4
    w = analyze_ops(lambda: fa_ops.flash_attention(
        q, k, k, q_positions=pos, kv_positions=pos, window=16))
    assert w["flops"] == 4 * Dh * H * B * (16 * 17 // 2 + (S - 16) * 16)


def test_paged_kernel_on_meta_charges_the_named_slots():
    """On meta the lengths are unknown: the paged kernel charges every
    slot its table names, K and V, beside q, the output, m and l, the
    table and the lengths, and (fused) the new K/V read and written."""
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops
    B, H, Hkv, Dh, ps, n_pages = 3, 8, 2, 64, 8, 5
    q = meta(B, 1, H, Dh, dtype=torch.bfloat16)
    pool = meta(B * n_pages, ps, Hkv, Dh)
    pt, lens = meta(B, n_pages, dtype=torch.int32), meta(B, dtype=torch.int32)
    new = meta(B, Hkv, Dh)
    slots = B * n_pages * ps
    attend = 2 * slots * Hkv * Dh * 4 + 2 * q.numel() * 2 + 2 * B * H * 4 \
        + 4 * (pt.numel() + B)
    r = analyze_ops(lambda: pd_ops.paged_decode_attention(
        q, pool, pool, pt, lens))
    assert r["flops"] == 4 * H * Dh * slots and r["bytes"] == attend
    f = analyze_ops(lambda: pd_ops.fused_paged_decode_attention(
        q, pool, pool, pt, lens, new, new))
    assert f["bytes"] == attend + 2 * 2 * new.numel() * 4
    out = pd_ops.fused_paged_decode_attention(q, pool, pool, pt, lens, new,
                                              new)[0]
    assert out.shape == q.shape and out.device.type == "meta"


def test_kernel_charges_multiply_in_steps():
    from repro_torch import cost_hooks

    def loop():
        for _ in steps(7):
            cost_hooks.charge(10.0, 3.0)

    r = analyze_ops(loop)
    assert r["flops"] == 70.0 and r["bytes"] == 21.0
    cost_hooks.charge(1.0, 1.0)          # no counter: nothing to charge
    assert cost_hooks.visible_pairs(4, 6, False, 0) == 24
    assert cost_hooks.visible_pairs(4, 6, True, 0) == 1 + 2 + 3 + 4
    assert cost_hooks.visible_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2


def test_counter_is_an_infra_mode():
    assert OpCounter.is_infra_mode()


# ------------------------------------------------------------- against JAX
def _jax_flops(fn, *shapes):
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_cost import analyze_hlo
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def test_flops_equal_jax_on_unit_functions():
    """FLOPs equal the JAX analyzer's exactly: one matmul, a two-layer
    MLP, a 10-step scan (``lax.scan`` there, ``steps`` here)."""
    import jax
    from jax import lax

    j = _jax_flops(lambda a, b: a @ b, (128, 256), (256, 64))
    assert analyze_ops(lambda a, b: a @ b, meta(128, 256),
                       meta(256, 64))["flops"] == j

    def mlp_j(x, w1, w2):
        return jax.nn.gelu(x @ w1) @ w2

    def mlp_t(x, w1, w2):
        return torch.nn.functional.gelu(x @ w1) @ w2

    shapes = ((32, 64), (64, 256), (256, 48))
    assert analyze_ops(mlp_t, *(meta(*s) for s in shapes))["flops"] \
        == _jax_flops(mlp_j, *shapes)

    def scan_j(a, w):
        def body(c, _):
            return jax.numpy.tanh(c @ w), None
        return lax.scan(body, a, None, length=10)[0]

    def scan_t(a, w):
        for _ in steps(10):
            a = torch.tanh(a @ w)
        return a

    assert analyze_ops(scan_t, meta(16, 128), meta(128, 128))["flops"] \
        == _jax_flops(scan_j, (16, 128), (128, 128))


# -------------------------------------------------------------- collectives
_COLL_SCRIPT = textwrap.dedent(r"""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import analyze_ops
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")

    def dt(shape, placements):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 placements, src_data_rank=None)

    out = {}
    x = dt((64, 32), (Replicate(), Shard(0)))
    out["gather"] = analyze_ops(
        lambda: x.redistribute(mesh, (Replicate(), Replicate())))
    p = dt((64, 32), (Replicate(), Partial()))
    out["reduce"] = analyze_ops(
        lambda: p.redistribute(mesh, (Replicate(), Replicate())))
    out["scatter"] = analyze_ops(
        lambda: p.redistribute(mesh, (Replicate(), Shard(0))))
    y = dt((64, 32), (Replicate(), Shard(0)))
    out["alltoall"] = analyze_ops(
        lambda: y.redistribute(mesh, (Replicate(), Shard(1))))
    print(json.dumps(out))
""")


def test_collective_bytes_are_their_result_sizes():
    """On an 8-rank fake mesh (2 x 4) a (64, 32) f32 tensor: the all-gather
    of its 4 row shards, the all-reduce of a partial sum, its
    reduce-scatter, and a row-to-column reshard, which must be counted as
    the all-to-all it is (DTensor gathers instead on a "cpu" mesh)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _COLL_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    import json
    out = json.loads(res.stdout.strip().splitlines()[-1])
    full = 64 * 32 * 4
    assert out["gather"]["coll_all-gather"] == full
    assert out["reduce"]["coll_all-reduce"] == full
    assert out["scatter"]["coll_reduce-scatter"] == full // 4
    assert out["alltoall"]["coll_all-to-all"] == full // 4
    assert "coll_all-gather" not in out["alltoall"]
    for r in out.values():
        assert r["collective_count"] == 1
        assert r["flops"] == 0


# --------------------------------------------- the families against JAX
_FAMILIES = {"dense": "qwen3-1.7b", "moe": "deepseek-moe-16b",
             "vlm": "internvl2-2b", "hybrid": "recurrentgemma-2b",
             "ssm": "xlstm-350m", "audio": "whisper-tiny"}
_B, _S = 2, 32

_FAMILY_SCRIPT = textwrap.dedent(r"""
    import json, sys
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.engine.models.layers import set_activation_sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import analyze_ops
    archs, B, S = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    dryrun.fake_group(1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    out = {}
    for arch in archs:
        for kind in ("prefill", "decode", "train"):
            for remat in ((True, False) if kind == "train" else (True,)):
                step, _ = dryrun.build_step(
                    get_smoke(arch), ShapeSpec("smoke", S, B, kind), mesh,
                    remat=remat)
                with implicit_replication():
                    r = analyze_ops(step)
                set_activation_sharding(None)
                out[f"{arch}/{kind}/{remat}"] = r["flops"]
    print(json.dumps(out))
""")


def _jax_step_flops(arch, kind):
    """The JAX package's step, as its dry run builds it, compiled on one
    host device: ``analyze_hlo``'s FLOPs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.engine.models import build_model
    from repro.launch.hlo_cost import analyze_hlo
    from repro.training.optimizer import AdamWConfig, adamw_init
    from repro.training.trainer import TrainerConfig, make_train_step
    cfg = get_smoke(arch)
    model = build_model(cfg)
    p = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    tok = jax.ShapeDtypeStruct((_B, _S), jnp.int32)
    bf16 = jnp.bfloat16
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = jax.ShapeDtypeStruct(
            (_B, min(cfg.enc_max_len, _S), cfg.d_model), bf16)
    if cfg.family == "vlm":
        extra["patch_embeds"] = jax.ShapeDtypeStruct(
            (_B, cfg.num_patches, cfg.d_model), bf16)
    if kind == "train":
        step = make_train_step(cfg, TrainerConfig(
            remat=True, adamw=AdamWConfig(total_steps=1000)))
        args = (p, jax.eval_shape(adamw_init, p),
                {"tokens": tok, "labels": tok, **extra})
    elif kind == "prefill":
        if cfg.family == "audio":
            def step(p, t, f):
                return model.prefill(p, t, f)
            args = (p, tok, extra["frames"])
        elif cfg.family == "vlm":
            def step(p, t, pe):
                return model.prefill(p, t, prefix_embeds=pe)
            args = (p, tok, extra["patch_embeds"])
        else:
            def step(p, t):
                return model.prefill(p, t)
            args = (p, tok)
    else:
        def step(p, t, c):
            return model.decode_step(p, t, c)
        args = (p, jax.ShapeDtypeStruct((_B,), jnp.int32),
                jax.eval_shape(lambda: model.init_cache(_B, _S)))
    txt = jax.jit(step).lower(*args).compile().as_text()
    return analyze_hlo(txt)["flops"]


# (prefill, decode, train) relative tolerance of the port's FLOPs to JAX's
_TOL = {"ssm": (2e-3, 2e-3, 4e-2)}


def test_family_step_flops_equal_jax():
    """Each family's smoke config, B=2, S=32: the port's prefill, decode
    and train step (``dryrun.build_step`` on a one-device mesh of a fake
    group, the hints on) counted by ``OpCounter``, against the JAX step
    compiled on one host device and counted by ``analyze_hlo``.

    Equal, but where stated: the ssm's is within 0.2% (prefill, decode)
    and 4% (train) below JAX's, which contracts the mLSTM normaliser
    ``n . q`` as a dot (``einsum("bhj,bhj->bh")``), where the port takes
    a product and a sum.  The JAX whisper ignores ``remat``, so the
    audio train step is held with remat off, and with it on must count
    more (its blocks' forward again)."""
    import json
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # the port's side counts in two subprocesses while JAX compiles here
    archs = list(_FAMILIES.values())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FAMILY_SCRIPT, json.dumps(part), str(_B),
         str(_S)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for part in (archs[:3], archs[3:])]
    port = {}
    try:
        refs = {(arch, kind): _jax_step_flops(arch, kind)
                for arch in archs for kind in ("prefill", "decode", "train")}
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            port.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    for family, arch in _FAMILIES.items():
        for i, kind in enumerate(("prefill", "decode", "train")):
            ref = refs[arch, kind]
            remat = not (family == "audio" and kind == "train")
            mine = port[f"{arch}/{kind}/{remat}"]
            tol = _TOL.get(family, (0, 0, 0))[i]
            assert abs(mine - ref) <= tol * ref, (family, kind, mine, ref)
            if tol:
                assert mine < ref, (family, kind)
        if family == "audio":
            assert port[f"{arch}/train/True"] > \
                port[f"{arch}/train/False"], family
