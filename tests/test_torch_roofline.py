"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's, priced at the H100's peaks (``repro_torch.configs.base``): the
JAX module's TPU peaks are monkeypatched to the H100's inside each test,
so both compute the same function of the same inputs."""
import json

import pytest

torch = pytest.importorskip("torch")

import repro.launch.roofline as jroof  # noqa: E402
from repro.configs import ARCH_IDS as JAX_ARCHS  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402


@pytest.fixture
def h100_jax(monkeypatch):
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", base.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroof, "HBM_BW", base.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", base.NVLINK_BW)
    return jroof


def test_h100_constants():
    """H100 SXM data sheet (dense): 989 TFLOP/s bf16, 67 TFLOP/s f32,
    3.35 TB/s HBM3, 80 GB; NVLink 4 at 450 GB/s a direction."""
    assert (base.PEAK_FLOPS_BF16, base.PEAK_FLOPS_F32, base.HBM_BW,
            base.HBM_BYTES) == (989e12, 67e12, 3.35e12, 80e9)
    assert base.NVLINK_BW == 450e9 and base.IB_BW == 50e9
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_jax(shape):
    assert ARCH_IDS == JAX_ARCHS
    for arch in ARCH_IDS:
        assert roofline.model_flops(arch, shape) == \
            jroof.model_flops(arch, shape)


def test_kernel_bounds_equal_jax(h100_jax):
    for nbytes, flops in ((1e9, 1e12), (3e6, 5e13), (0.0, 1.0), (7.0, 0.0)):
        assert roofline.kernel_time_bound(nbytes, flops) == \
            h100_jax.kernel_time_bound(nbytes, flops,
                                       hbm_bw=base.HBM_BW,
                                       peak_flops=base.PEAK_FLOPS_BF16)
        for ms in (1e-4, 2e-3):
            assert roofline.pct_of_roofline(ms, nbytes, flops) == \
                h100_jax.pct_of_roofline(ms, nbytes, flops,
                                         hbm_bw=base.HBM_BW,
                                         peak_flops=base.PEAK_FLOPS_BF16)
    # an f32 kernel is priced at the CUDA cores' rate
    assert roofline.kernel_time_bound(
        0.0, 67e9, peak_flops=base.PEAK_FLOPS_F32) == pytest.approx(1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_paged_decode_cost_equal_jax(fused):
    for lengths in (None, [0, 15, 16, 100, -1], [255] * 3):
        B = 5 if lengths is None else len(lengths)
        kw = dict(dtype_bytes=2, fused=fused, lengths=lengths)
        assert roofline.paged_decode_cost(B, 16, 8, 128, 16, 16, **kw) == \
            jroof.paged_decode_cost(B, 16, 8, 128, 16, 16, **kw)


def _cells():
    """Synthetic dry-run cells: every arch at every applicable shape, on
    both meshes, with counts that vary by cell, plus an error and a
    skipped cell."""
    cells = []
    for i, arch in enumerate(ARCH_IDS):
        for j, shape in enumerate(SHAPES):
            for mesh, dev in (("pod16x16", 256), ("pod2x16x16", 512)):
                cells.append({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "ok", "devices": dev,
                    "flops": 1e12 * (i + 1) * (j + 2),
                    "bytes_accessed": 3e10 * (j + 1) / (i + 1),
                    "collectives": {"collective_bytes": 1e9 * (i + j)},
                    "hbm_fit": bool(i % 2)})
    cells.append({"arch": "qwen3-1.7b", "shape": "long_500k",
                  "mesh": "pod16x16", "status": "skipped",
                  "reason": "full dense attention"})
    cells.append({"arch": "xlstm-350m", "shape": "train_4k",
                  "mesh": "pod16x16", "status": "error", "error": "boom"})
    return cells


def test_analyze_cell_equals_jax(h100_jax):
    """Every key of JAX's row, ``hlo_flops_per_dev`` being the port's
    ``counted_flops_per_dev``."""
    for cell in _cells():
        mine, ref = roofline.analyze_cell(cell), h100_jax.analyze_cell(cell)
        if ref is None:
            assert mine is None
            continue
        ref["counted_flops_per_dev"] = ref.pop("hlo_flops_per_dev")
        assert mine == ref


def test_cli_prints_a_row_for_each_ok_cell(tmp_path, capsys):
    files = {f"{c['arch']}__{c['shape']}__{c['mesh']}.json": c
             for c in _cells()}          # the error and the skip replace two
    for name, c in files.items():
        (tmp_path / name).write_text(json.dumps(c))
    n_ok = sum(c["status"] == "ok" and c["mesh"] == "pod16x16"
               for c in files.values())
    assert n_ok == len(ARCH_IDS) * len(SHAPES) - 2
    assert roofline.main(["--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "989 TFLOP/s bf16" in out[0] and "3.35 TB/s HBM" in out[0]
    rows = [ln for ln in out if ln.split()[:1] and ln.split()[0]
            in ARCH_IDS and len(ln.split()) == 9]
    assert len(rows) == n_ok
    assert any("full dense attention" in ln for ln in out)
    assert any("boom" in ln for ln in out)
    assert roofline.main(["--dir", str(tmp_path), "--json",
                          "--mesh", "pod2x16x16"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert len(data) == len(ARCH_IDS) * len(SHAPES)
    assert all(r["mesh"] == "pod2x16x16" for r in data)
