"""The device timeline's reduction: busy and idle shares, named gaps."""
import pytest

from portbench.harness.tracing import Trace, gaps, label_gaps, merge


def test_idle_share_on_a_synthetic_timeline():
    # window 0..100; kernels overlap and spill over the edges
    dev = [(-5, 10), (5, 20), (30, 40), (35, 38), (90, 120)]
    busy = merge(dev, 0, 100)
    assert busy == [(0, 20), (30, 40), (90, 100)]
    idle = gaps(busy, 0, 100)
    assert idle == [(20, 30), (40, 90)]
    t = Trace(window_s=100.0, busy_s=sum(e - s for s, e in busy),
              decode=[], prefill=[], kernel_s={})
    assert 100 * (1 - t.busy_s / t.window_s) == pytest.approx(60.0)


def test_gaps_are_named_by_the_host_span_around_them():
    idle = [(20, 30), (40, 90), (95, 97)]
    spans = [(18, 32, "decode_step"), (50, 60, "kv.gather")]
    named = label_gaps(idle, spans)
    assert named == {"decode_step": [10], "engine_host": [50, 2]}


def test_breakdown_keeps_ten_of_each():
    t = Trace(window_s=1.0, busy_s=0.5, decode=[], prefill=[],
              kernel_s={f"k{i}": float(i) for i in range(15)},
              idle={"engine_host": [0.1, 0.3], "decode_step": [0.05]})
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]] == [f"k{i}"
                                               for i in range(14, 4, -1)]
    assert b["idle_gaps"][0] == ["engine_host", pytest.approx(0.4)]
    assert ["engine_host.longest", 0.3] in b["idle_gaps"]
    assert t.kernel_seconds("k1") == pytest.approx(1 + 10 + 11 + 12 + 13 + 14)
