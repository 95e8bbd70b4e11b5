"""A paged kernel table of a test's own in the checked-in table's place
(``kernels/paged_decode_attention/autotune.json``): the one way to force
the variant a paged model's decode step launches.  Import after
``pytest.importorskip("torch")``."""
import json

import pytest

from repro_torch.kernels.paged_decode_attention import ops


def use_table(path, monkeypatch):
    """Put the table at ``path`` in the checked-in table's place."""
    monkeypatch.setattr(ops, "_DEFAULT_TABLE", str(path))
    ops._load_table.cache_clear()


def write_table(tmp_path, table, monkeypatch):
    """Write ``table`` to a file under ``tmp_path`` and use it."""
    p = tmp_path / "table.json"
    p.write_text(json.dumps(table))
    use_table(p, monkeypatch)
    return p


@pytest.fixture
def paged_variant(tmp_path, monkeypatch):
    """``force(variant, pages_per_block=2)``: a table whose default names
    ``variant``, for the rest of the test."""
    def force(variant, pages_per_block=2):
        write_table(tmp_path, {"configs": {"default": {
            "variant": variant, "pages_per_block": pages_per_block}}},
            monkeypatch)
    return force
