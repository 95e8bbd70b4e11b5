"""The port's PagedKVCache against the JAX package's: the same operations
(add, alias, extend with copy-on-write, append, export, import, free)
give the same page tables, refcounts, free lists and pool contents.
Pool contents are copies of the inputs, so they must match bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine.kvcache import PagedKVCache as JaxKV  # noqa: E402
from repro_torch.engine.kvcache import PagedKVCache  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, H, D, PS = 2, 2, 4, 8


def _kv(rng, n):
    return (rng.standard_normal((L, n, H, D)).astype(np.float32),
            rng.standard_normal((L, n, H, D)).astype(np.float32))


def _both(num_pages=16):
    return (JaxKV(L, num_pages, PS, H, D),
            PagedKVCache(L, num_pages, PS, H, D, device="cpu"))


def _same_state(j, t):
    assert {s: e.page_ids for s, e in j.sequences.items()} == \
        {s: e.page_ids for s, e in t.sequences.items()}
    assert {s: e.length for s, e in j.sequences.items()} == \
        {s: e.length for s, e in t.sequences.items()}
    np.testing.assert_array_equal(j.refcount, t.refcount)
    assert j.free_pages == t.free_pages
    assert (j.pages_shared, j.tokens_reused, j.pages_in_use) == \
        (t.pages_shared, t.tokens_reused, t.pages_in_use)
    np.testing.assert_array_equal(np.asarray(j.k), t.k.numpy())
    np.testing.assert_array_equal(np.asarray(j.v), t.v.numpy())


def test_same_operations_give_the_same_cache():
    rng = np.random.default_rng(0)
    j, t = _both()
    k0, v0 = _kv(rng, 13)                       # one full page + 5
    k1, v1 = _kv(rng, 7)
    steps = [_kv(rng, 1) for _ in range(6)]
    for c in (j, t):
        k_ptr = id(c.k)
        a = c.add_sequence(k0, v0)
        b = c.add_sequence(shared_from=a, shared_len=10)   # partial alias
        c.extend_sequence(b, k1, v1)                       # COW, then pages
        d = c.add_sequence(shared_from=a, shared_len=13)   # aliases a's tail
        for k_t, v_t in steps:                             # a COWs first
            c.append_token(a, k_t[:, 0], v_t[:, 0])
        c.prepare_appends([d, b])
        c.commit_appends([d, b])
        if c is t:
            assert id(c.k) == k_ptr                        # written in place
    _same_state(j, t)
    for seq in list(t.sequences):
        for n in (None, 9):
            je, te = j.export_sequence(seq, n), t.export_sequence(seq, n)
            for x, y in zip(je, te):
                assert y.dtype == np.float32
                np.testing.assert_array_equal(x, y)
        tg = t.gather(seq)
        jg = j.gather(seq)
        np.testing.assert_array_equal(np.asarray(jg[0]), tg[0].numpy())
    exported = t.export_sequence(1)
    assert j.import_sequence(*exported) == t.import_sequence(*exported)
    j.free_sequence(0)
    t.free_sequence(0)
    _same_state(j, t)


def test_out_of_pages_and_bad_imports_raise_alike():
    rng = np.random.default_rng(1)
    j, t = _both(num_pages=2)
    k, v = _kv(rng, 3 * PS)
    for c in (j, t):
        with pytest.raises(MemoryError):
            c.add_sequence(k, v)
        with pytest.raises(ValueError):
            c.import_sequence(k[:, :, :1], v[:, :, :1])


def test_batched_append_tokens_matches_jax():
    """The dense-view arm's per-step append: one row at a page boundary
    (a fresh page), one with an aliased partial tail (copy-on-write), one
    mid-page."""
    rng = np.random.default_rng(2)
    j, t = _both()
    k0, v0 = _kv(rng, 16)                       # two full pages
    k1, v1 = _kv(rng, 5)
    steps = [_kv(rng, 3) for _ in range(3)]     # (L, 3, H, D) per step
    for c in (j, t):
        a = c.add_sequence(k0, v0)
        b = c.add_sequence(k1, v1)
        d = c.add_sequence(shared_from=b, shared_len=5)
        for k_t, v_t in steps:
            kt, vt = (k_t, v_t) if c is j else (torch.from_numpy(k_t),
                                                torch.from_numpy(v_t))
            c.append_tokens([a, b, d], kt, vt)
    _same_state(j, t)
    assert [t.sequences[s].length for s in (0, 1, 2)] == [19, 8, 8]
