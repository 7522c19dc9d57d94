"""The port's engine knobs beyond the defaults, mirroring the reference's
tests/test_serve_prefill_chunked.py and tests/test_serve_scale.py: chunked
prefill and prompt-prefix sharing, each held to the unchunked port engine
and to the JAX engine, the knobs' checks, and ``warm()`` with
``n_traces()`` (on the CPU the decode widths run their static buffers
without a graph; the graphs themselves run only on the card, in
chip_smoke.py).

Tiny llama3.2-1b (and the rwkv6-3b smoke config, whose recurrent state rows
the prefix snapshots carry) under the mixed policy in float32 compute, so
greedy tokens are comparable with the JAX engine on the Pallas route.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve.cache import (PAGED_LEAVES, PagedCachePool,  # noqa
                                     PrefixCache)
from repro_torch.serve.engine import Engine, Request  # noqa: E402

MAX_SEQ = 48
TINY = {"llama3.2-1b": dict(d_model=64, d_ff=128, vocab_size=256),
        "rwkv6-3b": {}}


def _cfgs(arch):
    kw = dict(TINY[arch], compute_dtype="float32")
    jcfg = jax_get_config(arch, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    return (jcfg.scaled_down(**kw),
            get_config(arch, smoke=True, quant="mixed").scaled_down(**kw))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in TINY:
        jcfg, tcfg = _cfgs(arch)
        jparams = jax_lm.init_params(jax.random.PRNGKey(7), jcfg)
        out[arch] = (jcfg, jparams, tcfg,
                     params_from_jax(jax.tree.map(np.asarray, jparams)))
    return out


def _prompts(lengths, seed=0, shared=0):
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(1, 250, size=shared)]
    return [head + [int(t) for t in rng.integers(1, 250, size=n)]
            for n in lengths]


def _serve(cfg, params, prompts, batch_size=4, greedy=False, **kw):
    eng = Engine(cfg, params, max_seq=MAX_SEQ, batch_size=batch_size,
                 device="cpu", **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=5,
                    temperature=0.8 if i % 2 and not greedy else 0.0)
            for i, p in enumerate(prompts)]
    stats = eng.generate(reqs)
    assert eng.num_active == 0 and eng.num_pending == 0
    assert stats.generated_tokens == sum(len(r.generated) for r in reqs)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("arch", list(TINY))
def test_chunked_prefill_token_identity(models, arch):
    """Chunks of 8 and 16 (prompt lengths around both, 1 and 30 included):
    the unchunked engine's tokens, temperature requests too, and prefill
    widths only from the chunk ladder."""
    _, _, tcfg, tparams = models[arch]
    prompts = _prompts((3, 17, 24, 9, 1, 30))
    base, _ = _serve(tcfg, tparams, prompts)
    for chunk in (8, 16):
        got, eng = _serve(tcfg, tparams, prompts, prefill_chunk=chunk)
        assert got == base, chunk
        assert eng.n_traces()["prefill"] <= len([b for b in (8, 16)
                                                 if b <= chunk])


def _jax_serve(jcfg, jparams, prompts, batch_size, **kw):
    """Greedy tokens of the JAX engine, and the engine."""
    eng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=batch_size,
                    **kw)
    reqs = [JaxRequest(prompt=list(p), max_new_tokens=5) for p in prompts]
    eng.generate(reqs)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("arch", list(TINY))
def test_chunked_prefill_matches_jax_engine(models, arch):
    """Greedy tokens of the port's chunked engine equal the JAX engine's,
    chunked the same way (rwkv: its state carried across chunks)."""
    jcfg, jparams, tcfg, tparams = models[arch]
    prompts = _prompts((3, 17, 24, 9))
    got, _ = _serve(tcfg, tparams, prompts, batch_size=1, greedy=True,
                    prefill_chunk=8)
    want, _ = _jax_serve(jcfg, jparams, prompts, 1, prefill_chunk=8)
    assert got == want
    assert all(len(g) == 5 for g in got)


@pytest.mark.parametrize("arch", list(TINY))
def test_prefix_cache_token_identity(models, arch):
    """Repeated 20-token prefixes: 2 slots, so the later requests are
    admitted after the first snapshot exists and restore it (rwkv: its
    state rows too); tokens equal the engine without prefix sharing."""
    jcfg, jparams, tcfg, tparams = models[arch]
    prompts = _prompts((4, 7, 2, 9), seed=1, shared=20)
    base, _ = _serve(tcfg, tparams, prompts, batch_size=2)
    got, eng = _serve(tcfg, tparams, prompts, batch_size=2,
                      prefill_chunk=8, prefix_cache=True)
    assert got == base
    st = eng.prefix.stats()
    assert st["hits"] >= 2 and st["entries"] >= 1, st
    # greedy, one slot (every later request hits): the JAX engine with the
    # same prefix sharing, hits included
    got, eng_g = _serve(tcfg, tparams, prompts, batch_size=1, greedy=True,
                        prefill_chunk=8, prefix_cache=True)
    want, jeng = _jax_serve(jcfg, jparams, prompts, 1, prefill_chunk=8,
                            prefix_cache=True)
    assert got == want
    assert jeng.prefix.stats() == eng_g.prefix.stats()
    assert eng_g.prefix.stats()["hits"] >= 2
    # snapshots at lcm(page 16, chunk 8, 8) = 16 tokens: one page and one
    # state row an entry, out of the region's 4 slots' worth
    assert eng.prefix.align == 16
    assert eng.pool.n_free_states == 4 - st["entries"]
    assert eng.pool.n_free_pages == 4 * 3 - st["entries"]


def test_bad_knobs_raise(models):
    _, _, tcfg, tparams = models["llama3.2-1b"]
    for chunk in (12, 4):
        with pytest.raises(ValueError, match="prefill_chunk"):
            Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2,
                   prefill_chunk=chunk, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2, page_size=32,
               device="cpu")
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2,
                 prompt_buckets=(16, 48, 8, 16), page_size=8, device="cpu")
    assert eng.prompt_buckets == (8, 16, 48)
    assert eng.pool.page_size == 8 and eng.pool.pages_per_slot == 6
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2,
                 prefix_cache=True, device="cpu")
    assert eng.prefill_chunk == 16      # a chunk covering one page


def test_warm_pretraces_all_widths(models):
    """warm() runs every decode width and every chunk width on the parking
    rows only; a generate after it adds no width."""
    _, _, tcfg, tparams = models["llama3.2-1b"]
    eng = Engine(tcfg, tparams, max_seq=32, batch_size=4, prefill_chunk=8,
                 device="cpu")
    before = {pos: {k: v.clone() for k, v in leaves.items()}
              for pos, leaves in eng.pool.pools.items()}
    eng.warm()
    warm = eng.n_traces()
    assert warm == {"decode": len(eng.scheduler.decode_widths),
                    "prefill": 1}
    rows = eng.pool.page_table.reshape(-1)
    for pos, leaves in eng.pool.pools.items():
        for name, pool in leaves.items():
            assert torch.equal(pool[:, rows], before[pos][name][:, rows])
    reqs = [Request(prompt=p, max_new_tokens=4)
            for p in _prompts((3, 9, 14, 5, 11))]
    eng.generate(reqs)
    assert eng.n_traces() == warm
    eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="idle"):
        eng.warm()


# -- the pool's snapshot region and PrefixCache, as the reference's
# tests/test_serve_scheduler.py drives them ----------------------------------


def test_pool_tables_and_free_lists(models):
    tcfg = models["llama3.2-1b"][2]
    pool = PagedCachePool(tcfg, 4, 32, 8, snapshot_slots=2, device="cpu")
    pps = pool.pages_per_slot
    assert pps == 4
    # slot rows, parking rows and the snapshot region are disjoint
    slot_pages = set(pool.page_table.ravel().tolist())
    park = set(pool.parking_pages.tolist())
    free = {p for region in pool._free_pages for p in region}  # a data rank's
    assert len(slot_pages) == 4 * pps
    assert not slot_pages & park and not (slot_pages | park) & free
    assert pool.n_free_pages == 2 * pps and pool.n_free_states == 2
    assert pool.parking_state not in set(pool.state_table.tolist())
    before = (pool.n_free_pages, pool.n_free_states)
    h = pool.take_snapshot(1, n_pages=2)
    assert (pool.n_free_pages, pool.n_free_states) == (before[0] - 2,
                                                       before[1] - 1)
    pool.restore_snapshot(3, h)                     # a copy back, no alloc
    assert pool.n_free_pages == before[0] - 2
    pool.release_snapshot(h)
    assert (pool.n_free_pages, pool.n_free_states) == before
    handles = []
    while (h := pool.take_snapshot(0, n_pages=2)) is not None:
        handles.append(h)
    assert len(handles) == 2                        # two state rows
    for h in handles:
        pool.release_snapshot(h)
    assert (pool.n_free_pages, pool.n_free_states) == before


@pytest.mark.parametrize("arch", list(TINY))
def test_pool_copy_semantics(models, arch):
    """Snapshots are copies, of K/V pages and of recurrent state rows: the
    source slot changing after the snapshot does not reach a restore."""
    tcfg = models[arch][2]
    pool = PagedCachePool(tcfg, 2, 32, 8, snapshot_slots=1, device="cpu")

    def poke(slot, value):
        for name, t in pool._leaves():
            rows = (torch.as_tensor(pool.page_table[slot])
                    if name in PAGED_LEAVES else int(pool.state_table[slot]))
            t[:, rows] = value

    def first(slot):
        name, t = next(pool._leaves())
        row = (pool.page_table[slot][0] if name in PAGED_LEAVES
               else pool.state_table[slot])
        return float(t[0, int(row)].reshape(-1)[0])

    poke(0, 3.0)
    h = pool.take_snapshot(0, n_pages=2)
    poke(0, 7.0)                                    # the source diverges
    pool.restore_snapshot(1, h)
    assert first(0) == 7.0 and first(1) == 3.0


def test_prefix_cache_lru_and_boundaries(models):
    tcfg = models["llama3.2-1b"][2]
    pool = PagedCachePool(tcfg, 1, 32, 8, snapshot_slots=2, device="cpu")
    pfx = PrefixCache(pool, align=8, max_entries=2)
    assert [pfx.boundary_for(n) for n in (5, 8, 9, 17)] == [0, 0, 8, 16]
    p1, p2, p3 = ([1] * 24, [2] * 24, [3] * 24)
    pfx.store(0, p1, 8)
    pfx.store(0, p2, 8)
    assert pfx.lookup(p1, 0) == (8, True)           # p1 now most recent
    pfx.store(0, p3, 8)                             # evicts p2 (LRU)
    assert pfx.lookup(p2, 0) == (0, False)
    assert pfx.lookup(p1, 0) == (8, True) and pfx.lookup(p3, 0) == (8, True)
    assert len(pfx) == 2
    assert pfx.stats() == {"entries": 2, "hits": 3, "misses": 1}
    # the longest cached prefix wins; a shorter shared head misses
    pool2 = PagedCachePool(tcfg, 1, 32, 8, snapshot_slots=2, device="cpu")
    pfx2 = PrefixCache(pool2, align=8, max_entries=2)
    pfx2.store(0, p1, 16)
    assert pfx2.lookup(p1[:8] + [9] * 16, 0) == (0, False)
    assert pfx2.lookup(p1[:16] + [9] * 8, 0) == (16, True)
