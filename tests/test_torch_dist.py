"""The port's distribution rules against the reference's, with no ranks:
``leaf_spec`` on every leaf of every SMOKE config's parameters (fp32 leaves
and prequantized records), ``cache_sharding`` and ``page_pool_sharding``
on the cache and pool layouts, ``batch_spec``, the GEMM negotiation
(``negotiate``, ``local_shape``, ``plan_local_bounds_ok``,
``tune.space.local_shape``) and ``ef_compress``, each on the same inputs
and the same meshes — jax's ``AbstractMesh`` (axis names and sizes, no
devices), which both packages' rules read.  Also the engine's refusals
under a mesh, the ``--mesh`` parser, the one-device negotiation and
``select_plan``'s table key on the local shape.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import dispatch as jax_dispatch  # noqa: E402
from repro.dist import collectives as jax_coll  # noqa: E402
from repro.dist import shard_gemm as jax_sg  # noqa: E402
from repro.dist import sharding as jax_sharding  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant.prequant import prequantize as jax_prequantize  # noqa: E402
from repro.tune import space as jax_space  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.dispatch import GemmShardSpec, analytic_plan  # noqa: E402
from repro_torch.dist import collectives as C  # noqa: E402
from repro_torch.dist import shard_gemm as sg  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.cache import PagedCachePool  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.tune import space  # noqa: E402

MESHES = {
    "2x4": AbstractMesh((2, 4), ("data", "model")),
    "1x8": AbstractMesh((1, 8), ("data", "model")),
    "4x1": AbstractMesh((4, 1), ("data", "model")),
    "pod2x2x2": AbstractMesh((2, 2, 2), ("pod", "data", "model")),
}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", k)) for k in path)] = (path, leaf)
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference shapes, port tree) for the fp32 leaves and the records."""
    jcfg = jax_get_config(arch, smoke=True, quant="mixed")
    jshapes = jax.eval_shape(
        lambda k: jax_lm.init_params(k, jcfg), jax.random.PRNGKey(0))
    jrec = jax.eval_shape(
        lambda k: jax_prequantize(jax_lm.init_params(k, jcfg), jcfg.quant),
        jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True, quant="mixed")
    gen = torch.Generator()
    gen.manual_seed(0)
    port = lm.init_params(gen, cfg, device="cpu")
    gen.manual_seed(0)
    port_rec = lm.init_params(gen, cfg, device="cpu", prequant=cfg.quant)
    return (jshapes, port), (jrec, port_rec)


@pytest.mark.parametrize("arch", list_archs())
def test_leaf_spec_matches_reference_on_every_smoke_leaf(arch):
    n_sharded = 0
    for jtree, ptree in _trees(arch):
        jflat = _jax_flat(jtree)
        pflat = dict(_flat(ptree))
        assert set(jflat) == set(pflat), arch
        for name, mesh in MESHES.items():
            specs = S.param_sharding(ptree, mesh)
            for key, (jpath, jleaf) in jflat.items():
                want = tuple(jax_sharding.leaf_spec(jpath, jleaf, mesh))
                got = S.leaf_spec(key, pflat[key], mesh)
                assert got == want, (arch, name, key, got, want)
                assert dict(_flat(specs))[key] == want
                n_sharded += S.is_sharded(got)
    assert n_sharded > 0, arch


_CACHE_ARCHS = ("llama3.2-1b", "gemma-2b", "rwkv6-3b", "jamba-v0.1-52b")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_and_pool_sharding_match_reference(mesh_name):
    mesh = MESHES[mesh_name]
    for arch in _CACHE_ARCHS:
        jcfg = jax_get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        for batch in (4, 8):
            jshapes = jax.eval_shape(lambda: jax_lm.init_cache(jcfg, batch,
                                                               32))
            want = jax.tree.map(lambda s: tuple(s.spec),
                                jax_sharding.cache_sharding(
                                    jshapes, mesh, batch=batch))
            got = S.cache_sharding(
                lm.init_cache(cfg, batch, 32, device="meta"), mesh,
                batch=batch)
            assert got == want, (arch, batch)
        # the pool's layout (n_periods, page_or_state_row, ...)
        pool = PagedCachePool(cfg, 8, 64, 16, device="meta")
        shapes = {p: {n: jax.ShapeDtypeStruct(s, jnp.float32)
                      for n, s in lv.items()}
                  for p, lv in pool.global_shapes.items()}
        want = jax.tree.map(lambda s: tuple(s.spec),
                            jax_sharding.page_pool_sharding(shapes, mesh))
        assert S.page_pool_sharding(shapes, mesh) == want, arch


def test_batch_spec_and_constrain_batch_dim():
    for mesh in MESHES.values():
        assert S.batch_spec(mesh) == tuple(jax_sharding.batch_spec(mesh))
    assert S.batch_spec(AbstractMesh((8,), ("model",))) == ()
    x = torch.ones((4, 8))
    assert S.constrain_batch_dim(x) is x
    assert S.data_axes(MESHES["pod2x2x2"]) == ("pod", "data")
    assert S.data_size(MESHES["pod2x2x2"]) == 4


def _jax_spec(spec):
    if spec is None:
        return None
    return (spec.m_axes, spec.n_axes, spec.k_axes, spec.e_axes)


def _port_spec(spec):
    if spec is None:
        return None
    assert isinstance(spec, GemmShardSpec)
    return (spec.m_axes, spec.n_axes, spec.k_axes, spec.e_axes)


# the reference's negotiation cases (tests/test_sharded_pallas.py), and a
# grid around them
SHAPES = [(32, 256, 1024), (33, 256, 1025), (33, 256, 1024), (8, 64, 96),
          (1, 2048, 8192), (4, 2048, 128256), (64, 8192, 2048),
          (3, 64, 1020), (16, 512, 1022)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_negotiation_matches_reference(mesh_name):
    mesh = MESHES[mesh_name]
    for shape in SHAPES:
        jspec, jreason = jax_sg.negotiate(shape, mesh)
        spec, reason = sg.negotiate(shape, mesh)
        assert _port_spec(spec) == _jax_spec(jspec), (shape, spec, jspec)
        assert reason == jreason
        assert space.local_shape(shape, mesh) == \
            jax_space.local_shape(shape, mesh)
        if spec is not None:
            assert sg.local_shape(shape, spec, mesh) == \
                jax_sg.local_shape(shape, jspec, mesh)
        for e in (6, 8, 16, 40):
            jspec, jreason = jax_sg.negotiate(shape, mesh, n_experts=e)
            spec, reason = sg.negotiate(shape, mesh, n_experts=e)
            assert _port_spec(spec) == _jax_spec(jspec), (shape, e)
            assert reason == jreason
    assert sg.negotiate((32, 256, 1024), None)[0] is None


def test_local_bounds_match_reference():
    """``plan_local_bounds_ok`` on the analytic plans at every width window,
    including a local K past ``max_exact_k`` and the digit-accumulator
    bound; the reference's extra VMEM check never trips at these tiles."""
    for w in (4, 8, 12, 14, 16, 20, 24):
        jplan = jax_dispatch.analytic_plan(w, backend="pallas")
        plan = analytic_plan(w, backend="cuda")
        for k in (64, 256, 8192, 70000, 140000, 600000):
            lshape = (16, k, 512)
            want = jax_sg.plan_local_bounds_ok(jplan, lshape, w, 8)
            assert sg.plan_local_bounds_ok(plan, lshape, w, 8) == want, \
                (w, k, want)


def test_ef_compress_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    for bits in (4, 8, 12):
        for scale in (1.0, 1e-3, 0.0):
            x = (scale * rng.standard_normal((257,))).astype(np.float32)
            err = (0.01 * rng.standard_normal((257,))).astype(np.float32)
            jq, js, je = jax_coll.ef_compress(jnp.asarray(x),
                                              jnp.asarray(err), bits=bits)
            q, s, e = C.ef_compress(torch.from_numpy(x),
                                    torch.from_numpy(err), bits=bits)
            assert np.array_equal(q.numpy(), np.asarray(jq))
            assert q.dtype == (torch.int8 if bits <= 8 else torch.int32)
            assert np.array_equal(s.numpy(), np.asarray(js))
            assert np.array_equal(e.numpy(), np.asarray(je))


def test_one_device_mesh_tiles_every_gemm():
    """A mesh of one device runs every GEMM whole (an empty spec), where
    the reference's negotiation sends every GEMM to XLA."""
    one = AbstractMesh((1, 1), ("data", "model"))
    spec, reason = sg.negotiate((33, 256, 1025), one)
    assert spec == GemmShardSpec() and reason == ""
    assert sg.local_shape((33, 256, 1025), spec, one) == (33, 256, 1025)
    assert jax_sg.negotiate((33, 256, 1025), one)[0] is None


class _CpuMesh:
    """The axis names and sizes ``Engine``'s mesh checks read, at one
    coordinate (the pool's data rank)."""

    device_type = "cpu"

    def __init__(self, shape, coord=None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.coord = list(coord or [0] * len(shape))

    def get_coordinate(self):
        return self.coord


def _fill_slot(pool, slot, value):
    """Write ``value`` into the slot's rows of every pool leaf this rank
    holds (its data rank's slots only)."""
    if not pool.owns(slot):
        return
    prows, srows = pool.lane_rows([slot])
    for leaves in pool.pools.values():
        for name, t in leaves.items():
            if name in ("k", "v"):
                t[:, torch.from_numpy(prows[0])] = value
            else:
                t[:, int(srows[0])] = value


def _slot_value(pool, slot):
    """The first entry of the slot's first state (or page) row."""
    prows, srows = pool.lane_rows([slot])
    leaves = next(iter(pool.pools.values()))
    name, t = next(iter(leaves.items()))
    row = int(prows[0][0]) if name in ("k", "v") else int(srows[0])
    return float(t[0, row].reshape(-1)[0])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_engine_refuses_unported_models_under_a_mesh(arch):
    """Recurrent blocks pass the engine's mesh check, and so does the prefix
    cache (queue 1 item 4.3 is ported): on a 2x2 mesh's pool, as data rank
    0 and as data rank 1 hold it, each data rank's snapshots live in its own
    region and index; every rank allocates them alike, only the owner
    copies rows, and a slot hits only its own data rank's snapshot."""
    from repro_torch.serve.cache import PrefixCache
    from repro_torch.serve.engine import _check_mesh
    cfg = get_config(arch, smoke=True)
    assert _check_mesh(_CpuMesh({"data": 2, "model": 2}), 4,
                       torch.device("cpu")) is None
    prompt = list(range(1, 20))
    seen = []
    for d in (0, 1):
        pool = PagedCachePool(cfg, 4, 32, 8, snapshot_slots=2, device="cpu",
                              mesh=_CpuMesh({"data": 2, "model": 2},
                                            [d, 0]))
        pfx = PrefixCache(pool, align=8)
        for slot in range(4):
            _fill_slot(pool, slot, float(slot + 1))
        pfx.store(0, prompt, 16)             # data rank 0's snapshot
        pfx.store(3, prompt[:8] + [0] * 11, 8)   # data rank 1's
        assert [s["entries"] for s in pfx.stats_by_rank()] == [1, 1]
        # slot 1 (data rank 0) hits rank 0's 16-token snapshot, slot 2
        # (data rank 1) only rank 1's 8-token one
        assert pfx.lookup(prompt, 1) == (16, True)
        assert pfx.lookup(prompt, 2) == (8, True)
        pfx.restore(1, prompt, 16)
        pfx.restore(2, prompt, 8)
        if d == 0:
            assert _slot_value(pool, 1) == 1.0      # slot 0's rows
        else:
            assert _slot_value(pool, 2) == 4.0      # slot 3's rows
        seen.append((pfx.stats_by_rank(), pool.n_free_pages,
                     pool.n_free_states, [list(f) for f in pool._free_pages]))
    assert seen[0] == seen[1]                       # every rank alike


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_engine_admits_moe_under_a_mesh(arch):
    """MoE models pass the engine's mesh check (their expert GEMMs run
    expert-parallel: tests/test_torch_moe_mesh.py), with the prefix cache
    too: one index a data rank."""
    from repro_torch.serve.engine import _check_mesh
    cfg = get_config(arch, smoke=True)
    mesh = _CpuMesh({"data": 2, "model": 2})
    assert _check_mesh(mesh, 4, torch.device("cpu")) is None
    eng = Engine(cfg, {}, max_seq=32, batch_size=4, device="cpu", mesh=mesh,
                 prefix_cache=True)
    assert eng.prefix.stats_by_rank() == [
        {"entries": 0, "hits": 0, "misses": 0}] * 2


def test_engine_mesh_refusals():
    cfg = get_config("llama3.2-1b", smoke=True)
    mesh = _CpuMesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="split over"):
        Engine(cfg, {}, max_seq=32, batch_size=3, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="split over"):
        Engine(cfg, {}, max_seq=32, batch_size=3, device="cpu", mesh=mesh,
               prefix_cache=True)
    # the prefix cache is admitted: each data rank keeps its own region
    eng = Engine(cfg, {}, max_seq=32, batch_size=4, device="cpu", mesh=mesh,
                 prefix_cache=True, prefix_snapshots=3)
    assert eng.pool.n_free_states == 2 * 3
    from repro_torch.core.context import ExecContext
    with pytest.raises(ValueError, match="disagree"):
        Engine(cfg, {}, max_seq=32, batch_size=4, device="cpu", mesh=mesh,
               context=ExecContext(mesh=_CpuMesh({"data": 1})))


def test_ambient_mesh_means_batch_local_rows():
    """Inside ``use_mesh(m)`` activations are this data rank's rows
    (``batch_is_local(m)``); a mesh given only in a GEMM's context, or
    outside every block, takes global rows; the innermost block wins."""
    outer, inner = MESHES["2x4"], MESHES["1x8"]
    assert S.current_mesh() is None and not S.batch_is_local(outer)
    with S.use_mesh(outer):
        assert S.current_mesh() is outer and S.batch_is_local(outer)
        with S.use_mesh(inner):
            assert S.batch_is_local(inner) and not S.batch_is_local(outer)
        assert S.current_mesh() is outer
    assert S.current_mesh() is None and not S.batch_is_local(outer)


def test_parse_mesh():
    assert parse_mesh("2x2") == (2, 2)
    assert parse_mesh("2x4x8") == (2, 4, 8)
    for bad in ("2", "ax2", "0x4", "1x2x3x4"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


def test_select_plan_keys_the_table_on_the_local_shape():
    """Under a mesh a table is looked up, and a plan validated, on the
    per-rank shape the sharded kernel runs (the reference's rule), and the
    context's ``local_gemm_shape`` is ``tune.space.local_shape``."""
    from repro_torch.core.context import ExecContext, resolve_context
    from repro_torch.core.dispatch import ExecPlan, select_plan
    from repro_torch.tune.table import TuningTable
    mesh = MESHES["2x4"]
    shape = (32, 2048, 8192)
    local = (16, 2048, 2048)
    ctx = ExecContext(mesh=mesh)
    assert ctx.local_gemm_shape(shape) == local == \
        jax_space.local_shape(shape, mesh)
    table = TuningTable(device="cpu/plain")
    table.put("cuda", local, 8, ExecPlan("mm1", 8, block_k=256,
                                         combine_int32=True, depth=0))
    on_mesh = select_plan(shape, 8, table=table, context=ctx)
    assert (on_mesh.variant, on_mesh.source) == ("mm1", "table")
    whole = select_plan(shape, 8, table=table, context=ExecContext())
    assert whole.source != "table"
    assert resolve_context(None, what="t", mesh=mesh).mesh is mesh
    assert resolve_context(ctx, what="t", mesh=mesh) is not None
    with pytest.raises(ValueError, match="disagree"):
        resolve_context(ctx, what="t", mesh=MESHES["1x8"])
