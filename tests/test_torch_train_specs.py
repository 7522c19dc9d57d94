"""The port's abstract step inputs (``launch.steps``: ``abstract_params``,
``abstract_opt_state``, ``train_batch_specs``, ``abstract_cache``,
``abstract_mem``, ``decode_token_specs``, ``input_specs``) and its
``ShapeCell`` against the reference's, with no ranks: every leaf's shape
and dtype equal to the reference's ``jax.eval_shape`` and its spec equal to
the reference's ``NamedSharding`` spec (``tuple(PartitionSpec)``, as
``tests/test_torch_dist.py`` compares the rules), on jax's
``AbstractMesh`` (axis names and sizes, no devices), which both packages'
rules read.  Also a rank's bytes of an abstract tree against the blocks
``dist.sharding.local_block`` cuts.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402

MESHES = {
    "2x4": AbstractMesh((2, 4), ("data", "model")),
    "4x1": AbstractMesh((4, 1), ("data", "model")),
    "pod2x2x2": AbstractMesh((2, 2, 2), ("pod", "data", "model")),
}
CELLS = {
    "train": configs.ShapeCell("t", 64, 8, "train"),
    "prefill": configs.ShapeCell("p", 64, 8, "prefill"),
    "decode": configs.ShapeCell("d", 64, 8, "decode"),
    "decode1": configs.ShapeCell("d1", 64, 1, "decode"),
}
ARCHS = configs.list_archs()


def _jax_flat(tree):
    """path (key names, tuple indices) -> ShapeDtypeStruct."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)] = leaf
    return out


def _port_flat(tree, path=()):
    out = {}
    if isinstance(tree, steps.Abstract):
        out[path] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            out.update(_port_flat(getattr(tree, name), path + (name,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_port_flat(v, path + (str(i),)))
    return out


def _assert_same(port_tree, jax_tree, what):
    got, want = _port_flat(port_tree), _jax_flat(jax_tree)
    assert got.keys() == want.keys(), (what, set(got) ^ set(want))
    for key, a in got.items():
        b = want[key]
        assert a.shape == tuple(b.shape), (what, key, a.shape, b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), \
            (what, key, a.dtype, b.dtype)
        assert a.spec == tuple(b.sharding.spec), (what, key, a.spec,
                                                  b.sharding.spec)
    return len(got)


def _cfgs(arch, quant="mixed"):
    return (configs.get_config(arch, smoke=True, quant=quant),
            jax_configs.get_config(arch, smoke=True, quant=quant))


def test_shape_cells_and_their_rule_match_reference():
    assert configs.SHAPES.keys() == jax_configs.SHAPES.keys()
    for name, cell in configs.SHAPES.items():
        ref = jax_configs.SHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)
        for arch in ARCHS:
            assert configs.cell_applicable(
                configs.get_config(arch), name) == \
                jax_configs.cell_applicable(jax_configs.get_config(arch),
                                            name), (arch, name)
    assert steps.ENC_MEM_LEN == jax_steps.ENC_MEM_LEN


@pytest.mark.parametrize("prequant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch, prequant):
    cfg, jcfg = _cfgs(arch)
    n = 0
    for name, mesh in MESHES.items():
        n = _assert_same(steps.abstract_params(cfg, mesh, prequant),
                         jax_steps.abstract_params(jcfg, mesh, prequant),
                         (arch, name))
    assert n > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma-2b",
                                  "granite-moe-3b-a800m", "rwkv6-3b"])
def test_abstract_opt_state_matches_reference(arch):
    cfg, jcfg = _cfgs(arch)
    for name, mesh in MESHES.items():
        got = steps.abstract_opt_state(steps.abstract_params(cfg, mesh),
                                       mesh)
        want = jax_steps.abstract_opt_state(
            jax_steps.abstract_params(jcfg, mesh), mesh)
        _assert_same(got, want, (arch, name))
        assert got.step.dtype == torch.int32 and got.step.spec == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_specs_match_reference(arch):
    cfg, jcfg = _cfgs(arch)
    for name, mesh in MESHES.items():
        _assert_same(steps.train_batch_specs(cfg, CELLS["train"], mesh),
                     jax_steps.train_batch_specs(jcfg, CELLS["train"], mesh),
                     (arch, name))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_reference(arch):
    cfg, jcfg = _cfgs(arch)
    for name, mesh in MESHES.items():
        for batch in (4, 8):
            _assert_same(steps.abstract_cache(cfg, mesh, batch, 32),
                         jax_steps.abstract_cache(jcfg, mesh, batch, 32),
                         (arch, name, batch))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-v0.1-52b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_input_specs_match_reference(arch, cell):
    """Every input of a train, a prefill and a decode cell (the decode
    cell of an encoder-decoder with its cross-attention memory)."""
    cfg, jcfg = _cfgs(arch)
    mesh = MESHES["2x4"]
    got = steps.input_specs(cfg, CELLS[cell], mesh)
    want = jax_steps.input_specs(jcfg, CELLS[cell], mesh)
    assert got.keys() == want.keys()
    _assert_same(got, want, (arch, cell))
    assert ("mem" in got) == (cfg.is_encdec and CELLS[cell].kind == "decode")


def test_local_bytes_are_the_blocks_bytes():
    """A rank's bytes of the abstract params are those of the blocks
    ``local_block`` cuts from the whole leaves under the same specs."""
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    metas = lm.init_params(torch.Generator(), cfg, device="meta")
    for name, mesh in MESHES.items():
        abs_p = steps.abstract_params(cfg, mesh)
        want = 0
        for key, a in _port_flat(abs_p).items():
            leaf = metas
            for k in key:
                leaf = leaf[k]
            block = S.local_block(torch.empty(leaf.shape, device="meta"),
                                  a.spec, _Coord(mesh))
            assert tuple(block.shape) == a.local_shape(mesh), (name, key)
            want += block.numel() * 4
        assert steps.local_bytes(abs_p, mesh) == want
        if name != "4x1":
            assert want < S.resident_bytes(metas)


class _Coord:
    """An abstract mesh with a coordinate (rank 0 everywhere), enough for
    ``local_block``."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)

    def get_coordinate(self):
        return [0] * len(self.axis_names)
