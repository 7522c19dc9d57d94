"""Sharding rules: logical-axis partitioning for params, caches and batches
(port of ``repro.dist.sharding``).

The reference's MaxText-style two-level mapping, unchanged: each weight
leaf gets *logical* axes from its name (``wi -> ("embed", "mlp")``), and a
rules table maps logical axes onto mesh axes (``"mlp" -> "model"``,
``"embed" -> "data"``, i.e. FSDP).  A mesh axis is assigned only where it
divides the dimension and the spec does not use it yet.  Block params carry
a leading ``n_periods`` stacking dim (and MoE weights an expert dim): the
rules apply to the trailing matmul dims, the expert dim rides ``model``,
stacking dims stay replicated.

A spec is a tuple with one entry per tensor dim, as ``tuple(P)`` of the
reference's ``PartitionSpec``: ``None`` (replicated), a mesh axis name, or
a tuple of axis names (a dim over several data axes, major first).  The
rules read only a mesh's axis names and sizes, so they take a
``torch.distributed.device_mesh.DeviceMesh`` or any object with
``axis_names`` and a ``shape`` mapping (the reference's test meshes).

Where the reference places arrays with ``NamedSharding``, the port holds
each rank's block: :func:`shard_params` keeps, on every rank, exactly the
block its mesh coordinate owns under :func:`leaf_spec`, as a ``DTensor``
whose placements (:func:`spec_placements`) are ``Shard(d)`` on each mesh
dim the spec names and ``Replicate()`` elsewhere; a leaf whose spec names
no axis stays a plain tensor.  Code that needs a leaf whole gathers it
(:func:`full_leaf`).

The ambient mesh (:func:`use_mesh`, :func:`current_mesh`) is the analogue
of the reference's ``with mesh:``: model code has no mesh argument, and the
quantized matmul reads the ambient mesh to run its GEMMs shard-mapped.
Under it each data rank's activations are its own rows of the global batch
(the engine's lanes of its slots; in training its share of each
microbatch), the layout the reference's batch-sharded activations have on
each shard.

Training (``lm.init_params(mesh=...)``, ``train.loop.run_training``) holds
its parameters and AdamW state the same way and differentiates through
these helpers: ``select``, ``transpose``, ``to_dtype``, :func:`local` and
:func:`like` pass gradients between a DTensor and its block, and the
gathers in :func:`vocab_block` and :func:`full_leaf` cut theirs back to
the block (``dist.collectives.gather_dtensor``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

Params = Any
Spec = Tuple[Any, ...]

# Mesh axes that carry the (global) batch dimension, in mesh order.
BATCH_AXES = ("pod", "data")

# Logical axis -> mesh axes it may map onto (first fit wins).
LOGICAL_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("batch", ("pod", "data")),
    ("embed", ("data",)),        # FSDP: hidden dim sharded over data
    ("vocab", ("model",)),       # vocab-parallel embedding / head
    ("heads", ("model",)),       # tensor parallel: attention heads
    ("mlp", ("model",)),         # tensor parallel: FFN hidden
    ("inner", ("model",)),       # tensor parallel: SSM inner dim
    ("expert", ("model",)),      # expert parallelism
    ("stack", ()),               # n_periods stacking: replicated
)

# Weight-leaf name -> logical axes of the *trailing* dims (None:
# replicated).  Names not listed fall back to ("embed", "heads") for
# trailing-2D leaves (row FSDP, column TP).
PARAM_LOGICAL_AXES = {
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "wq": ("embed", "heads"),
    "wk": ("embed", "heads"),
    "wv": ("embed", "heads"),
    "wg": ("embed", "mlp"),
    "wi": ("embed", "mlp"),
    "wr": ("embed", "heads"),
    "wo": ("heads", "embed"),      # output proj: row TP, column FSDP
    "out_proj": ("inner", "embed"),
    "in_proj": ("embed", "inner"),
    "x_proj": ("inner", None),
    "dt_proj": (None, "inner"),
    "w1": ("embed", "mlp"),
    "w2": ("embed", "embed"),
    "router": ("embed", None),
}

# Small / vector leaves that always stay replicated.
NEVER_SHARD = {
    "scale", "bias", "mix", "u", "w0", "a_log", "d_skip", "dt_bias",
    "conv_w", "conv_b", "w_lora_a", "w_lora_b",
}

# Cache-leaf name -> axis index (within the (n_periods, slot, ...) layout)
# that may shard over ``model``: attention kv-heads, rwkv heads, mamba inner.
CACHE_MODEL_AXES = {
    "k": 3,       # attn (n_periods, slot, Smax, K, D): kv-heads
    "v": 3,
    "wkv": 2,     # rwkv (n_periods, slot, H, D, D): heads
    "ssm": 2,     # mamba (n_periods, slot, d_inner, d_state): inner dim
    "conv": 3,    # mamba (n_periods, slot, cw-1, d_inner): inner dim
}


# ---------------------------------------------------------------------------
# Mesh shape access (DeviceMesh or a duck-typed mesh).
# ---------------------------------------------------------------------------


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names)
    return tuple(mesh.axis_names)


def mesh_axis_size(mesh, axis: str) -> int:
    names = axis_names(mesh)
    if axis not in names:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.size(names.index(axis)))
    return int(mesh.shape[axis])


def mesh_size(mesh) -> int:
    n = 1
    for a in axis_names(mesh):
        n *= mesh_axis_size(mesh, a)
    return n


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the batch dim, in mesh order."""
    return tuple(a for a in axis_names(mesh) if a in BATCH_AXES)


def axes_size(mesh, axes: Sequence[str]) -> int:
    """The product of ``axes``' sizes (1 for none)."""
    n = 1
    for a in axes:
        n *= mesh_axis_size(mesh, a)
    return n


def data_size(mesh) -> int:
    """D: the product of the data axes' sizes."""
    return axes_size(mesh, data_axes(mesh))


def _entry(axes: Sequence[str]):
    """Spec entry for a dim over ``axes`` (None if empty)."""
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def batch_spec(mesh) -> Spec:
    """Spec of a batch-leading array: dim 0 over all data axes; ``()``
    when the mesh has no data axes (the caller replicates)."""
    axes = data_axes(mesh)
    if not axes:
        return ()
    return (_entry(axes),)


# ---------------------------------------------------------------------------
# Parameter rules.
# ---------------------------------------------------------------------------


def _key_name(entry) -> str:
    return str(getattr(entry, "key", getattr(entry, "name", entry)))


def _path_names(path) -> Tuple[str, ...]:
    return tuple(_key_name(k) for k in path)


def _mesh_axes_for(logical: Optional[str], dim: int, mesh,
                   used: set) -> Optional[str]:
    """First mesh axis for ``logical`` that divides ``dim`` and is unused."""
    if logical is None:
        return None
    for name, axes in LOGICAL_RULES:
        if name != logical:
            continue
        for ax in axes:
            size = mesh_axis_size(mesh, ax)
            if size > 1 and dim % size == 0 and ax not in used:
                used.add(ax)
                return ax
        return None
    return None


def leaf_spec(path, leaf, mesh) -> Spec:
    """The spec of one parameter leaf at ``path`` (key names); ``leaf`` is
    anything with a ``shape``.  A record's codes (``.../name/q``) follow
    the parent weight's rule; its scale is replicated."""
    names = _path_names(path)
    name = names[-1]
    if name == "q" and len(names) >= 2:
        name = names[-2]
    shape = tuple(leaf.shape)
    ndim = len(shape)
    if name in NEVER_SHARD or ndim < 2:
        return ()
    logical = PARAM_LOGICAL_AXES.get(name)
    if logical is None:
        logical = ("embed", "heads")   # generic (K, N): row FSDP, col TP
    spec: List[Any] = [None] * ndim
    used: set = set()
    # An expert dim (the dim right before the matmul dims, under a "moe"
    # subtree) claims the model axis first: expert parallelism wins over
    # tensor parallelism inside an expert.
    if "moe" in names and ndim - len(logical) - 1 >= 0:
        e_idx = ndim - len(logical) - 1
        spec[e_idx] = _mesh_axes_for("expert", shape[e_idx], mesh, used)
    for off, lax_name in enumerate(reversed(logical)):
        dim_idx = ndim - 1 - off
        if dim_idx < 0:
            break
        spec[dim_idx] = _mesh_axes_for(lax_name, shape[dim_idx], mesh, used)
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_sharding(params: Params, mesh) -> Params:
    """The spec of every leaf of a parameter tree (tensors, or anything
    with a ``shape``)."""
    return _map_with_path(lambda p, leaf: leaf_spec(p, leaf, mesh), params)


def _row_and_model_specs(shapes: Params, mesh, row_ok) -> Params:
    """Specs of a cache or pool laid out ``(n_periods, row, ...)``: axis 1
    over the data axes where ``row_ok(shape)`` and D divides it, and the
    leaf's :data:`CACHE_MODEL_AXES` axis over ``model`` where that
    divides."""
    daxes = data_axes(mesh)
    dsize = data_size(mesh)
    bentry = _entry(daxes)
    msize = mesh_axis_size(mesh, "model")

    def leaf(path, arr):
        shape = tuple(arr.shape)
        spec: List[Any] = [None] * len(shape)
        if len(shape) >= 2 and row_ok(shape) and bentry is not None \
                and dsize > 1 and shape[1] % dsize == 0:
            spec[1] = bentry
        m_axis = CACHE_MODEL_AXES.get(_path_names(path)[-1])
        if m_axis is not None and m_axis < len(shape) and msize > 1 \
                and shape[m_axis] % msize == 0:
            spec[m_axis] = "model"
        return tuple(spec)

    return _map_with_path(leaf, shapes)


def cache_sharding(cache_shapes: Params, mesh, *, batch: int) -> Params:
    """Specs of a decode cache laid out ``(n_periods, slot, ...)``: the
    slot dim over the data axes; attention K/V's kv-heads, rwkv's heads and
    mamba's inner dim over ``model`` (:data:`CACHE_MODEL_AXES`), each where
    the axis divides.  ``batch`` is the slot count (checked against
    axis 1)."""
    return _row_and_model_specs(cache_shapes, mesh,
                                lambda shape: shape[1] == batch)


def page_pool_sharding(pool_shapes: Params, mesh) -> Params:
    """Specs of a paged serve pool laid out ``(n_periods, page_or_state_row,
    ...)``: axis 1 over the data axes where divisible (the pool's analogue
    of the slot dim), the per-leaf model axes of :data:`CACHE_MODEL_AXES`
    unchanged (the paged layout keeps the payload dims at their indices)."""
    return _row_and_model_specs(pool_shapes, mesh, lambda shape: True)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh: placements, this rank's block.
# ---------------------------------------------------------------------------


def spec_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that names tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in axis_names(mesh):
        dims = [d for d, e in enumerate(spec) if ax in entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index along every axis of ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    return dict(zip(axis_names(mesh), coord))


def rank_coordinate(mesh, rank: int) -> Dict[str, int]:
    """World rank ``rank``'s index along every axis of ``mesh``."""
    where = (mesh.mesh == rank).nonzero()
    if where.shape[0] != 1:
        raise RuntimeError(f"rank {rank} is not in the mesh")
    return dict(zip(axis_names(mesh), (int(i) for i in where[0])))


def axes_index(mesh, axes: Sequence[str],
               coord: Optional[Dict[str, int]] = None) -> Tuple[int, int]:
    """(index, count) of this rank's block (the rank at ``coord``'s) along
    a dim over ``axes`` (mixed radix, the first axis major)."""
    coord = coordinate(mesh) if coord is None else coord
    idx = 0
    for a in axes:
        idx = idx * mesh_axis_size(mesh, a) + coord[a]
    return idx, axes_size(mesh, axes)


def local_block(x: torch.Tensor, spec: Spec, mesh,
                coord: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block (the rank at ``coord``'s) of a whole tensor under
    ``spec`` (a view)."""
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if not axes:
            continue
        idx, n = axes_index(mesh, axes, coord)
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def is_sharded(spec: Spec) -> bool:
    return any(e is not None for e in spec)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh, device):
    """``x`` (whole, wherever it lies: the host, for a model one card
    cannot hold) -> this rank's block on ``device`` as a DTensor, a copy of
    the block alone; ``x`` itself on ``device`` where the spec names no
    axis.  A DTensor already held under ``spec`` (a leaf of
    ``lm.init_params(mesh=...)``, drawn block by block) is kept as it
    is."""
    if is_dtensor(x):
        if dtensor_spec(x) != tuple(spec) or x.device_mesh != mesh:
            raise ValueError(f"a leaf held under {dtensor_spec(x)} is not "
                             f"its {tuple(spec)} block on this mesh")
        return x
    if not is_sharded(spec):
        return x.to(device)
    return wrap_block(local_block(x, spec, mesh).to(device, copy=True), spec,
                      mesh, x.shape)


def shard_params(params: Params, mesh, device) -> Params:
    """Every leaf of a whole parameter tree -> this rank's block under
    :func:`leaf_spec` on ``device`` (:func:`shard_leaf`): only the blocks
    reach the device.  Leaves already held as their blocks are kept."""
    return _map_with_path(
        lambda p, leaf: shard_leaf(leaf, leaf_spec(p, leaf, mesh), mesh,
                                   device), params)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    return torch.empty(shape, device="meta").stride()


def _rewrap(x, local: torch.Tensor, placements, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def select(x, i: int):
    """``x[i]`` along a replicated leading dim (a period of a stacked
    leaf); a DTensor stays one, its local block indexed without DTensor's
    op dispatch (which refuses views under ``inference_mode``)."""
    if not is_dtensor(x):
        return x[i]
    from torch.distributed.tensor import Shard
    pls = []
    for pl in x.placements:
        if isinstance(pl, Shard):
            if pl.dim == 0:
                raise ValueError("cannot index a sharded dim")
            pl = Shard(pl.dim - 1)
        pls.append(pl)
    return _rewrap(x, x.to_local()[i], pls, tuple(x.shape[1:]))


def periods_whole(x):
    """A stacked leaf as one model call uses it: where its leading (period)
    dim is sharded — a stacked MoE router, whose period dim the expert
    rule puts on ``model`` — that dim gathered once, its other shards
    kept, so that :func:`select` indexes a local block; anything else as
    it is.  The gather's gradient goes back to the holder's periods alone
    (every model rank computed the same)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.collectives import dtensor_axes, gather_dtensor
    axes = dtensor_axes(x)
    if 0 not in axes:
        return x
    local = gather_dtensor(x, {d: ax for d, ax in axes.items() if d != 0})
    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == 0 else pl
           for pl in x.placements]
    return _rewrap(x, local, pls, tuple(x.shape))


def transpose(x):
    """``x.T`` of a 2-D leaf (the tied head's ``embed.T``); a DTensor's
    local block transposed and its two shard dims swapped."""
    if not is_dtensor(x):
        return x.T
    from torch.distributed.tensor import Shard
    pls = [Shard(1 - pl.dim) if isinstance(pl, Shard) else pl
           for pl in x.placements]
    return _rewrap(x, x.to_local().T, pls, tuple(reversed(x.shape)))


def map_columns(x, fn, dim: int = 1):
    """``fn(block)`` on a weight whose ``dim`` a sharded GEMM keeps over
    ``model``: a 2-D weight's columns (its output channels, ``dim`` 1) or
    an expert weight's experts (``dim`` 0).  For a DTensor, its block with
    every shard gathered but that dim's shard over ``model``, each output
    of ``fn`` returned as a DTensor sharded so (a per-channel quantizer
    then sees every K of its channels and runs on this rank's channels or
    experts alone); for anything else, ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.collectives import dtensor_axes, gather_dtensor
    kept = tuple(a for a in dtensor_axes(x).get(dim, ()) if a == "model")
    outs = fn(gather_dtensor(x, {dim: kept}))
    if not kept:
        return outs
    pls = [Shard(dim) if name in kept else Replicate()
           for name in axis_names(x.device_mesh)]
    return tuple(_rewrap(x, o, pls, tuple(o.shape[:dim]) + (x.shape[dim],)
                         + tuple(o.shape[dim + 1:])) for o in outs)


def vocab_block(table):
    """An embedding table as one model call uses it: a DTensor's column
    (FSDP) shards gathered, its vocab rows kept as they are held (a
    DTensor still where they are sharded); anything else as it is.  The
    lookup and the tied head then gather nothing more."""
    if not is_dtensor(table):
        return table
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.collectives import dtensor_axes, gather_dtensor
    rows = dtensor_axes(table).get(0, ())
    local = gather_dtensor(table, {0: rows})
    if not rows:
        return local
    pls = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
           for pl in table.placements]
    return _rewrap(table, local, pls, tuple(table.shape))


def embed_lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an embedding table held as this rank's block
    (best its :func:`vocab_block`), vocab-parallel: each rank takes the ids
    its rows hold and zeros for the rest, and a sum over the axes that
    shard the rows adds exact zeros to the one value.  ``ids`` are the
    same on those axes (the ``model`` axis; data ranks may hold other
    rows), so no activation crosses a data axis."""
    table = vocab_block(table)
    if not is_dtensor(table):
        return table[ids]
    from repro_torch.dist import collectives as C
    mesh = table.device_mesh
    rows_axes = C.dtensor_axes(table)[0]
    local = table.to_local()
    idx, _ = axes_index(mesh, rows_axes)
    rows = local.shape[0]
    rel = ids - idx * rows
    hit = (rel >= 0) & (rel < rows)
    x = local[rel.clamp(0, rows - 1)]
    x = torch.where(hit[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return C.all_reduce_grad_pass(x, mesh, rows_axes)


def to_dtype(x, dtype: torch.dtype):
    """``x.to(dtype)``, a DTensor's local block converted in place of
    going through DTensor's op dispatch."""
    if x.dtype == dtype:
        return x
    if not is_dtensor(x):
        return x.to(dtype)
    return _rewrap(x, x.to_local().to(dtype), list(x.placements),
                   tuple(x.shape))


def local(x):
    """A DTensor's local block (differentiably); anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def like(ref, block: torch.Tensor):
    """``block`` held as ``ref`` holds its own: a DTensor with ``ref``'s
    placements and global shape where ``ref`` is one (differentiably),
    else ``block`` itself."""
    if not is_dtensor(ref):
        return block
    return _rewrap(ref, block, list(ref.placements), tuple(ref.shape))


def wrap_block(block: torch.Tensor, spec: Spec, mesh, shape):
    """This rank's ``block`` of a tensor of global ``shape`` under
    ``spec``, held as :func:`shard_leaf` holds it: a DTensor where the
    spec names an axis, else the block (then the whole) itself."""
    if not is_sharded(spec):
        return block
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, mesh, spec_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def dtensor_spec(x) -> Spec:
    """The spec a DTensor is held under (one entry a dim); a plain
    tensor's is all None."""
    if not is_dtensor(x):
        return (None,) * x.dim()
    from repro_torch.dist.collectives import dtensor_axes
    axes = dtensor_axes(x)
    return tuple(_entry(axes.get(d, ())) for d in range(x.dim()))


def sharded_axes(x) -> Tuple[str, ...]:
    """The mesh axes a leaf's blocks differ over, in mesh order: those its
    DTensor shards some dim over; none for a plain tensor."""
    if not is_dtensor(x):
        return ()
    from repro_torch.dist.collectives import dtensor_axes
    held = {a for axes in dtensor_axes(x).values() for a in axes}
    return tuple(a for a in axis_names(x.device_mesh) if a in held)


def full_leaf(x):
    """A parameter leaf whole on this rank: a DTensor gathered over every
    mesh dim that shards it (:func:`repro_torch.dist.collectives
    .gather_dtensor`), anything else as it is."""
    if not is_dtensor(x):
        return x
    from repro_torch.dist.collectives import gather_dtensor
    return gather_dtensor(x, {})


def resident_bytes(params: Params) -> int:
    """Bytes this rank holds for a parameter tree: each DTensor's local
    block, each plain tensor whole."""
    total = 0

    def add(_, leaf):
        nonlocal total
        t = leaf.to_local() if is_dtensor(leaf) else leaf
        total += t.numel() * t.element_size()

    _map_with_path(add, params)
    return total


# ---------------------------------------------------------------------------
# The ambient mesh.
# ---------------------------------------------------------------------------

# The meshes of the enclosing use_mesh() blocks, innermost last: the
# reference's thread-resources mesh of ``with mesh:``.
_AMBIENT: List[Any] = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the ambient mesh of the enclosed calls (the
    reference's ``with mesh:``).  Activations there are this data rank's
    rows of the global batch (the serve engine's lanes), so a sharded GEMM
    takes them as its M block and gathers its output over the model axis
    only."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The innermost ambient mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def batch_is_local(mesh) -> bool:
    """Whether ``mesh`` is the ambient mesh, so activations are this data
    rank's rows (a GEMM given the mesh in its context alone takes global
    rows)."""
    return current_mesh() is mesh


def constrain_batch_dim(x: Optional[torch.Tensor]):
    """The reference's layout hint on an activation's batch dim.  It
    changes no value, and the port lays its activations out explicitly
    (the engine's lanes per data rank), so ``x`` comes back unchanged."""
    return x
