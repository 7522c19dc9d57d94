"""Rank body of ``tests/test_torch_frontend_mesh.py``: one of four gloo
ranks on the CPU.  Run as ``python _torch_frontend_mesh_ranks.py RANK
WORLD PORT WORKDIR``; reads ``WORKDIR/inputs.pt`` (the reference's
parameters of smoke llava and seamless with an AdamW state, their global
batches and serve inputs, as numpy), trains and serves both on a 2x2, a
4x1 and a 1x4 mesh and writes what the parent compares to
``WORKDIR/out_RANK.pt``.  Nothing here imports JAX.
"""
import contextlib
import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402

MESHES = ((2, 2), (4, 1), (1, 4))
ARCHS = ("llava-next-mistral-7b", "seamless-m4t-medium")
BATCH, SEQ = 8, 16
OCFG = dict(lr=1e-3, warmup_steps=1)
# serving: 4 streams of PROMPT tokens (after llava's 8 patch embeddings;
# beside seamless's FRAMES frames), then NEW greedy steps
STREAMS, PROMPT, FRAMES, NEW, MAX_SEQ = 4, 8, 16, 3, 32
RESTART_ARCH = ARCHS[1]       # the projector, the encoder and xattn leaves


def config(arch, quant="mixed", **kw):
    """Smoke llava (8 patch embeddings of 32, 2 kv heads) or seamless (2 +
    2 periods, 4 kv heads, 32-wide frames) in fp32 compute, without the
    bf16 compute copy."""
    return get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", bf16_cast_params=False, **kw)


def train_config(arch, quant="mixed"):
    return config(arch, quant, n_microbatches=2)


def data_config(cfg, seed=3):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, frontend=cfg.frontend,
                      frontend_dim=cfg.frontend_dim,
                      frontend_tokens=cfg.frontend_tokens,
                      encdec=cfg.is_encdec, seed=seed)


def whole(tree):
    """A sharded tree gathered whole (a collective on every rank)."""
    return optim.tree_map(lambda t: S.full_leaf(t).detach().clone(), tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


def _ambient(mesh):
    return S.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def data_rows(mesh, n):
    """This data rank's rows of ``n`` (all of them without a mesh)."""
    if mesh is None:
        return slice(0, n)
    d, size = S.axes_index(mesh, S.data_axes(mesh))
    return slice(d * n // size, (d + 1) * n // size)


def cache_blocks(cfg, batch, mesh):
    """A zeroed decode cache of ``batch`` slots, this rank's block of each
    leaf under ``cache_sharding`` (the whole cache without a mesh)."""
    metas = lm.init_cache(cfg, batch, MAX_SEQ, device="meta")
    if mesh is None:
        return lm.init_cache(cfg, batch, MAX_SEQ, device="cpu")
    specs = S.cache_sharding(metas, mesh, batch=batch)
    return optim.tree_map(lambda m, s: torch.zeros(
        S.local_block(m, s, mesh).shape, dtype=m.dtype), metas, specs)


def serve(cfg, params, inputs, mesh):
    """``lm.prefill`` of the streams (llava: the patch embeddings, then the
    prompt; seamless: the frames to the memory, then the prompt) and NEW
    greedy ``decode_step``s on this data rank's rows: their tokens, every
    logits row, and the memory's shape."""
    rows = data_rows(mesh, STREAMS)
    held = params if mesh is None else S.shard_params(params, mesh, "cpu")
    extra = {k: torch.from_numpy(v)[rows] for k, v in inputs.items()
             if k != "tokens"}
    tokens = torch.from_numpy(inputs["tokens"])[rows]
    cache = cache_blocks(cfg, STREAMS, mesh)
    with _ambient(mesh), torch.no_grad():
        logits, cache, mem = lm.prefill(held, cfg, tokens, cache, **extra)
        out = {"logits": [logits.clone()], "tokens": [logits.argmax(-1)]}
        t = PROMPT + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        for _ in range(NEW):
            logits, cache = lm.decode_step(held, cfg, out["tokens"][-1],
                                           cache, t, mem=mem)
            out["logits"].append(logits.clone())
            out["tokens"].append(logits.argmax(-1))
            t += 1
    out["mem_shape"] = None if mem is None else tuple(mem["pos0"][0].shape)
    out["cache_kv_heads"] = cache["pos0"]["k"].shape[3]
    return out


def serve_checks(mesh, out, tag, inputs, plain):
    """Both models served under ``mesh`` and without it (``plain``: the
    unsharded runs by (arch, quant), made once for the three meshes), under
    mixed and quant none (the latter also against the reference's meshless
    serve in the parent)."""
    for arch in ARCHS:
        for quant in ("mixed", "none"):
            cfg = config(arch, quant)
            params = bridge.params_from_jax(inputs[f"params/{arch}"])
            got = serve(cfg, params, inputs[f"serve/{arch}"], mesh)
            if (arch, quant) not in plain:
                plain[arch, quant] = serve(cfg, params,
                                           inputs[f"serve/{arch}"], None)
            got["plain"] = plain[arch, quant]
            got["rows"] = (data_rows(mesh, STREAMS).start,
                           data_rows(mesh, STREAMS).stop)
            out[f"{tag}/serve/{arch}/{quant}"] = got


def init_checks(mesh, out, tag):
    """Each rank's blocks drawn leaf by leaf (``init_params(mesh=)``), the
    projector's, the encoder's and the cross-attention's among them: each a
    copy of its ``leaf_spec`` block of the unsharded init from the same
    generator, and the bytes the abstract specs place."""
    for arch in ARCHS:
        cfg = train_config(arch)
        drawn = lm.init_params(torch.Generator().manual_seed(2), cfg,
                               device="cpu", mesh=mesh)
        ref = lm.init_params(torch.Generator().manual_seed(2), cfg,
                             device="cpu")
        bad, sharded = [], []
        for (p, t), (_, r) in zip(_paths(drawn), _paths(ref)):
            if not torch.equal(S.local(t), S.local_block(
                    r, S.leaf_spec(p, r, mesh), mesh)):
                bad.append("/".join(p))
            if S.is_dtensor(t):
                sharded.append("/".join(p))
        out[f"{tag}/init/{arch}"] = {
            "bad": bad, "sharded": sharded,
            "resident": S.resident_bytes(drawn),
            "planned": steps.local_bytes(steps.abstract_params(cfg, mesh),
                                         mesh)}


def step_checks(mesh, out, tag, inputs, arch, plain=None):
    """Step 1 from the reference's params and AdamW state, carried onto the
    mesh through the bridge (mixed: the whole step; quant none: the mean
    loss and gradient, for the reference's oracle), with its gradients'
    widths; ``plain`` (no mesh) computed once for the three meshes."""
    batch = {k: torch.from_numpy(v)
             for k, v in inputs[f"batch/{arch}"].items()}
    res = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        if label == "plain" and plain is not None:
            res[label] = plain
            continue
        cfg = train_config(arch)
        step = steps.make_train_step(cfg, optim.AdamWConfig(**OCFG))
        params = bridge.params_from_jax(inputs[f"train_params/{arch}"],
                                        "cpu", m)
        state = bridge.opt_state_from_jax(inputs[f"train_state/{arch}"],
                                          "cpu", m)
        qmatmul.reset_gemm_routes()
        with _ambient(m):
            loss, grads = steps.mean_loss_and_grads(cfg, params, batch)
            new, new_state, metrics = step(params, state, batch)
            loss_n, grads_n = steps.mean_loss_and_grads(
                train_config(arch, "none"), params, batch)
        res[label] = {
            "loss": float(metrics["loss"]), "grad_loss": float(loss),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": whole(grads), "params": whole(new),
            "mu": whole(new_state.mu), "nu": whole(new_state.nu),
            "step": int(new_state.step), "routes": qmatmul.gemm_routes(),
            "none": {"loss": float(loss_n), "grads": whole(grads_n)}}
        if m is not None:
            res[label]["dtensors"] = sorted(
                "/".join(p) for p, t in _paths(params) if S.is_dtensor(t))
    out[f"{tag}/step/{arch}"] = res
    return res["plain"]


def restart_checks(mesh, out, workdir):
    """2x2, seamless: 3 straight steps against 2 steps, a checkpoint and a
    fresh run resuming for 1 more (``torch.equal``); the step-2 checkpoint
    is the elastic one."""
    cfg = train_config(RESTART_ARCH)
    dcfg = data_config(cfg, seed=0)
    ocfg = optim.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    straight = run_training(cfg, TrainConfig(steps=3, log_every=1,
                                             optimizer=ocfg), dcfg,
                            device="cpu", mesh=mesh)
    d = os.path.join(workdir, "ck_restart")
    first = run_training(cfg, TrainConfig(steps=2, ckpt_dir=d, ckpt_every=2,
                                          optimizer=ocfg), dcfg,
                         device="cpu", mesh=mesh)
    out["restart/first_params"] = whole(first.params)
    out["restart/first_state"] = {"mu": whole(first.opt_state.mu),
                                  "nu": whole(first.opt_state.nu)}
    resumed = run_training(cfg, TrainConfig(steps=3, ckpt_dir=d,
                                            log_every=1, ckpt_keep=3,
                                            optimizer=ocfg), dcfg,
                           device="cpu", mesh=mesh)
    out["restart/restored_from"] = resumed.restored_from
    out["restart/losses"] = (straight.losses, resumed.losses)
    a = {"p": straight.params, "mu": straight.opt_state.mu,
         "nu": straight.opt_state.nu}
    b = {"p": resumed.params, "mu": resumed.opt_state.mu,
         "nu": resumed.opt_state.nu}
    out["restart/equal"] = all(
        torch.equal(S.local(x), S.local(y))
        for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b)))
    out["ckpt_dir"] = d


def elastic_load(mesh, out, tag, d):
    """The 2x2 run's step-2 checkpoint read on this mesh: each rank's
    blocks of the saved logical arrays, gathered, and their specs."""
    cfg = train_config(RESTART_ARCH)
    like_p = lm.init_params(torch.Generator().manual_seed(9), cfg,
                            device="cpu", mesh=mesh)
    step, (params, state), _ = ckpt.load(d, (like_p, optim.init(like_p)),
                                         step=2)
    out[f"{tag}/elastic"] = {
        "step": step, "params": whole(params),
        "mu": whole(state.mu), "nu": whole(state.nu),
        "specs": {"/".join(p): S.dtensor_spec(t)
                  for p, t in _paths(params)}}


def main(rank, world, port, workdir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = {}
    meshes = {f"{d}x{m}": make_mesh((d, m), device="cpu")
              for d, m in MESHES}
    out["coord"] = {tag: S.coordinate(m) for tag, m in meshes.items()}
    plain, plain_serve = {}, {}
    for tag, mesh in meshes.items():
        init_checks(mesh, out, tag)
        serve_checks(mesh, out, tag, inputs, plain_serve)
        for arch in ARCHS:
            plain[arch] = step_checks(mesh, out, tag, inputs, arch,
                                      plain.get(arch))
    restart_checks(meshes["2x2"], out, workdir)
    elastic_load(meshes["1x4"], out, "1x4", out["ckpt_dir"])
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
