"""Rank body of ``tests/test_torch_train_mesh.py``: one of four gloo ranks
on the CPU.  Run as ``python _torch_train_mesh_ranks.py RANK WORLD PORT
WORKDIR``; reads ``WORKDIR/inputs.pt`` (the reference's parameters and
AdamW state as numpy, the batch), trains the smoke llama under a 2x2, a
4x1 and a 1x4 mesh, and writes what the parent compares to
``WORKDIR/out_RANK.pt``.  Nothing here imports JAX.
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataIterator  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402

MESHES = ((2, 2), (4, 1), (1, 4))
BATCH, SEQ = 8, 16
OCFG = dict(lr=1e-3, warmup_steps=1)


def config(quant):
    """The smoke llama in fp32 compute, 2 microbatches (the reference
    test's ``_configs``)."""
    return get_config("llama3.2-1b", smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", n_microbatches=2)


def bf16_config():
    """The smoke llama widened so that its matrices pass the compute copy's
    65536-element rule: bf16 compute, bf16 copy on, under mixed."""
    return get_config("llama3.2-1b", smoke=True, quant="mixed").scaled_down(
        d_model=256, d_ff=512, head_dim=64, n_microbatches=2)


def data_config(cfg, seed=3):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=seed)


def train_batch(cfg, step=2):
    return {k: torch.from_numpy(v)
            for k, v in DataIterator(data_config(cfg)).peek(step).items()}


def whole(tree):
    """A sharded tree gathered whole (a collective on every rank)."""
    return optim.tree_map(lambda t: S.full_leaf(t).clone(), tree)


def state_whole(state):
    return {"step": state.step, "mu": whole(state.mu), "nu": whole(state.nu)}


def init_check(mesh, out, tag):
    """Init under the mesh: every leaf a block of the unsharded init's, the
    blocks' bytes those the abstract specs place, params + mu + nu."""
    cfg = config("mixed")
    sharded = lm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu", mesh=mesh)
    plain = lm.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    out[f"{tag}/init_equal"] = all(
        torch.equal(S.full_leaf(a), b) for a, b in zip(
            optim.tree_leaves(sharded), optim.tree_leaves(plain)))
    state = optim.init(sharded)
    abs_p = steps.abstract_params(cfg, mesh)
    abs_s = steps.abstract_opt_state(abs_p, mesh)
    out[f"{tag}/resident"] = S.resident_bytes(
        {"p": sharded, "mu": state.mu, "nu": state.nu})
    out[f"{tag}/planned"] = steps.local_bytes((abs_p, abs_s.mu, abs_s.nu),
                                              mesh)
    out[f"{tag}/whole"] = S.resident_bytes(
        {"p": plain, "mu": plain, "nu": plain})
    out[f"{tag}/dtensors"] = sum(S.is_dtensor(t)
                                 for t in optim.tree_leaves(sharded))


def step_vs_reference(mesh, out, tag, inputs):
    """Step 1 from the reference's params and state, carried over through
    the bridge onto the mesh: loss, grad norm, gradients, new params."""
    for quant in ("none", "mixed"):
        cfg = config(quant)
        params = bridge.params_from_jax(inputs["params"], "cpu", mesh)
        state = bridge.opt_state_from_jax(inputs["state"], "cpu", mesh)
        batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
        step = steps.make_train_step(cfg, optim.AdamWConfig(**OCFG))
        with S.use_mesh(mesh):
            loss, grads = steps.mean_loss_and_grads(cfg, params, batch)
            new, new_state, metrics = step(params, state, batch)
        out[f"{tag}/{quant}/loss"] = float(metrics["loss"])
        out[f"{tag}/{quant}/grad_loss"] = float(loss)
        out[f"{tag}/{quant}/grad_norm"] = float(metrics["grad_norm"])
        out[f"{tag}/{quant}/grads"] = whole(grads)
        out[f"{tag}/{quant}/params"] = whole(new)
        out[f"{tag}/{quant}/state"] = bridge.opt_state_to_numpy(new_state)


def step_vs_unsharded(mesh, out, tag):
    """Step 1 with the bf16 copy on, against the unsharded port."""
    cfg = bf16_config()
    plain = lm.init_params(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    params = lm.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu", mesh=mesh)
    batch = train_batch(cfg)
    step = steps.make_train_step(cfg, optim.AdamWConfig(**OCFG))
    loss0, grads0 = steps.mean_loss_and_grads(cfg, plain, batch)
    with S.use_mesh(mesh):
        loss, grads = steps.mean_loss_and_grads(cfg, params, batch)
        _, _, metrics = step(params, optim.init(params), batch)
    _, _, metrics0 = step(plain, optim.init(plain), batch)
    dist_ = {}
    for (name, g), (_, g0) in zip(_named(whole(grads)), _named(grads0)):
        dist_[name] = float((g - g0).abs().max() / g0.abs().max())
    out[f"{tag}/bf16"] = {"loss": float(loss), "loss0": float(loss0),
                          "grad_norm": float(metrics["grad_norm"]),
                          "grad_norm0": float(metrics0["grad_norm"]),
                          "grad_dist": dist_}


def _named(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


def restart_checks(mesh, out, workdir):
    """2x2: 4 straight steps against 2 steps, a checkpoint and a fresh run
    resuming for 2 more (torch.equal); the step-2 checkpoint is the
    elastic one."""
    cfg = config("mixed")
    dcfg = data_config(cfg, seed=0)
    ocfg = optim.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    straight = run_training(cfg, TrainConfig(steps=4, log_every=1,
                                             optimizer=ocfg), dcfg,
                            device="cpu", mesh=mesh)
    d = os.path.join(workdir, "ck_restart")
    first = run_training(cfg, TrainConfig(steps=2, ckpt_dir=d, ckpt_every=2,
                                          optimizer=ocfg), dcfg,
                         device="cpu", mesh=mesh)
    out["restart/first_params"] = whole(first.params)
    out["restart/first_state"] = state_whole(first.opt_state)
    resumed = run_training(cfg, TrainConfig(steps=4, ckpt_dir=d,
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
        for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b))) and \
        torch.equal(straight.opt_state.step, resumed.opt_state.step)
    out["restart/resident"] = straight.resident_bytes
    out["restart/planned"] = straight.planned_bytes
    out["ckpt_dir"] = d


def elastic_load(mesh, out, tag, d):
    """The 2x2 run's step-2 checkpoint read on this mesh: each rank's blocks
    of the saved logical arrays, gathered."""
    cfg = config("mixed")
    like_p = lm.init_params(torch.Generator().manual_seed(9), cfg,
                            device="cpu", mesh=mesh)
    like = (like_p, optim.init(like_p))
    step, (params, state), _ = ckpt.load(d, like, step=2)
    out[f"{tag}/elastic"] = {"step": step, "params": whole(params),
                             "state": state_whole(state),
                             "dtensors": sum(S.is_dtensor(t) for t in
                                             optim.tree_leaves(params))}


def fault_checks(mesh, out, workdir):
    """A fault on every rank at step 1, then a resume; a fault on rank 3
    alone raises on every rank."""
    cfg = config("mixed")
    dcfg = data_config(cfg, seed=0)
    d = os.path.join(workdir, "ck_fault")
    tc = TrainConfig(steps=3, ckpt_dir=d, ckpt_every=1)

    def every(step):
        if step == 1:
            raise RuntimeError("injected")

    try:
        run_training(cfg, tc, dcfg, {"inject_fault": every}, device="cpu",
                     mesh=mesh)
        out["fault/raised"] = None
    except RuntimeError as e:
        out["fault/raised"] = str(e)
    out["fault/latest"] = ckpt.latest_step(d, mesh=mesh)
    res = run_training(cfg, tc, dcfg, device="cpu", mesh=mesh)
    out["fault/resumed"] = (res.restored_from, res.final_step)

    def one(step):
        if step == 0 and dist.get_rank() == 3:
            raise RuntimeError("injected on rank 3")

    try:
        run_training(cfg, dataclasses.replace(tc, ckpt_dir=None), dcfg,
                     {"inject_fault": one}, device="cpu", mesh=mesh)
        out["fault/one"] = None
    except RuntimeError as e:
        out["fault/one"] = str(e)


def refusals(mesh, out):
    """A global batch that does not split over microbatches x data ranks."""
    cfg = config("mixed")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu", mesh=mesh)
    batch = {k: v[:6] for k, v in train_batch(cfg).items()}
    try:
        with S.use_mesh(mesh):
            steps.mean_loss_and_grads(cfg, params, batch)
        out["refusal/batch"] = None
    except ValueError as e:
        out["refusal/batch"] = str(e)


def moe_checks(meshes, out):
    """Smoke granite trains under ``run_training(mesh=)`` on 2x2 (its
    experts over ``model``); with 6 experts on 1x4 (4 does not divide them)
    its grouped GEMMs take the ATen route, counted, and step 1's loss and
    every gradient leaf (the expert leaves' dW, and dx through the loss in
    the leaves upstream) are held to the meshless one's."""
    from repro_torch.dist import shard_gemm as sg
    from repro_torch.quant import qmatmul
    cfg = get_config("granite-moe-3b-a800m", smoke=True,
                     quant="mixed").scaled_down(compute_dtype="float32")
    res = run_training(cfg, TrainConfig(steps=2, log_every=1), data_config(
        cfg, seed=0), device="cpu", mesh=meshes["2x2"])
    out["moe/losses"] = res.losses
    out["moe/resident"] = (res.resident_bytes, res.planned_bytes)
    # without the bf16 compute copy, whose gradients round to bf16 (one ulp
    # is up to 2^-8 of an entry): the gradients are compared at fp32's
    # tolerance
    odd = cfg.scaled_down(n_experts=6, bf16_cast_params=False)
    params = lm.init_params(torch.Generator().manual_seed(0), odd,
                            device="cpu")
    batch = train_batch(odd)
    loss0, grads0 = steps.mean_loss_and_grads(odd, params, batch)
    mesh = meshes["1x4"]
    sharded = bridge.params_from_jax(bridge.tree_to_numpy(params), "cpu",
                                     mesh)
    qmatmul.reset_gemm_routes()
    sg.reset_fallbacks()
    with S.use_mesh(mesh):
        loss, grads = steps.mean_loss_and_grads(odd, sharded, batch)
    routes, fallbacks = qmatmul.gemm_routes(), sg.fallback_counts()
    grad_dist = {name: float((g - g0).abs().max() / g0.abs().max())
                 for (name, g), (_, g0) in zip(_named(whole(grads)),
                                               _named(grads0))}
    out["moe/odd"] = {"loss": float(loss), "loss0": float(loss0),
                      "routes": routes, "fallbacks": fallbacks,
                      "grad_dist": grad_dist}


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
    for tag, mesh in meshes.items():
        init_check(mesh, out, tag)
        step_vs_reference(mesh, out, tag, inputs)
    step_vs_unsharded(meshes["2x2"], out, "2x2")
    restart_checks(meshes["2x2"], out, workdir)
    for tag in ("2x2", "1x4"):
        elastic_load(meshes[tag], out, tag, out["ckpt_dir"])
    fault_checks(meshes["2x2"], out, workdir)
    refusals(meshes["2x2"], out)
    moe_checks(meshes, out)
    keep = out if rank == 0 else {k: v for k, v in out.items()
                                  if not isinstance(v, dict) or k == "coord"
                                  or k.startswith("moe/")}
    torch.save(keep, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
