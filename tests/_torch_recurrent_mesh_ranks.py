"""Rank body of ``tests/test_torch_recurrent_mesh.py``: one of four gloo
ranks on the CPU.  Run as ``python _torch_recurrent_mesh_ranks.py RANK
WORLD PORT WORKDIR``; reads ``WORKDIR/inputs.pt`` (the smoke recurrent
models' parameters, the reference's converted once in the parent, their
training parameters with an AdamW state, and a batch), checks the engine
and training of rwkv6-3b and jamba on a 2x2 and then a 1x4 mesh, and
writes what the parent compares to ``WORKDIR/out_RANK.pt``.  Nothing here
imports JAX.
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
from repro_torch.dist import shard_gemm as sg  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels import ssm_scan as scan  # noqa: E402
from repro_torch.kernels import wkv_gemm as wkv  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.serve import executor as ex  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402

MESHES = ((2, 2), (1, 4))
ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")
BATCH, SEQ = 8, 16
OCFG = dict(lr=1e-3, warmup_steps=1)
# The bf16 compute copy casts only leaves of more than 65536 elements: a
# channel-mix / dense MLP this wide passes the rule at smoke widths.
BF16_D_FF = 2048


def config(arch, quant="mixed", **kw):
    """A smoke recurrent model in fp32 compute: rwkv6-3b 4 heads of 16;
    jamba one period of 7 mamba layers (d_inner 128), 1 attention layer (2
    kv heads) and 4 MoE layers of 4 experts."""
    return get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", **kw)


def train_config(arch, quant="mixed", bf16_copy=False):
    """The training config: 2 microbatches of the global batch, in fp32
    with no bf16 compute copy unless ``bf16_copy`` (then the MLPs widened
    to :data:`BF16_D_FF`, so that the copy casts something)."""
    kw = dict(d_ff=BF16_D_FF) if bf16_copy else {}
    return config(arch, quant, n_microbatches=2,
                  bf16_cast_params=bf16_copy, **kw)


def engine_requests(vocab):
    import numpy as np
    rng = np.random.default_rng(7)
    return [(list(int(t) for t in rng.integers(1, vocab, size=int(n))),
             int(m), t)
            for n, m, t in zip(rng.integers(2, 9, size=6),
                               rng.integers(3, 7, size=6),
                               (0.0, 0.8, 0.0, 0.7, 0.0, 0.9))]


def data_config(cfg, seed=3):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=seed)


def whole(tree):
    """A sharded tree gathered whole (a collective on every rank)."""
    return optim.tree_map(lambda t: S.full_leaf(t).detach().clone(), tree)


class Launches:
    """The operand widths of every recurrence launch (the kernels' plain
    versions on the CPU), while entered: the heads of each WKV forward
    and backward, the channels of each scan forward and backward, the
    experts of each grouped GEMM."""

    SPIED = ((wkv, "wkv_stateful_reference", "wkv", lambda a: a[0].shape[2]),
             (wkv, "wkv_vjp_reference", "wkv_bwd", lambda a: a[0].shape[2]),
             (scan, "ssm_scan_reference", "ssm_scan",
              lambda a: a[0].shape[2]),
             (scan, "ssm_scan_vjp_reference", "ssm_scan_bwd",
              lambda a: a[0].shape[2]),
             (fg, "fused_gemm_grouped_reference", "grouped",
              lambda a: a[1].shape[0]))

    def __enter__(self):
        self.seen = {key: set() for _, _, key, _ in self.SPIED}
        self.saved = []
        for mod, name, key, width in self.SPIED:
            inner = getattr(mod, name)
            self.saved.append((mod, name, inner))

            def spy(*a, _inner=inner, _key=key, _width=width, **kw):
                self.seen[_key].add(int(_width(a)))
                return _inner(*a, **kw)

            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, inner in self.saved:
            setattr(mod, name, inner)

    def widths(self):
        return {k: sorted(v) for k, v in self.seen.items()}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


def _serve(cfg, params, mesh, whole_params=None):
    """The engine's run; under ``mesh`` with each leaf checked against its
    block of ``whole_params`` (default: ``params``)."""
    reqs = [Request(prompt=p, max_new_tokens=m, temperature=t)
            for p, m, t in engine_requests(cfg.vocab_size)]
    eng = Engine(cfg, params, max_seq=32, batch_size=8, rng_seed=3,
                 device="cpu", mesh=mesh)
    rows = {}
    sample = ex.Executor.sample

    def recording(self, seed, logits, temps, rids, steps_):
        for lane, (rid, step) in enumerate(zip(rids, steps_)):
            rows.setdefault((int(rid), int(step)), logits[lane].clone())
        return sample(self, seed, logits, temps, rids, steps_)

    ex.Executor.sample = recording
    qmatmul.reset_gemm_routes()
    sg.reset_fallbacks()
    try:
        with Launches() as spy:
            eng.generate(reqs)
    finally:
        ex.Executor.sample = sample
    res = {"tokens": [r.generated for r in reqs], "logits": rows,
           "widths": spy.widths(), "routes": qmatmul.gemm_routes(),
           "fallbacks": sg.fallback_counts(),
           "pool": {f"{pos}/{name}": tuple(t.shape)
                    for pos, leaves in eng.pool.pools.items()
                    for name, t in leaves.items()},
           "pool_global": {f"{pos}/{name}": tuple(shape)
                           for pos, leaves in eng.pool.global_shapes.items()
                           for name, shape in leaves.items()}}
    if mesh is not None:
        res["data_rank"] = eng.pool.data_rank
        # each leaf a copy of its leaf_spec block alone
        res["blocks_ok"] = all(
            torch.equal(S.local(t), S.local_block(
                ref, S.leaf_spec(p, ref, mesh), mesh))
            for (p, t), (_, ref) in zip(
                _paths(eng.params),
                _paths(params if whole_params is None else whole_params)))
    return res


def engine_checks(mesh, out, tag, inputs):
    for arch in ARCHS:
        cfg = config(arch)
        params = inputs[f"params/{arch}"]
        got = _serve(cfg, params, mesh)
        got["plain"] = _serve(cfg, params, None)
        out[f"{tag}/engine/{arch}"] = got


def drawn_checks(mesh, out, tag):
    """Each rank's records drawn leaf by leaf as its blocks
    (``lm.init_params(mesh=..., prequant=)``, no rank holding the whole
    model) served under ``mesh`` against the unsharded engine on the whole
    records from the same generator; the resident bytes those the specs
    place."""
    for arch in ARCHS:
        cfg = config(arch)
        drawn = lm.init_params(torch.Generator().manual_seed(2), cfg,
                               device="cpu", prequant=cfg.quant, mesh=mesh)
        whole_ = lm.init_params(torch.Generator().manual_seed(2), cfg,
                                device="cpu", prequant=cfg.quant)
        got = _serve(cfg, drawn, mesh, whole_)
        got["plain"] = _serve(cfg, whole_, None)
        got["resident"] = S.resident_bytes(drawn)
        got["planned"] = steps.local_bytes(
            steps.abstract_params(cfg, mesh, prequant=True), mesh)
        out[f"{tag}/drawn/{arch}"] = got


def indivisible_check(mesh, out, tag, inputs):
    """A smoke rwkv6-3b of 3 heads on a mesh whose model axis (2) does not
    divide them: every rank runs all 3 heads on its whole ``wkv`` state,
    in serving and in training, with the unsharded tokens and
    gradients."""
    cfg = config(ARCHS[0], d_model=48, d_ff=96)
    params = lm.init_params(torch.Generator().manual_seed(4), cfg,
                            device="cpu")
    got = _serve(cfg, params, mesh)
    got["plain"] = _serve(cfg, params, None)
    tcfg = train_config(ARCHS[0]).scaled_down(d_model=48, d_ff=96)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    res = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        p = lm.init_params(torch.Generator().manual_seed(4), tcfg,
                           device="cpu", mesh=m)
        with (S.use_mesh(m) if m is not None else contextlib.nullcontext()), \
                Launches() as spy:
            loss, grads = steps.mean_loss_and_grads(tcfg, p, batch)
        res[label] = {"loss": float(loss), "grads": whole(grads),
                      "widths": spy.widths()}
    got["step"] = res
    out[f"{tag}/indivisible"] = got


def step_checks(mesh, out, tag, inputs, arch, bf16_copy=False):
    """Step 1 from the reference's params and AdamW state, carried onto
    the mesh through the bridge; its gradients and update, and the same
    step without a mesh, from the same inputs."""
    cfg = train_config(arch, bf16_copy=bf16_copy)
    suffix = "/bf16" if bf16_copy else ""
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    step = steps.make_train_step(cfg, optim.AdamWConfig(**OCFG))
    res = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        params = bridge.params_from_jax(
            inputs[f"train_params/{arch}{suffix}"], "cpu", m)
        state = bridge.opt_state_from_jax(
            inputs[f"train_state/{arch}{suffix}"], "cpu", m)
        qmatmul.reset_gemm_routes()
        with (S.use_mesh(m) if m is not None else contextlib.nullcontext()), \
                Launches() as spy:
            loss, grads = steps.mean_loss_and_grads(cfg, params, batch)
            new, new_state, metrics = step(params, state, batch)
        res[label] = {
            "loss": float(metrics["loss"]), "grad_loss": float(loss),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": whole(grads), "params": whole(new),
            "mu": whole(new_state.mu), "nu": whole(new_state.nu),
            "step": int(new_state.step), "widths": spy.widths(),
            "routes": qmatmul.gemm_routes()}
        if m is not None:
            res[label]["dtensors"] = sum(S.is_dtensor(t) for t in
                                         optim.tree_leaves(params))
    out[f"{tag}/step/{arch}{suffix}"] = res


RESTART_ARCH = ARCHS[1]


def restart_checks(mesh, out, workdir):
    """2x2, jamba: 4 straight steps against 2 steps, a checkpoint and a
    fresh run resuming for 2 more (torch.equal); the step-2 checkpoint is
    the elastic one."""
    cfg = train_config(RESTART_ARCH)
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
    out["restart/first_state"] = {"mu": whole(first.opt_state.mu),
                                  "nu": whole(first.opt_state.nu)}
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
    """The 2x2 run's step-2 checkpoint read on this mesh: each rank's
    blocks of the saved logical arrays, gathered."""
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
    for tag, mesh in meshes.items():
        engine_checks(mesh, out, tag, inputs)
        drawn_checks(mesh, out, tag)
        for arch in ARCHS:
            step_checks(mesh, out, tag, inputs, arch)
    for arch in ARCHS:
        step_checks(meshes["2x2"], out, "2x2", inputs, arch, bf16_copy=True)
    indivisible_check(meshes["2x2"], out, "2x2", inputs)
    restart_checks(meshes["2x2"], out, workdir)
    elastic_load(meshes["1x4"], out, "1x4", out["ckpt_dir"])
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
