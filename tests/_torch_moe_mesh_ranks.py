"""Rank body of ``tests/test_torch_moe_mesh.py``: one of four gloo ranks on
the CPU.  Run as ``python _torch_moe_mesh_ranks.py RANK WORLD PORT
WORKDIR``; reads ``WORKDIR/inputs.pt`` (the smoke MoE models' parameters,
the reference's converted once in the parent, an AdamW state and a batch),
checks the expert-parallel grouped GEMM, the engine and training on a 2x2
and then a 1x4 mesh, and writes what the parent compares to
``WORKDIR/out_RANK.pt``.  Nothing here imports JAX.
"""
import contextlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.dist import shard_gemm as sg  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.quant.qmatmul import quantized_matmul_batched  # noqa: E402
from repro_torch.serve import executor as ex  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402

MESHES = ((2, 2), (1, 4))
# the grouped GEMM: E experts, SEGS sequences of SEG capacity rows
E, SEGS, SEG, KE, NE = 8, 4, 8, 64, 96
BATCH, SEQ = 8, 16
OCFG = dict(lr=1e-3, warmup_steps=1)
ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")


def config(arch, quant="mixed", **kw):
    """A smoke MoE model in fp32 compute (8 experts top-2, 2 kv heads)."""
    return get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", **kw)


def train_config(quant="mixed", bf16_copy=False):
    """Smoke granite for training: 2 microbatches of the global batch, in
    fp32 with no bf16 compute copy (its expert leaves pass the copy's
    65536-element rule) unless ``bf16_copy``."""
    return config("granite-moe-3b-a800m", quant, n_microbatches=2,
                  bf16_cast_params=bf16_copy)


def kernel_inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return {"x": rng.standard_normal((E, SEGS * SEG, KE)).astype(f),
            "w": (rng.standard_normal((E, KE, NE)) / 8).astype(f),
            "g": rng.standard_normal((E, SEGS * SEG, NE)).astype(f),
            "counts": rng.integers(0, SEG + 1, (E, SEGS)).astype(np.int32)}


def engine_requests(vocab):
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


class ExpertLaunches:
    """Every grouped launch's expert count (the kernel's plain version on
    the CPU), while entered."""

    def __enter__(self):
        self.seen = []
        self.inner = fg.fused_gemm_grouped_reference

        def spy(a, b, *args, **kw):
            self.seen.append(int(b.shape[0]))
            return self.inner(a, b, *args, **kw)

        fg.fused_gemm_grouped_reference = spy
        return self

    def __exit__(self, *exc):
        fg.fused_gemm_grouped_reference = self.inner


def _expert_leaf(w, mesh):
    """``w`` (E, K, N) held as an MoE ``wi`` leaf is on ``mesh``."""
    path = ("blocks", "pos0", "moe", "wi")
    return S.shard_leaf(w, S.leaf_spec(path, w, mesh), mesh, "cpu")


def kernel_checks(mesh, out, tag):
    """The grouped GEMM, ragged, at w=8 and w=12 on an expert leaf held at
    rest: the forward on the global rows against the unsharded call, each
    grouped launch's experts; under the ambient mesh (this data rank's
    sequences) the forward and the STE backward on blocks against the
    unsharded call on every row."""
    inp = {k: torch.from_numpy(v) for k, v in kernel_inputs().items()}
    x, w, g, counts = inp["x"], inp["w"], inp["g"], inp["counts"]
    ctx = ExecContext(mesh=mesh)
    wl = _expert_leaf(w, mesh)
    d, n_data = S.axes_index(mesh, S.data_axes(mesh))
    segs = SEGS // n_data
    rows = slice(d * segs * SEG, (d + 1) * segs * SEG)
    cnt = counts[:, d * segs:(d + 1) * segs]
    for bits in (8, 12):
        key = f"{tag}/w{bits}"
        with ExpertLaunches() as spy:
            got = quantized_matmul_batched(x, wl, bits, context=ctx,
                                           counts=counts, seg=SEG)
        out[f"{key}/fwd_equal"] = torch.equal(
            got, quantized_matmul_batched(x, w, bits, counts=counts,
                                          seg=SEG))
        out[f"{key}/fwd_experts"] = spy.seen
        # the backward on blocks, W an autograd leaf held as at rest
        xl = x[:, rows].clone().requires_grad_()
        blk = S.local(wl).detach().clone().requires_grad_()
        with S.use_mesh(mesh), ExpertLaunches() as spy:
            y = quantized_matmul_batched(xl, S.like(wl, blk), bits,
                                         context=ctx, counts=cnt, seg=SEG)
            y.backward(g[:, rows])
        xw = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        y0 = quantized_matmul_batched(xw, ww, bits, counts=counts, seg=SEG)
        y0.backward(g)
        spec = S.leaf_spec(("blocks", "pos0", "moe", "wi"), w, mesh)
        want_dw = S.local_block(ww.grad, spec, mesh)
        out[f"{key}/bwd_experts"] = spy.seen
        out[f"{key}/bwd_fwd_equal"] = torch.equal(y.detach(), y0[:, rows])
        out[f"{key}/dx_equal"] = torch.equal(xl.grad, xw.grad[:, rows])
        out[f"{key}/dx_dead_zero"] = not bool(xl.grad.masked_select(
            ~fg.ragged_row_mask(cnt, SEG, xl.shape[1]).expand_as(xl.grad)
        ).any())
        out[f"{key}/dw_err"] = float((blk.grad - want_dw).abs().max()
                                     / ww.grad.abs().max())
        out[f"{key}/dw_shape"] = tuple(blk.grad.shape)
    # weight_grad alone on the expert leaf: each data rank's dW of this
    # rank's experts from its own rows, reduce-scattered to the leaf's
    # block at rest (its experts, its data rank's K rows)
    parts = [torch.from_numpy(np.random.default_rng(10 + i).standard_normal(
        (E, KE, NE)).astype(np.float32)) for i in range(n_data)]
    es = ("model",)
    got = sg.weight_grad(sg.expert_block(parts[d], es, mesh), wl, {0: es},
                         mesh)
    spec = S.leaf_spec(("blocks", "pos0", "moe", "wi"), w, mesh)
    out[f"{tag}/weight_grad_equal"] = torch.equal(
        got, S.local_block(sum(parts[1:], parts[0]), spec, mesh))


def _serve(cfg, params, mesh):
    reqs = [Request(prompt=p, max_new_tokens=m, temperature=t)
            for p, m, t in engine_requests(cfg.vocab_size)]
    eng = Engine(cfg, params, max_seq=32, batch_size=8, rng_seed=3,
                 device="cpu", mesh=mesh)
    rows = {}
    sample = ex.Executor.sample

    def recording(self, seed, logits, temps, rids, steps):
        for lane, (rid, step) in enumerate(zip(rids, steps)):
            rows.setdefault((int(rid), int(step)), logits[lane].clone())
        return sample(self, seed, logits, temps, rids, steps)

    ex.Executor.sample = recording
    qmatmul.reset_gemm_routes()
    sg.reset_fallbacks()
    try:
        with ExpertLaunches() as spy:
            eng.generate(reqs)
    finally:
        ex.Executor.sample = sample
    res = {"tokens": [r.generated for r in reqs], "logits": rows,
           "experts": sorted(set(spy.seen)), "routes": qmatmul.gemm_routes(),
           "fallbacks": sg.fallback_counts()}
    if mesh is not None:
        res["data_rank"] = eng.pool.data_rank
        res["blocks_ok"] = all(
            tuple(S.local(t).shape) == tuple(
                S.local_block(ref, S.leaf_spec(p, ref, mesh), mesh).shape)
            for (p, t), (_, ref) in zip(_paths(eng.params), _paths(params)))
    return res


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


def engine_checks(mesh, out, tag, inputs):
    for arch in ARCHS:
        cfg = config(arch)
        params = inputs[f"params/{arch}"]
        got = _serve(cfg, params, mesh)
        got["plain"] = _serve(cfg, params, None)
        out[f"{tag}/engine/{arch}"] = got


def metrics_check(mesh, out, tag, inputs):
    """The MoE dispatch metrics of a 2x2 engine run: each rank's registry
    observes its own data rank's dispatches (E observations a lane a
    period), its parking-row prefills none."""
    from repro_torch.obs import metrics
    cfg = config(ARCHS[0])
    calls = {"prefill": 0, "lanes": 0}
    prefill, decode = ex.Executor.prefill, ex.Executor.decode

    def counted_prefill(self, slot, *a, **kw):
        calls["prefill"] += slot is not None
        return prefill(self, slot, *a, **kw)

    def counted_decode(self, lanes, *a, **kw):
        calls["lanes"] += len(lanes)
        return decode(self, lanes, *a, **kw)

    ex.Executor.prefill, ex.Executor.decode = counted_prefill, counted_decode
    metrics.reset()
    metrics.enable()
    try:
        _serve(cfg, inputs[f"params/{ARCHS[0]}"], mesh)
        snap = metrics.snapshot()["repro_moe_tokens_per_expert"]["values"]
    finally:
        metrics.disable()
        metrics.reset()
        ex.Executor.prefill, ex.Executor.decode = prefill, decode
    out[f"{tag}/metrics"] = {"counts": {k: v["count"] for k, v in
                                        snap.items()},
                             "sums": {k: v["sum"] for k, v in snap.items()},
                             "calls": calls,
                             "per_lane": cfg.n_experts * cfg.n_periods}


def indivisible_check(mesh, out, tag):
    """Smoke granite with 6 experts on a mesh whose model axis (4) does not
    divide them: every grouped GEMM on the ATen route, counted, the tokens
    and logits the unsharded engine's."""
    cfg = config(ARCHS[0], n_experts=6)
    params = lm.init_params(torch.Generator().manual_seed(4), cfg,
                            device="cpu")
    got = _serve(cfg, params, mesh)
    got["plain"] = _serve(cfg, params, None)
    out[f"{tag}/indivisible"] = got


class AuxRecord:
    """Every load-balance loss the step computes, by call, while
    entered."""

    def __enter__(self):
        self.vals = []
        self.inner = moe.load_balance_loss

        def spy(r, n):
            v = self.inner(r, n)
            if not moe._in_backward():      # not a remat recompute
                self.vals.append(float(v.detach()))
            return v

        moe.load_balance_loss = spy
        return self

    def __exit__(self, *exc):
        moe.load_balance_loss = self.inner


def step_checks(mesh, out, tag, inputs, bf16_copy=False):
    """Step 1 from the reference's params and AdamW state, carried onto
    the mesh through the bridge; its aux losses, gradients and update, and
    the same step without a mesh, from the same inputs."""
    cfg = train_config(bf16_copy=bf16_copy)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    step = steps.make_train_step(cfg, optim.AdamWConfig(**OCFG))
    res = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        params = bridge.params_from_jax(inputs["train_params"], "cpu", m)
        state = bridge.opt_state_from_jax(inputs["train_state"], "cpu", m)
        qmatmul.reset_gemm_routes()
        with (S.use_mesh(m) if m is not None else contextlib.nullcontext()), \
                AuxRecord() as aux, ExpertLaunches() as spy:
            loss, grads = steps.mean_loss_and_grads(cfg, params, batch)
            new, new_state, metrics = step(params, state, batch)
        res[label] = {
            "loss": float(metrics["loss"]), "grad_loss": float(loss),
            "aux": aux.vals, "grad_norm": float(metrics["grad_norm"]),
            "grads": whole(grads), "params": whole(new),
            "mu": whole(new_state.mu), "nu": whole(new_state.nu),
            "step": int(new_state.step), "experts": sorted(set(spy.seen)),
            "routes": qmatmul.gemm_routes()}
        if m is not None:
            res[label]["dtensors"] = sum(S.is_dtensor(t) for t in
                                         optim.tree_leaves(params))
    out[f"{tag}/step" + ("_bf16" if bf16_copy else "")] = res


def restart_checks(mesh, out, workdir):
    """2x2: 4 straight steps against 2 steps, a checkpoint and a fresh
    run resuming for 2 more (torch.equal); the step-2 checkpoint is the
    elastic one."""
    cfg = train_config()
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
    cfg = train_config()
    like_p = lm.init_params(torch.Generator().manual_seed(9), cfg,
                            device="cpu", mesh=mesh)
    step, (params, state), _ = ckpt.load(d, (like_p, optim.init(like_p)),
                                         step=2)
    out[f"{tag}/elastic"] = {
        "step": step, "params": whole(params),
        "mu": whole(state.mu), "nu": whole(state.nu),
        "expert_specs": {"/".join(p): S.dtensor_spec(t)
                         for p, t in _paths(params) if "moe" in p}}


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
        kernel_checks(mesh, out, tag)
        engine_checks(mesh, out, tag, inputs)
        step_checks(mesh, out, tag, inputs)
    step_checks(meshes["2x2"], out, "2x2", inputs, bf16_copy=True)
    metrics_check(meshes["2x2"], out, "2x2", inputs)
    indivisible_check(meshes["1x4"], out, "1x4")
    restart_checks(meshes["2x2"], out, workdir)
    for tag in ("1x4", "2x2"):
        elastic_load(meshes[tag], out, tag, out["ckpt_dir"])
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
