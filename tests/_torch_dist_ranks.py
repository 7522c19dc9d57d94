"""Rank body of ``tests/test_torch_dist_serve.py``: one of four gloo ranks
on the CPU.  Run as ``python _torch_dist_ranks.py RANK WORLD PORT WORKDIR``;
reads ``WORKDIR/inputs.pt`` (the engine's parameters, converted from the
reference's once in the parent), checks the port's sharded GEMMs,
collectives and engine on a 2x2 and then a 1x4 mesh, and writes what the
parent compares to ``WORKDIR/out_RANK.pt``.  Nothing here imports JAX.
"""
import logging
import os
import sys
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.core.dispatch import GemmShardSpec, select_plan  # noqa: E402
from repro_torch.dist import collectives as C  # noqa: E402
from repro_torch.dist import shard_gemm as sg  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_backend  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.quant.qmatmul import (quantized_matmul,  # noqa: E402
                                       quantized_matmul_batched)
from repro_torch.serve import executor as ex  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

M, K, N = 32, 256, 1024
E, CAP, KE, NE, SEGS = 8, 8, 64, 96, 2


def kernel_inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return {
        "x": rng.standard_normal((M, K)).astype(f),
        "w": rng.standard_normal((K, N)).astype(f),
        "a8": rng.integers(-120, 120, (M, K)).astype(np.int32),
        "b8": rng.integers(-120, 120, (K, N)).astype(np.int32),
        "xe": rng.standard_normal((E, CAP, KE)).astype(f),
        "we": rng.standard_normal((E, KE, NE)).astype(f),
        "counts": rng.integers(0, CAP // SEGS + 1, (E, SEGS)).astype(np.int32),
        "x_odd": rng.standard_normal((33, K)).astype(f),
        "w_odd": rng.standard_normal((K, 1025)).astype(f),
    }


def collective_inputs(world):
    rng = np.random.default_rng(1)
    f = np.float32
    return {
        "ef_x": [rng.standard_normal((64,)).astype(f) for _ in range(world)],
        "ef_err": [(0.01 * rng.standard_normal((64,))).astype(f)
                   for _ in range(world)],
        "ring_x": rng.standard_normal((4 * world, 32)).astype(f),
        "ring_w": rng.standard_normal((32, 24)).astype(f),
        "q": rng.standard_normal((2, 4, 16)).astype(f),
        "k": rng.standard_normal((2, 8 * world, 2, 16)).astype(f),
        "v": rng.standard_normal((2, 8 * world, 2, 16)).astype(f),
        "valid": rng.random((2, 8 * world)) < 0.7,
    }


def engine_requests(vocab):
    rng = np.random.default_rng(7)
    return [(list(int(t) for t in rng.integers(1, vocab, size=int(n))),
             int(m), t)
            for n, m, t in zip(rng.integers(2, 9, size=6),
                               rng.integers(1, 4, size=6),
                               (0.0, 0.8, 0.0, 0.7, 0.0, 0.9))]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def kernel_checks(mesh, out):
    inp = {k: _t(v) for k, v in kernel_inputs().items()}
    ctx = ExecContext(mesh=mesh)
    x, w = inp["x"], inp["w"]
    for bits in (8, 12):
        out[f"qmm{bits}"] = quantized_matmul(x, w, bits, context=ctx)
        out[f"qmm{bits}_plain"] = quantized_matmul(x, w, bits)
    a8, b8 = inp["a8"], inp["b8"]
    plan8 = select_plan((M, K, N), 8)
    out["run8"] = sg.sharded_run_plan(a8, b8, plan=plan8, mesh=mesh)
    out["run8_seam"] = ops.run_plan(a8, b8, plan=plan8, mesh=mesh)
    out["int_gemm8"] = ops.int_gemm(a8, b8, w=8, exact=True, context=ctx)
    kspec = GemmShardSpec(m_axes=("data",), k_axes=("model",))
    out["run8_k"] = sg.sharded_run_plan(a8, b8, plan=replace(plan8,
                                                             shard=kspec),
                                        mesh=mesh)
    plan12 = select_plan((M, K, N), 12)
    out["plan12_exact"] = plan12.is_exact_int
    try:
        sg.sharded_run_plan(a8, b8, plan=replace(plan12, shard=kspec),
                            mesh=mesh)
        out["k_refusal"] = ""
    except ValueError as e:
        out["k_refusal"] = str(e)
    xe, we, counts = inp["xe"], inp["we"], inp["counts"]
    seg = CAP // SEGS
    out["grouped"] = quantized_matmul_batched(xe, we, 12, context=ctx,
                                              counts=counts, seg=seg)
    out["grouped_plain"] = quantized_matmul_batched(xe, we, 12,
                                                    counts=counts, seg=seg)
    out["grouped_dense"] = quantized_matmul_batched(xe, we, 12, context=ctx)
    out["grouped_dense_plain"] = quantized_matmul_batched(xe, we, 12)
    # fallback: N=1025 tiles over no model axis, M=33 over no data axis
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("repro_torch.dist").addHandler(handler)
    logging.getLogger("repro_torch.dist").setLevel(logging.INFO)
    sg.reset_fallbacks()
    qmatmul.reset_gemm_routes()
    x_odd, w_odd = inp["x_odd"], inp["w_odd"]
    out["odd"] = [quantized_matmul(x_odd, w_odd, 12, context=ctx)
                  for _ in range(2)]
    out["odd_aten"] = quantized_matmul(x_odd, w_odd, 12,
                                       context=ExecContext(backend="aten"))
    out["odd_routes"] = qmatmul.gemm_routes()
    out["odd_fallbacks"] = sg.fallback_counts()
    out["odd_logs"] = list(records)
    # M=32 tiles over data, N=1025 over nothing: the kernel runs M-sharded
    out["m_only"] = quantized_matmul(x, w_odd, 12, context=ctx)
    out["m_only_plain"] = quantized_matmul(x, w_odd, 12)
    logging.getLogger("repro_torch.dist").removeHandler(handler)


def collective_checks(mesh, out):
    inp = collective_inputs(4)
    group = mesh.get_group("model")
    me = C.rank_of(group)
    x, err = _t(inp["ef_x"][me]), _t(inp["ef_err"][me])
    out["ef_total"], out["ef_err"] = C.ef_compressed_psum(x, err, group)
    rows = inp["ring_x"].shape[0] // 4
    xs = _t(inp["ring_x"][me * rows:(me + 1) * rows])
    wr = _t(inp["ring_w"])
    out["ring"] = C.ring_ag_matmul(xs, wr, group)
    out["ring8"] = C.ring_ag_matmul(xs, wr, group, w_bits=8,
                                    context=ExecContext(mesh=mesh))
    s_loc = inp["k"].shape[1] // 4
    sl = slice(me * s_loc, (me + 1) * s_loc)
    out["splitk"] = C.splitk_decode_attention(
        _t(inp["q"]), _t(inp["k"][:, sl]), _t(inp["v"][:, sl]),
        _t(inp["valid"][:, sl]), group)


def sharding_checks(mesh, out, tag):
    """The layout helpers the engine runs on: an int16 all-gather (its
    bytes moved as uint8) against the int32 one, the vocab-parallel
    embedding lookup on ids that differ across data ranks, and the tied
    head's per-channel quantization of this rank's vocab columns."""
    g = torch.Generator().manual_seed(5)
    x16 = torch.randint(-30000, 30000, (3, 4), generator=g,
                        dtype=torch.int16) + S.coordinate(mesh)["model"]
    for dim in (0, 1):
        got = C.all_gather(x16, mesh, ("data", "model"), dim)
        want = C.all_gather(x16.to(torch.int32), mesh, ("data", "model"), dim)
        out[f"{tag}/gather16_{dim}"] = got.dtype == torch.int16 and \
            torch.equal(got.to(torch.int32), want)
    table = torch.randn((64, 8), generator=g)
    held = S.shard_leaf(table, S.leaf_spec(("embed",), table, mesh), mesh,
                        "cpu")
    d = S.coordinate(mesh)["data"]
    ids = torch.randint(0, 64, (2 + d, 3), generator=torch.Generator()
                        .manual_seed(d))
    out[f"{tag}/embed_dtensor"] = S.is_dtensor(held)
    out[f"{tag}/embed_lookup"] = torch.equal(S.embed_lookup(held, ids),
                                             table[ids])
    head = S.transpose(S.vocab_block(held))
    qw, sw = S.map_columns(head, lambda w: qmatmul._quantize(
        w, 12, 0, torch.int16))
    wq, ws = qmatmul._quantize(table.T, 12, 0, torch.int16)
    cols = C.dtensor_axes(qw).get(1, ()) if S.is_dtensor(qw) else ()
    out[f"{tag}/head_cols"] = cols
    out[f"{tag}/head_quant"] = all(
        torch.equal(S.full_leaf(a), b) and torch.equal(
            a.to_local() if S.is_dtensor(a) else a,
            S.local_block(b, (None, cols[0] if cols else None), mesh))
        for a, b in ((qw, wq), (sw, ws)))


def _serve(cfg, params, mesh, capture):
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
    try:
        eng.generate(reqs)
    finally:
        ex.Executor.sample = sample
    res = {"tokens": [r.generated for r in reqs], "logits": rows,
           "graphs": eng.executor.graphs}
    if capture:
        res["resident"] = S.resident_bytes(eng.params)
        res["local_shapes"] = _local_shapes(eng.params)
        res["pool_shapes"] = {pos: {n: tuple(t.shape) for n, t in lv.items()}
                              for pos, lv in eng.pool.pools.items()}
        res["pool_global"] = eng.pool.global_shapes
        res["pool_spec"] = eng.pool.sharding
        res["data_rank"] = eng.pool.data_rank
    return res


def _local_shapes(tree, path=()):
    if isinstance(tree, dict):
        return {k: _local_shapes(v, path + (k,)) for k, v in tree.items()}
    if not S.is_dtensor(tree):
        return (tuple(tree.shape), tree.element_size(), None)
    local = tree.to_local()   # a copy of the block alone: its storage too
    return (tuple(local.shape), local.element_size(),
            local.untyped_storage().nbytes())


def engine_checks(mesh, out, tag, runs):
    for name, cfg, params in runs:
        qmatmul.reset_gemm_routes()
        sg.reset_fallbacks()
        got = _serve(cfg, params, mesh, capture=True)
        got["routes"] = qmatmul.gemm_routes()
        got["fallbacks"] = sg.fallback_counts()
        got["plain"] = _serve(cfg, params, None, capture=False)
        out[f"{tag}/{name}"] = got


def main(rank, world, port, workdir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = {}
    try:
        make_mesh((2, 4), device="cpu")
        out["world_mismatch"] = ""
    except ValueError as e:
        out["world_mismatch"] = "needs 8 ranks" if "needs 8 ranks" in str(e) \
            else str(e)
    mesh = make_mesh((2, 2), device="cpu")
    out["backend"] = mesh_backend(mesh)
    out["coord"] = S.coordinate(mesh)
    kernel_checks(mesh, out)
    sharding_checks(mesh, out, "2x2")
    engine_checks(mesh, out, "2x2", inputs["runs_2x2"])
    mesh14 = make_mesh((1, 4), device="cpu")
    collective_checks(mesh14, out)
    sharding_checks(mesh14, out, "1x4")
    engine_checks(mesh14, out, "1x4", inputs["runs_1x4"])
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
