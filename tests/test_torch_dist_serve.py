"""The port's sharded GEMMs, collectives and engine on four gloo ranks on
the CPU (one launch for the module: a 2x2 mesh, then a 1x4 one), held to
the port's unsharded runs and to the reference's unsharded results.

The ranks run ``tests/_torch_dist_ranks.py`` as subprocesses and import no
JAX; the reference's oracles are computed here, in the parent, while they
run.  The reference's own mesh paths fail under jax 0.9.0, and its
contract is that sharded output equals unsharded output bit for bit (K is
replicated), so the oracle is always its unsharded result:

  * ``quantized_matmul`` sharded at w=8 (exact: the int64 oracle) and w=12,
    ``torch.equal`` to the port unsharded and ``array_equal`` to JAX's
    Pallas route; the grouped GEMM with ragged counts likewise;
  * ``sharded_run_plan`` M/N- and K-sharded at w=8 equal to the int64
    oracle, the fp32 class refused for K-sharding;
  * an indivisible GEMM falls back to the ATen route, logged once and
    counted every time, equal to the unsharded ATen route;
  * ``ef_compressed_psum``, ``ring_ag_matmul`` (plain and ``w_bits=8``)
    and ``splitk_decode_attention``;
  * the engine (the reference test's tiny llama, 8 slots, 6 requests
    with sampled ones among them) on 2x2 under w8, mixed and mixed on
    records, and on 1x4 with a ``d_ff`` of 1022 that 4 does not divide
    (its MLP up-projections fall back, counted): every token equal to the
    port's unsharded engine, the greedy ones to the JAX engine's, every
    logits row ``torch.equal`` to the unsharded engine's, and each rank
    holding exactly its ``leaf_spec`` block of every parameter and its
    ``page_pool_sharding`` block of the pool.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.dist import collectives as jax_coll  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant.qmatmul import quantized_matmul as jax_qmm  # noqa: E402
from repro.quant.qmatmul import \
    quantized_matmul_batched as jax_qbmm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.kernels.ref import ref_int_gemm_i64  # noqa: E402
from repro_torch.quant.prequant import prequantize  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dist_ranks as R  # noqa: E402

WORLD = 4
ODD_FF = 1022           # 4 does not divide it


def _cfgs(mod, quant, d_ff=1024):
    return mod(quant).scaled_down(
        d_model=256, d_ff=d_ff, vocab_size=2048, n_heads=8, n_kv_heads=4,
        head_dim=32, compute_dtype="float32")


def _jcfg(quant, d_ff=1024):
    return _cfgs(lambda q: jax_get_config("llama3.2-1b", smoke=True,
                                          quant=q), quant, d_ff)


def _tcfg(quant, d_ff=1024):
    return _cfgs(lambda q: get_config("llama3.2-1b", smoke=True, quant=q),
                 quant, d_ff)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_engine_tokens(jcfg, jparams):
    reqs = [JaxRequest(prompt=p, max_new_tokens=m, temperature=t)
            for p, m, t in R.engine_requests(jcfg.vocab_size)]
    JaxEngine(jcfg, jparams, max_seq=32, batch_size=8, rng_seed=3,
              context=JaxContext(backend="pallas")).generate(reqs)
    return [r.generated for r in reqs]


def _jax_oracles(jparams, jparams_odd):
    inp = R.kernel_inputs()
    ctx = JaxContext(backend="pallas")
    seg = R.CAP // R.SEGS
    col = R.collective_inputs(WORLD)
    rows = col["ring_x"].shape[0] // WORLD
    qb, sb = jax_coll._prep_rhs(jnp.asarray(col["ring_w"]), 8)
    ring8 = np.concatenate([np.asarray(jax_coll._shard_matmul(
        jnp.asarray(col["ring_x"][i * rows:(i + 1) * rows]), qb, sb, 8))
        for i in range(WORLD)])
    return {
        "qmm8": np.asarray(jax_qmm(jnp.asarray(inp["x"]),
                                   jnp.asarray(inp["w"]), 8, context=ctx)),
        "qmm12": np.asarray(jax_qmm(jnp.asarray(inp["x"]),
                                    jnp.asarray(inp["w"]), 12, context=ctx)),
        "grouped": np.asarray(jax_qbmm(
            jnp.asarray(inp["xe"]), jnp.asarray(inp["we"]), 12, context=ctx,
            counts=jnp.asarray(inp["counts"]), seg=seg)),
        "ring": np.asarray(jnp.dot(jnp.asarray(col["ring_x"]),
                                   jnp.asarray(col["ring_w"]))),
        "ring8": ring8,
        "engine": _jax_engine_tokens(_jcfg("mixed"), jparams),
        "engine_odd": _jax_engine_tokens(_jcfg("w8", ODD_FF), jparams_odd),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the four ranks, compute the reference's oracles meanwhile,
    and return (every rank's outputs, the oracles, seconds the ranks
    took)."""
    work = str(tmp_path_factory.mktemp("dist_ranks"))
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), _jcfg("mixed"))
    jparams_odd = jax_lm.init_params(jax.random.PRNGKey(0),
                                     _jcfg("w8", ODD_FF))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    params_odd = params_from_jax(jax.tree.map(np.asarray, jparams_odd))
    mixed = _tcfg("mixed")
    torch.save({
        "runs_2x2": [("w8", _tcfg("w8"), params), ("mixed", mixed, params),
                     ("mixed_records", mixed,
                      prequantize(params, mixed.quant))],
        "runs_1x4": [("w8_odd", _tcfg("w8", ODD_FF), params_odd),
                     ("mixed_odd", _tcfg("mixed", ODD_FF), params_odd)],
    }, os.path.join(work, "inputs.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_ranks.py"),
         str(r), str(WORLD), str(port), work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        oracles = _jax_oracles(jparams, jparams_odd)
        oracles["params"] = params
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.monotonic() - t0
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    outs = [torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return outs, oracles, seconds


def test_ranks_ran_on_gloo_meshes(ranks):
    outs, _, seconds = ranks
    assert [o["backend"] for o in outs] == ["gloo"] * WORLD
    assert sorted((o["coord"]["data"], o["coord"]["model"])
                  for o in outs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [o["world_mismatch"] for o in outs] == ["needs 8 ranks"] * WORLD
    assert seconds < 300


@pytest.mark.parametrize("bits", [8, 12])
def test_sharded_quantized_matmul_equals_unsharded(ranks, bits):
    outs, oracles, _ = ranks
    for o in outs:
        assert torch.equal(o[f"qmm{bits}"], o[f"qmm{bits}_plain"])
        assert np.array_equal(o[f"qmm{bits}"].numpy(), oracles[f"qmm{bits}"])
    if bits == 8:   # exact: the int64 oracle, dequantized in the kernel's order
        from repro_torch.quant.quantize import quantize_symmetric
        inp = R.kernel_inputs()
        x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
        qx, sx = quantize_symmetric(x, 8, axis=-1, keepdims=True)
        qw, sw = quantize_symmetric(w, 8, axis=0, keepdims=True)
        acc = torch.from_numpy(ref_int_gemm_i64(qx.numpy(), qw.numpy()))
        want = (acc.to(torch.float32) * (sx * sw)).to(torch.float32)
        assert torch.equal(outs[0]["qmm8"], want)


def test_sharded_run_plan_exact_and_k_split(ranks):
    outs, _, _ = ranks
    inp = R.kernel_inputs()
    oracle = ref_int_gemm_i64(inp["a8"], inp["b8"])
    for o in outs:
        for key in ("run8", "run8_seam", "int_gemm8", "run8_k"):
            assert np.array_equal(o[key].numpy().astype(np.int64), oracle), \
                key
        assert o["run8_k"].dtype == torch.int32
        assert not o["plan12_exact"]
        assert "exact-int" in o["k_refusal"]


def test_grouped_ragged_equals_unsharded(ranks):
    outs, oracles, _ = ranks
    for o in outs:
        assert torch.equal(o["grouped"], o["grouped_plain"])
        assert torch.equal(o["grouped_dense"], o["grouped_dense_plain"])
        assert np.array_equal(o["grouped"].numpy(), oracles["grouped"])


def test_indivisible_gemm_falls_back_logged_and_counted(ranks):
    outs, _, _ = ranks
    for o in outs:
        assert all(torch.equal(x, o["odd_aten"]) for x in o["odd"])
        assert o["odd_routes"][("cuda", "aten_fallback")] == 2
        (key, n), = o["odd_fallbacks"].items()
        assert key[:2] == ((33, 256, 1025), 12) and "1025" in key[2]
        assert n == 2                                   # counted each time
        assert len(o["odd_logs"]) == 1                  # logged once
        assert "falls back to ATen" in o["odd_logs"][0]
        assert torch.equal(o["m_only"], o["m_only_plain"])


def test_ef_compressed_psum_against_numpy(ranks):
    outs, _, _ = ranks
    col = R.collective_inputs(WORLD)
    ys = [x + e for x, e in zip(col["ef_x"], col["ef_err"])]
    scale = max(np.float32(np.max(np.abs(y))) / np.float32(127.0)
                for y in ys)
    qs = [np.clip(np.round(y / scale), -127, 127) for y in ys]
    total = (np.sum(np.stack(qs).astype(np.int32), axis=0)
             .astype(np.float32) * scale)
    for o in outs:
        assert np.array_equal(o["ef_total"].numpy(), total)
    for r, o in enumerate(outs):
        me = r                      # 1x4: the model group is the world
        assert np.array_equal(o["ef_err"].numpy(), ys[me] - qs[me] * scale)


def test_ring_ag_matmul_against_reference(ranks):
    outs, oracles, _ = ranks
    for o in outs:
        np.testing.assert_allclose(o["ring"].numpy(), oracles["ring"],
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(o["ring8"].numpy(), oracles["ring8"])


def test_splitk_decode_attention_against_softmax(ranks):
    outs, _, _ = ranks
    col = R.collective_inputs(WORLD)
    q = torch.from_numpy(col["q"])
    k, v = torch.from_numpy(col["k"]), torch.from_numpy(col["v"])
    valid = torch.from_numpy(col["valid"])
    b, h, d = q.shape
    kk = k.repeat_interleave(h // k.shape[2], dim=2)
    vv = v.repeat_interleave(h // v.shape[2], dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q, kk) * d ** -0.5
    scores = torch.where(valid[:, None, :], scores, -1e30)
    ref = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1), vv)
    for o in outs:
        np.testing.assert_allclose(o["splitk"].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-5)


def _engine_checks(outs, tag, d):
    got = [o[tag] for o in outs]
    tokens = got[0]["tokens"]
    for g in got:
        assert g["tokens"] == tokens == g["plain"]["tokens"]
        assert g["graphs"] is False             # gloo: eager decode
    # logits: every request's rows from the rank that owns its slot (the
    # requests are admitted in order, request i into slot i)
    n_rows = 0
    for g in got:
        for (rid, step), row in g["logits"].items():
            if rid * d // 8 != g["data_rank"] or step >= len(tokens[rid]):
                continue
            assert torch.equal(row, g["plain"]["logits"][(rid, step)]), \
                (tag, rid, step)
            n_rows += 1
    # every model rank of a data rank holds the same rows
    assert n_rows == sum(len(t) for t in tokens) * (WORLD // d)
    return got


def _greedy(tokens):
    return [t for t, (_, _, temp) in zip(
        tokens, R.engine_requests(2048)) if temp == 0.0]


def _check_shards(g, cfg, params, mesh):
    """Each rank's local block of every leaf is its leaf_spec block, and
    its resident bytes are their sum; the pool likewise."""
    total = 0

    def check(path, leaf, local):
        nonlocal total
        spec = S.leaf_spec(path, leaf, mesh)
        want = list(leaf.shape)
        for dim, entry in enumerate(spec):
            for ax in S.entry_axes(entry):
                want[dim] //= S.mesh_axis_size(mesh, ax)
        assert local[0] == tuple(want), (path, local, want)
        total += int(np.prod(want)) * local[1]
        # a sharded leaf's block is a copy: it keeps no whole tensor alive
        assert local[2] in (None, int(np.prod(want)) * local[1]), path

    def walk(tree, loc, path=()):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], loc[k], path + (k,))
        else:
            check(path, tree, loc)

    walk(params, g["local_shapes"])
    assert g["resident"] == total
    for pos, leaves in g["pool_global"].items():
        for name, shape in leaves.items():
            want = list(shape)
            for dim, entry in enumerate(g["pool_spec"][pos][name]):
                for ax in S.entry_axes(entry):
                    want[dim] //= S.mesh_axis_size(mesh, ax)
            assert g["pool_shapes"][pos][name] == tuple(want)


class _Mesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("tag", ["2x2", "1x4"])
def test_layout_helpers_on_ranks(ranks, tag):
    """An int16 all-gather equals the int32 one; the vocab-parallel lookup
    equals ``table[ids]`` with ids that differ across data ranks; the tied
    head's codes and scales on this rank's vocab columns equal the whole
    head's quantized, and stay sharded over ``model``."""
    outs, _, _ = ranks
    for o in outs:
        assert o[f"{tag}/gather16_0"] and o[f"{tag}/gather16_1"]
        assert o[f"{tag}/embed_dtensor"] and o[f"{tag}/embed_lookup"]
        assert o[f"{tag}/head_cols"] == ("model",)
        assert o[f"{tag}/head_quant"]


@pytest.mark.parametrize("run", ["w8", "mixed", "mixed_records"])
def test_engine_2x2_equals_unsharded_and_jax(ranks, run):
    outs, oracles, _ = ranks
    got = _engine_checks(outs, f"2x2/{run}", 2)
    assert _greedy(got[0]["tokens"]) == _greedy(oracles["engine"])
    assert got[0]["fallbacks"] == {}
    # every parameter is sharded somewhere on 2x2, and the pool over both
    mesh = _Mesh({"data": 2, "model": 2})
    cfg = _tcfg("mixed")
    params = oracles["params"]
    if run == "mixed_records":
        params = prequantize(params, cfg.quant)
    for g in got:
        _check_shards(g, cfg, params, mesh)
        assert g["pool_spec"]["pos0"]["k"] == (None, "data", None, "model",
                                               None)


@pytest.mark.parametrize("run", ["w8_odd", "mixed_odd"])
def test_engine_1x4_with_fallbacks_equals_unsharded(ranks, run):
    outs, oracles, _ = ranks
    got = _engine_checks(outs, f"1x4/{run}", 1)
    if run == "w8_odd":
        assert _greedy(got[0]["tokens"]) == _greedy(oracles["engine_odd"])
    reasons = {key[2] for key in got[0]["fallbacks"]}
    shapes = {key[0][2] for key in got[0]["fallbacks"]}
    assert shapes == {ODD_FF} and all(str(ODD_FF) in r for r in reasons)
    assert got[0]["routes"][("cuda", "aten_fallback")] == \
        sum(got[0]["fallbacks"].values())
    assert got[0]["routes"][("cuda", "cuda")] > 0


def test_launcher_under_torchrun_matches_unsharded(monkeypatch, capsys):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh
    2x1`` on the CPU prints, from rank 0 only, the tokens the launcher
    prints without a mesh."""
    from repro_torch.launch import serve as launcher
    flags = ["--device", "cpu", "--requests", "2", "--max-new", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.serve", "--mesh", "2x1", *flags],
        capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    meshed = [ln.split(" (")[0] for ln in res.stdout.splitlines()
              if ln.startswith("req")]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    assert launcher.main() == 0
    plain = [ln.split(" (")[0] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("req")]
    assert meshed == plain and len(plain) == 2
    assert "mesh=2x1" in res.stdout
