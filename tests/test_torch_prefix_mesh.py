"""The prefix cache under a mesh on four gloo ranks on the CPU (one launch
for the module: the ranks run ``tests/_torch_prefix_mesh_ranks.py`` as
subprocesses on a 2x2 mesh, and import no JAX), held to the port's
unsharded engine and to the reference's meshless JAX engine with the same
prefix sharing (its own mesh paths fail under jax 0.9.0; its oracle is
computed here while the ranks run).  Smoke llama, rwkv6-3b and jamba in
fp32 compute under mixed; 8 requests whose prompts share a 16-token head,
on 4 slots (2 a data rank), chunks of 8.

  * tokens equal to the unsharded engine's with and without the prefix
    cache, and every logits row of a request, on its data rank's ranks,
    ``torch.equal`` to the unsharded engine's with it; greedy tokens equal
    to the JAX engine's with the prefix cache;
  * each data rank keeps its own index: every data rank hits, their hits
    and misses add up to the unsharded engine's, and every rank keeps the
    same index and free lists of every data rank;
  * the parking-row prefill of a data rank with no prompt left runs at a
    width ``warm()`` ran.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_prefix_mesh_ranks as R  # noqa: E402

WORLD = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jcfg(arch):
    jcfg = jax_get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    return jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))


def _jax_engines(jparams):
    """The reference's meshless engine, chunked with the prefix cache, on
    the ranks' requests: greedy tokens and its prefix stats."""
    out = {}
    for arch in R.ARCHS:
        jcfg = _jcfg(arch)
        reqs = [JaxRequest(prompt=p, max_new_tokens=R.NEW, temperature=t)
                for p, t in zip(R.prompts(jcfg.vocab_size), R.TEMPS)]
        eng = JaxEngine(jcfg, jparams[arch], max_seq=R.MAX_SEQ,
                        batch_size=R.SLOTS, rng_seed=3,
                        context=JaxContext(backend="pallas"),
                        prefill_chunk=R.CHUNK, prefix_cache=True)
        eng.generate(reqs)
        out[arch] = {"tokens": [r.generated for r in reqs],
                     "stats": eng.prefix.stats()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the four ranks, run the reference's engines meanwhile; return
    (every rank's outputs, the JAX engines' results, seconds the ranks
    took)."""
    work = str(tmp_path_factory.mktemp("prefix_mesh"))
    jparams = {arch: jax_lm.init_params(jax.random.PRNGKey(0), _jcfg(arch))
               for arch in R.ARCHS}
    torch.save({arch: bridge.params_from_jax(jax.tree.map(np.asarray, p))
                for arch, p in jparams.items()},
               os.path.join(work, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_prefix_mesh_ranks.py"),
         str(r), str(WORLD), str(port), work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        oracle = _jax_engines(jparams)
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
    # the unsharded engines ran once each, on one rank or another
    for arch in R.ARCHS:
        for o in outs[1:]:
            outs[0][arch].update({k: v for k, v in o[arch].items()
                                  if k != "mesh"})
    return outs, oracle, seconds


def _greedy(tokens):
    return [t for t, temp in zip(tokens, R.TEMPS) if temp == 0.0]


@pytest.mark.parametrize("arch", R.ARCHS)
def test_tokens_equal_unsharded_and_jax(ranks, arch):
    outs, oracle, _ = ranks
    plain = outs[0][arch]["plain"]
    assert plain["tokens"] == outs[0][arch]["plain_no_prefix"]["tokens"]
    for o in outs:
        assert o[arch]["mesh"]["tokens"] == plain["tokens"]
    assert _greedy(plain["tokens"]) == _greedy(oracle[arch]["tokens"])
    assert all(len(t) == R.NEW for t in plain["tokens"])


@pytest.mark.parametrize("arch", R.ARCHS)
def test_logits_rows_equal_unsharded(ranks, arch):
    """Every sampled row of a request, on the ranks of the data rank whose
    slot served it, ``torch.equal`` to the unsharded engine's (the same
    slots: every rank runs the whole scheduler)."""
    outs, _, _ = ranks
    plain = outs[0][arch]["plain"]
    n_rows = 0
    for o in outs:
        got = o[arch]["mesh"]
        assert got["slot_of"] == plain["slot_of"]
        for rid, slot in got["slot_of"].items():
            if slot // got["per_rank"] != got["data_rank"]:
                continue
            for step in range(len(got["tokens"][rid])):
                assert torch.equal(got["logits"][(rid, step)],
                                   plain["logits"][(rid, step)]), (rid, step)
                n_rows += 1
    # each request's rows on its data rank's 2 model ranks
    assert n_rows == 2 * sum(len(t) for t in plain["tokens"])


@pytest.mark.parametrize("arch", R.ARCHS)
def test_every_data_rank_hits_its_own_snapshots(ranks, arch):
    outs, oracle, _ = ranks
    plain = outs[0][arch]["plain"]
    by_rank = outs[0][arch]["mesh"]["by_rank"]
    assert len(by_rank) == R.MESH[0]
    assert all(s["hits"] >= 1 and s["entries"] >= 1 for s in by_rank)
    for key in ("hits", "misses"):
        assert sum(s[key] for s in by_rank) == plain["stats"][key]
    assert plain["stats"] == oracle[arch]["stats"]
    for o in outs:                 # every rank keeps every data rank's
        got = o[arch]["mesh"]
        assert got["by_rank"] == by_rank
        assert got["free"] == outs[0][arch]["mesh"]["free"]


@pytest.mark.parametrize("arch", R.ARCHS)
def test_parking_prefill_runs_a_warmed_width(ranks, arch):
    outs, _, _ = ranks
    for o in outs:
        got = o[arch]["mesh"]
        assert got["traces"] == got["warmed"] == 1     # the chunk ladder: 8
