"""Rank body of ``tests/test_torch_prefix_mesh.py``: one of four gloo ranks
on the CPU.  Run as ``python _torch_prefix_mesh_ranks.py RANK WORLD PORT
WORKDIR``; reads ``WORKDIR/inputs.pt`` (the reference's parameters of
smoke llama, rwkv6-3b and jamba, converted in the parent), serves requests
that share a prompt head with the prefix cache on a 2x2 mesh and without
a mesh, and writes what the parent compares to ``WORKDIR/out_RANK.pt``.
Nothing here imports JAX.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serve import engine as eng_mod  # noqa: E402
from repro_torch.serve import executor as ex  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCHS = ("llama3.2-1b", "rwkv6-3b", "jamba-v0.1-52b")
MESH = (2, 2)
# 8 requests on 4 slots (2 a data rank), their prompts a 16-token head
# and 3-8 tokens of their own; chunks of 8 and pages of 16 put the
# snapshot boundary at 16, so the four requests admitted once slots free
# up restore their data rank's snapshot
MAX_SEQ, SLOTS, CHUNK, HEAD, NEW = 48, 4, 8, 16, 4
TEMPS = (0.0, 0.8, 0.0, 0.7, 0.0, 0.9, 0.0, 0.6)


def config(arch):
    """The smoke model in fp32 compute under mixed (jamba: one period of 7
    mamba layers, 1 attention layer and 4 MoE layers of 4 experts)."""
    return get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")


def prompts(vocab):
    rng = np.random.default_rng(11)
    head = [int(t) for t in rng.integers(1, vocab, size=HEAD)]
    return [head + [int(t) for t in rng.integers(1, vocab, size=int(n))]
            for n in rng.integers(3, 9, size=len(TEMPS))]


def serve(cfg, params, mesh, prefix=True):
    """The engine's run (chunked, with or without the prefix cache; warmed
    first under a mesh): tokens, every sampled logits row by (request,
    step), each request's slot, the prefix stats and each data rank's, the
    free snapshot rows and the prefill widths after warm() and after the
    run."""
    eng = Engine(cfg, params, max_seq=MAX_SEQ, batch_size=SLOTS, rng_seed=3,
                 device="cpu", mesh=mesh, prefill_chunk=CHUNK,
                 prefix_cache=prefix)
    warmed = None
    if mesh is not None:
        eng.warm()
        warmed = eng.n_traces()["prefill"]
    reqs = [Request(prompt=p, max_new_tokens=NEW, temperature=t)
            for p, t in zip(prompts(cfg.vocab_size), TEMPS)]
    rows, slot_of = {}, {}
    sample, init_slot = ex.Executor.sample, eng_mod.Engine._init_slot

    def recording(self, seed, logits, temps, rids, steps_):
        for lane, (rid, step) in enumerate(zip(rids, steps_)):
            rows.setdefault((int(rid), int(step)), logits[lane].clone())
        return sample(self, seed, logits, temps, rids, steps_)

    def admitted(self, idx, req):
        slot_of[req.stats.rid] = idx
        return init_slot(self, idx, req)

    ex.Executor.sample = recording
    eng_mod.Engine._init_slot = admitted
    try:
        eng.generate(reqs)
    finally:
        ex.Executor.sample = sample
        eng_mod.Engine._init_slot = init_slot
    out = {"tokens": [r.generated for r in reqs], "logits": rows,
           "slot_of": slot_of, "data_rank": eng.pool.data_rank,
           "per_rank": eng.pool.slots_per_rank,
           "free": (eng.pool.n_free_pages, eng.pool.n_free_states),
           "warmed": warmed, "traces": eng.n_traces()["prefill"]}
    if prefix:
        out["stats"] = eng.prefix.stats()
        out["by_rank"] = eng.prefix.stats_by_rank()
    return out


def main(rank, world, port, workdir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    mesh = make_mesh(MESH, device="cpu")
    out = {arch: {"mesh": serve(config(arch), inputs[arch], mesh)}
           for arch in ARCHS}
    # the unsharded engines, each once, spread over the ranks
    runs = [(arch, label) for arch in ARCHS
            for label in ("plain", "plain_no_prefix")]
    for i, (arch, label) in enumerate(runs):
        if i % world == rank:
            out[arch][label] = serve(config(arch), inputs[arch], None,
                                     label == "plain")
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
