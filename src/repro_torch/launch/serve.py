"""Serving launcher: continuous-batching generation on random weights.

    python -m repro_torch.launch.serve --arch llama3.2-1b --quant mixed \
        --full-size --metrics-out m.json --trace-out t.json

The reference launcher's flags plus ``--device``.  Runs on the CUDA device;
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU
instead.  ``--mesh DxM`` serves sharded on a (data, model) mesh
(:mod:`repro_torch.launch.mesh`), one process a rank under ``torchrun``::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2 \
        --arch granite-moe-3b-a800m --quant mixed

An MoE model's expert GEMMs run expert-parallel (each ``model`` rank over
its own experts), rwkv6-3b's WKV recurrence head-parallel and jamba's
mamba conv and scan channel-parallel (each ``model`` rank on its block of
the pool's recurrent state)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2 \
        --arch rwkv6-3b --quant mixed

``--prefix-cache`` serves under a mesh too: each data rank keeps the
snapshots of its own slots (``serve.cache``), and rank 0 prints each data
rank's hits.

Every rank draws the same weights from the seed on the host, so no card
holds them whole, copies only its shards to its device and runs its data
rank's lanes (``Engine(mesh=)``); rank 0 prints the tokens.  The host's
generator draws other values than the card's, so on the card ``--mesh``
serves other random weights than a run without it.  The
ranks run NCCL with a card each, gloo on the CPU or where they share a
card (``launch.mesh.default_backend``).  ``--metrics-out PATH`` enables the metrics
registry (:mod:`repro_torch.obs.metrics`) before the engine is built and
writes its JSON snapshot there after generation; ``--trace-out PATH``
enables the span tracer and writes a Chrome trace (``chrome://tracing`` /
Perfetto) there.
``--backend aten`` serves every GEMM on the KMM digit recursion over ATen
matmuls, the reference's default ``"xla"`` route.  With
``--tuning-table PATH`` (a table written by ``python -m repro_torch.tune``)
each GEMM runs the plan the table picks in the analytic plan's numerics
class: the same tokens, possibly other kernels.  Weights come from a
``torch.Generator`` seeded with 0.  With ``--poisson RATE`` the requests
arrive as a Poisson process (RATE requests/s), so TTFT includes queueing
delay.  ``--prefill-chunk`` interleaves prompt chunks with decode steps,
and ``--prefix-cache`` shares repeated prompt prefixes through the pool's
snapshots.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--quant", default="w12",
                    choices=["none", "w8", "w12", "mixed"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", "--slots", dest="batch", type=int, default=4,
                    help="decode slots (continuous batching); decode runs "
                         "on the smallest power-of-two bucket covering the "
                         "live slots")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: advance prompts this many tokens "
                         "per engine step, interleaved with decode "
                         "(power of two >= 8; 0: whole-prompt prefill at "
                         "admission)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share repeated prompt prefixes via paged-cache "
                         "snapshots (implies chunked prefill)")
    ap.add_argument("--eos", type=int, default=-1,
                    help="stop token id (-1: none)")
    ap.add_argument("--poisson", type=float, default=0.0,
                    help="arrival rate in req/s (0: all at once)")
    ap.add_argument("--full-size", action="store_true",
                    help="the published configuration (needs a GPU)")
    ap.add_argument("--backend", "--quant-backend", dest="backend",
                    default="cuda", choices=["cuda", "aten"],
                    help="quantized-GEMM backend: 'cuda' serves through the "
                         "hand-written fused KMM kernel; 'aten' through the "
                         "KMM digit recursion on ATen matmuls (the "
                         "reference's 'xla')")
    ap.add_argument("--tuning-table", default=None,
                    help="tuning table (JSON) from python -m "
                         "repro_torch.tune, installed for every GEMM")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve sharded on a (data, model) mesh, e.g. 2x2, "
                         "one process a rank (torchrun --nproc-per-node "
                         "D*M)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable the metrics registry and write a JSON "
                         "snapshot here after generation")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable the span tracer and write a Chrome-trace "
                         "(chrome://tracing / Perfetto) JSON file here after "
                         "generation")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.core.context import ExecContext, resolve_device
    from repro_torch.models import lm
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import Engine, Request

    # Observability is opt-in: enabled before the engine is built, so plan
    # selection and every decode graph's capture are counted too.
    if args.metrics_out:
        obs_metrics.enable()
    if args.trace_out:
        obs_trace.enable()
    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_mesh, parse_mesh
        mesh = make_mesh(parse_mesh(args.mesh), device=device.type)
        rank = dist.get_rank()
    cfg = get_config(args.arch, smoke=not args.full_size, quant=args.quant)
    # under a mesh the whole tree stays on the host; the engine moves the
    # shards
    init_device = torch.device("cpu") if mesh is not None else device
    gen = torch.Generator(device=init_device)
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg, device=init_device)
    engine = Engine(cfg, params, max_seq=args.max_seq, batch_size=args.batch,
                    context=ExecContext(backend=args.backend,
                                        tuning_table=args.tuning_table),
                    prefill_chunk=args.prefill_chunk or None,
                    prefix_cache=args.prefix_cache, device=device,
                    mesh=mesh)
    rng = np.random.default_rng(0)
    stop = (args.eos,) if args.eos >= 0 else ()
    reqs = [Request(prompt=[int(t) for t in rng.integers(
                        1, cfg.vocab_size, size=rng.integers(4, 17))],
                    max_new_tokens=args.max_new,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    stop_tokens=stop)
            for i in range(args.requests)]
    arrivals = None
    if args.poisson > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / args.poisson,
                                             size=len(reqs))).tolist()
    stats = engine.generate(reqs, arrival_s=arrivals)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    if rank != 0:
        return 0
    for i, r in enumerate(reqs):
        rs = r.stats
        print(f"req{i}: prompt[{len(r.prompt)}] -> {r.generated} "
              f"({rs.stop_reason}; ttft {rs.ttft_s*1e3:.0f}ms, "
              f"latency {rs.latency_s*1e3:.0f}ms)")
    print(f"prefill {stats.prefill_s:.2f}s; {stats.generated_tokens} tokens "
          f"in {stats.decode_steps} decode steps / {stats.decode_s:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s, occupancy "
          f"{stats.occupancy_pct:.0f}%, quant={args.quant}); "
          f"traces={engine.n_traces()}; device={device}"
          + (f"; mesh={args.mesh}" if mesh is not None else ""))
    if engine.prefix is not None:
        print(f"prefix cache: {engine.prefix.stats()}"
              + (f"; by data rank {engine.prefix.stats_by_rank()}"
                 if mesh is not None else ""))
    if args.metrics_out:
        obs_metrics.write_snapshot(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        obs_trace.export_chrome(args.trace_out)
        print(f"chrome trace -> {args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
