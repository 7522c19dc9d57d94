"""Training launcher with restart supervision (fault tolerance).

    python -m repro_torch.launch.train --arch llama3.2-1b --quant mixed \
        --steps 4
    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
        --device cpu --steps 20 --ckpt-dir ckpt --max-restarts 2

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-1b --quant mixed --mesh 2x2 --steps 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --quant mixed --mesh 2x2 --steps 4 \
        --global-batch 16
    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --smoke --device cpu --mesh 2x2

The reference launcher's flags plus ``--device``: the published
configuration on the CUDA device by default (``--smoke``: the reduced one;
``--device cpu``: the kernels' plain versions on the CPU).  ``--mesh DxM``
(other than ``1x1``, one device without a mesh) trains one rank of a
``data`` x ``model`` mesh (``launch.mesh.make_mesh``) in each process
``torchrun`` starts: NCCL with a card a rank, gloo on the CPU (``--device
cpu``) or with ranks sharing a card; outside ``torchrun`` it raises at
once.  Every model trains under a mesh: dense attention decoders, MoE
(expert-parallel: granite and qwen3), rwkv6-3b (head-parallel WKV), jamba
(channel-parallel mamba), llava's vision prefix and seamless's
encoder-decoder (their patch embeddings and frames cut to each data
rank's rows)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch seamless-m4t-medium --quant mixed --mesh 2x2 --steps 4

``--max-restarts N`` supervises the training call: on an exception the
launcher runs it again, which resumes from the latest checkpoint under
``--ckpt-dir``;
under a mesh a fault on any rank raises on every rank (the loop agrees on
it), so every rank restarts and resumes at the same step.
``--tuning-table PATH`` serves each quantized GEMM the plan a ``python -m
repro_torch.tune`` table picks (the same values).
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "w8", "w12", "mixed"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--max-restarts", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tuning-table", default=None,
                    help="repro_torch.tune table JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    mesh = None
    if args.mesh != "1x1":
        mesh = make_mesh(parse_mesh(args.mesh), device=args.device)
    from repro_torch.configs import get_config
    from repro_torch.core.context import ExecContext
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import optim
    from repro_torch.train.loop import TrainConfig, run_training

    cfg = get_config(args.arch, smoke=args.smoke, quant=args.quant)
    tc = TrainConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir if args.resume == "auto" else None,
        optimizer=optim.AdamWConfig(lr=args.lr, total_steps=args.steps),
        context=ExecContext(tuning_table=args.tuning_table),
    )
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, frontend=cfg.frontend,
        frontend_dim=cfg.frontend_dim, frontend_tokens=cfg.frontend_tokens,
        encdec=cfg.is_encdec)

    attempts = 0
    while True:
        try:
            result = run_training(cfg, tc, data_cfg, device=args.device,
                                  mesh=mesh)
            break
        except Exception as e:  # supervised restart
            attempts += 1
            logging.error("training failed (%s); restart %d/%d",
                          e, attempts, args.max_restarts)
            if attempts > args.max_restarts:
                raise
    final_loss = list(result.losses.values())[-1] if result.losses else None
    rank = ""
    if mesh is not None:
        import torch.distributed as dist
        rank = (f" rank={dist.get_rank()} mesh={args.mesh} "
                f"resident_bytes={result.resident_bytes}")
    # one write with its newline: ranks sharing a stdout pipe cannot
    # interleave within the line
    sys.stdout.write(f"done: step={result.final_step} loss={final_loss} "
                     f"resumed_from={result.restored_from} "
                     f"stragglers={result.straggler_events}{rank}\n")
    sys.stdout.flush()
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
