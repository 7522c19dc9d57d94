"""Training launcher with restart supervision (fault tolerance).

    python -m repro_torch.launch.train --arch llama3.2-1b --quant mixed \
        --steps 4
    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
        --device cpu --steps 20 --ckpt-dir ckpt --max-restarts 2

The reference launcher's flags plus ``--device``: the published
configuration on the CUDA device by default (``--smoke``: the reduced one;
``--device cpu``: the kernels' plain versions on the CPU).  ``--mesh``
takes only ``1x1``: training under a mesh is ROADMAP queue 1, item 4
(serving under one is ported: ``launch/serve.py --mesh``).
``--max-restarts N`` supervises the training call: on an exception the
launcher runs it again, which resumes from the latest checkpoint under
``--ckpt-dir``.  ``--tuning-table PATH`` serves each quantized GEMM the
plan a ``python -m repro_torch.tune`` table picks (the same values).
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
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; "
            f"training under a mesh is ROADMAP queue 1, item 4")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
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
            result = run_training(cfg, tc, data_cfg, device=args.device)
            break
        except Exception as e:  # supervised restart
            attempts += 1
            logging.error("training failed (%s); restart %d/%d",
                          e, attempts, args.max_restarts)
            if attempts > args.max_restarts:
                raise
    final_loss = list(result.losses.values())[-1] if result.losses else None
    print(f"done: step={result.final_step} loss={final_loss} "
          f"resumed_from={result.restored_from} "
          f"stragglers={result.straggler_events}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
