"""``python -m repro_torch.tune`` — sweep GEMM shapes, persist winner tables.

Each key records the fastest candidate that serving runs as it is under a
table, one per distinct launch, timed in device time on the card
(``runner.served_candidates``, ``runner.device_time_us``).

Shape sources:

  * ``--shapes smoke``    two tiny shapes;
  * ``--shapes configs``  the GEMM (K, N) pairs of both ported archs
                          (llama3.2-1b, granite-moe-3b-a800m) x the M of
                          decode (1-4 live lanes) and the prefill buckets
                          up to ``--max-seq``;
  * ``--shapes serve``    the prefill buckets x the (K, N) pairs of
                          ``--arch``;
  * ``--shapes MxKxN``    explicit problems, repeatable.

``--max-dim`` caps the derived dims (table keys bucket anyway).  The sweep
runs on the CUDA card unless ``--device cpu`` asks for the kernels' plain
versions on the CPU.  Example, on the card:

    PYTHONPATH=src python -m repro_torch.tune --shapes serve \
        --w 8 12 16 20 --out tuned/h100.json
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Set, Tuple

from repro_torch.tune import runner, space
from repro_torch.tune.table import DEFAULT_PATH, TuningTable

Shape = Tuple[int, int, int]

SMOKE_SHAPES: Tuple[Shape, ...] = ((64, 64, 64), (64, 128, 64))
DECODE_ROWS = (1, 2, 4)


def _cap(d: int, cap: int) -> int:
    return space.bucket_shape((min(d, cap),) * 3)[0] if cap else d


def _shapes_for(archs, ms, cap: int, smoke: bool) -> List[Shape]:
    from repro_torch.configs import get_config

    out: Set[Shape] = set()
    for arch in archs:
        cfg = get_config(arch, smoke=smoke)
        for m in ms:
            for k, n in space.gemm_kn(cfg):
                out.add((_cap(m, cap), _cap(k, cap), _cap(n, cap)))
    return sorted(out)


def _parse_shapes(args) -> List[Shape]:
    from repro_torch.configs import list_archs
    from repro_torch.serve.scheduler import prompt_buckets_for

    buckets = prompt_buckets_for(args.max_seq)
    shapes: List[Shape] = []
    for tok in args.shapes:
        if tok == "smoke":
            shapes.extend(SMOKE_SHAPES)
        elif tok == "configs":
            shapes.extend(_shapes_for(list_archs(), DECODE_ROWS + buckets,
                                      args.max_dim, args.smoke_config))
        elif tok == "serve":
            shapes.extend(_shapes_for([args.arch], buckets, args.max_dim,
                                      args.smoke_config))
        else:
            try:
                m, k, n = (int(x) for x in tok.lower().split("x"))
            except ValueError:
                raise SystemExit(f"bad --shapes token {tok!r}: expected "
                                 f"smoke|configs|serve|MxKxN")
            shapes.append((m, k, n))
    return sorted(set(shapes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Autotune the integer GEMM's kernel variants and K "
                    "tiles; persist winner tables under tuned/.")
    ap.add_argument("--shapes", nargs="+", default=["configs"],
                    help="smoke | configs | serve | explicit MxKxN ...")
    ap.add_argument("--w", nargs="+", type=int, default=[8, 12],
                    help="bitwidths to sweep (default: the policy widths)")
    ap.add_argument("--m", type=int, default=8, help="multiplier bitwidth")
    ap.add_argument("--out", default=DEFAULT_PATH,
                    help=f"output table path (default {DEFAULT_PATH}); "
                         f"merged into if it already exists")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", nargs="+", type=int, default=None,
                    help=f"restrict block_k choices (default "
                         f"{space.TILE_CHOICES})")
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="truncate the prior-ordered space per shape")
    ap.add_argument("--max-dim", type=int, default=0,
                    help="cap derived config/serve dims (0: no cap)")
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="arch for --shapes serve")
    ap.add_argument("--max-seq", type=int, default=512,
                    help="prefill bucket ladder upper bound")
    ap.add_argument("--smoke-config", action="store_true",
                    help="use the smoke-scale configs for derived shapes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.core.context import resolve_device

    device = resolve_device(args.device)
    shapes = _parse_shapes(args)
    if not shapes:
        raise SystemExit("no shapes to sweep")
    try:
        table = TuningTable.load(args.out)
        print(f"merging into existing table {args.out} "
              f"({len(table)} entries)")
    except FileNotFoundError:
        table = TuningTable()
    table.device = runner.device_label(device)

    n_jobs = len(shapes) * len(args.w)
    print(f"sweeping {len(shapes)} shapes x w={args.w} ({n_jobs} problems) "
          f"on {table.device}")
    t0 = time.time()
    done = 0
    for w in args.w:
        for shape in shapes:
            done += 1
            res = runner.tune_shape(
                shape, w, m=args.m, iters=args.iters, seed=args.seed,
                tile_choices=args.tiles, max_candidates=args.max_candidates,
                verbose=args.verbose, device=device)
            n_ok = sum(1 for r in res.measurements if r.ok)
            n_bad = sum(1 for r in res.measurements if not r.ok)
            for r in res.measurements:
                if not r.ok:
                    print(f"    rejected {r.plan.variant} block_k="
                          f"{r.plan.block_k} int32={int(r.plan.combine_int32)}"
                          f" depth={r.plan.depth}: {r.error}")
            if res.winner is None:
                print(f"[{done}/{n_jobs}] cuda w={w} {shape}: NO correct "
                      f"candidate ({n_bad} rejected) — key skipped")
                continue
            best = next(r for r in res.measurements
                        if r.ok and r.plan == res.winner)
            key = table.put(
                "cuda", shape, w, res.winner,
                us=round(res.winner_us, 2),
                us_default=(round(res.default_us, 2)
                            if res.default_us == res.default_us else None),
                n_candidates=n_ok, n_rejected=n_bad,
                retimed=res.retimed or None,
                lead_ms=(round(best.lead_ms, 4)
                         if best.lead_ms is not None else None))
            lead = (f", lead {best.lead_ms:.3f} ms over {best.iters} calls"
                    if best.lead_ms is not None else "")
            print(f"[{done}/{n_jobs}] {key}: {res.winner.variant} "
                  f"block_k={res.winner.block_k} "
                  f"int32={int(res.winner.combine_int32)} "
                  f"depth={res.winner.depth} {res.winner_us:.2f}us "
                  f"(x{res.speedup_vs_default:.3f} vs default "
                  f"{res.default_us:.2f}us{lead}; {n_ok} timed / {n_bad} "
                  f"rejected)", flush=True)
    table.meta["sweep_s"] = f"{time.time() - t0:.1f}"
    table.save(args.out)
    print(f"wrote {args.out}: {len(table)} entries "
          f"({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
