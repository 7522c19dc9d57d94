"""repro_torch.tune — autotuning for the integer GEMM (port of
``repro.tune``): search space, offline runner, persisted tuning tables.

    python -m repro_torch.tune --shapes serve --out tuned/h100.json
    # then install it process-wide:
    from repro_torch.tune import set_active_table
    set_active_table("tuned/h100.json")
"""
from repro_torch.tune.space import (bucket_shape, candidates, cost_prior,
                                    prior_plan, pruned_space, validate)
from repro_torch.tune.table import (TuningTable, get_active_table, key_for,
                                    set_active_table, use_table)
from repro_torch.tune.runner import TuneResult, tune_shape

__all__ = [
    "TuneResult", "TuningTable", "bucket_shape", "candidates", "cost_prior",
    "get_active_table", "key_for", "prior_plan", "pruned_space",
    "set_active_table", "tune_shape", "use_table", "validate",
]
