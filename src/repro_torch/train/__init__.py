"""Training: the AdamW optimizer, checkpoints and the train loop (port of
``repro.train``)."""
