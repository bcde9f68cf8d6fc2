"""The port's command-line tasks (counterparts of ``entrypoints_tpu/``),
run through ``python -m lantern_tpu_torch <task>``."""
