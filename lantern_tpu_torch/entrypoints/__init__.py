"""The port's command-line tasks (counterparts of ``entrypoints_tpu/``),
run through ``python -m lantern_tpu_torch <task>``."""


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda or cpu)")
