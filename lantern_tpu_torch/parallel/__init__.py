"""Parallelism on ``torch.distributed``, the counterpart of
``lantern_tpu/parallel``: ``dist`` (process-group init, ``host_mean``,
``shard_requests``, and the collectives of the training paths), ``mesh``
(the (dp, tp) mesh, the sharding rules, ``set_mesh``: tensor- and
data-parallel serving, and the mesh of the finetune's FSDP) and
``pipeline`` (GPipe stages over a (dp, pp) mesh).

The modules load on first use: the decoder imports ``mesh``, and
``pipeline`` imports the finetune, which imports the decoder."""

import importlib

__all__ = ["dist", "mesh", "pipeline"]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
