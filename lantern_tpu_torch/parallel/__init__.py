"""Tensor- and data-parallel serving on ``torch.distributed``: ``dist``
(process-group init, ``host_mean``, ``shard_requests``) and ``mesh`` (the
(dp, tp) mesh, the sharding rules, ``set_mesh``).  Counterpart of
``lantern_tpu/parallel``'s serving half."""
