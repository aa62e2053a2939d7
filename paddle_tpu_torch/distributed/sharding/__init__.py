"""`paddle.distributed.sharding`: the GroupSharded (ZeRO) API — the port
of `paddle_tpu/distributed/sharding/__init__.py` (Paddle's
group_sharded.py `group_sharded_parallel`, `save_group_sharded_model`).
"""
from __future__ import annotations

import os

from .group_sharded import (  # noqa: F401
    GroupShardedOptimizerStage2,
    GroupShardedScaler,
    GroupShardedStage2,
    GroupShardedStage3,
)


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """Wrap (model, optimizer, scaler) for group-sharded training. level:
    'os' (stage 1: optimizer states), 'os_g' (stage 2: and gradients),
    'p_g_os' (stage 3: and parameters)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"level must be one of os/os_g/p_g_os, got {level!r}")
    params = list(model.parameters())
    if level in ("os", "os_g"):
        optimizer = GroupShardedOptimizerStage2(
            params, optimizer, group=group, offload=offload,
            shard_grads=(level == "os_g"))
        model = GroupShardedStage2(model, optimizer, group=group,
                                   sync_buffers=sync_buffers,
                                   buffer_max_size=buffer_max_size,
                                   dp_group=dp_group)
    else:
        model = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                   sync_buffers=sync_buffers,
                                   segment_size=segment_size,
                                   offload=offload, sync_comm=sync_comm,
                                   dp_group=dp_group,
                                   exclude_layer=exclude_layer)
        optimizer = GroupShardedOptimizerStage2(
            params, optimizer, group=group, offload=offload)
        optimizer._stage3 = model
    if scaler is not None:
        scaler = GroupShardedScaler(scaler)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the whole parameters (gathered first under stage 3) to
    `output/model.pdparams`, and the optimizer's state to
    `output/model.pdopt`, in `paddle.save`'s format, which the reference
    loads."""
    from ...framework.io_api import save

    if isinstance(model, GroupShardedStage3):
        model.get_all_parameters()
        inner = model._layers
    elif isinstance(model, GroupShardedStage2):
        inner = model._layers
    else:
        inner = model
    os.makedirs(output, exist_ok=True)
    save(inner.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        opt = getattr(optimizer, "_optim", optimizer)
        if hasattr(opt, "state_dict"):
            save(opt.state_dict(), os.path.join(output, "model.pdopt"))
