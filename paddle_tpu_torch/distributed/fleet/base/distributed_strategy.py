"""DistributedStrategy — every fleet knob in one config object: a copy
of `paddle_tpu/distributed/fleet/base/distributed_strategy.py`, pure
Python, the same fields and defaults (Paddle's is backed by
framework/distributed_strategy.proto).
"""
from __future__ import annotations

import copy
from typing import Any, Dict


_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    "mp_configs": {},
    "pp_configs": {},
}

_DEFAULT_AMP = {
    "init_loss_scaling": 32768.0,
    "use_dynamic_loss_scaling": True,
    "incr_every_n_steps": 1000,
    "decr_every_n_nan_or_inf": 2,
    "incr_ratio": 2.0,
    "decr_ratio": 0.5,
    "use_pure_fp16": False,
    "use_bf16": True,
    "custom_white_list": [],
    "custom_black_list": [],
}

_DEFAULT_RECOMPUTE = {"checkpoints": [], "enable_offload": False}

_DEFAULT_SHARDING = {
    "sharding_degree": 1,
    "stage": 1,
    "offload": False,
    "comm_overlap": True,
}


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs: Dict[str, Any] = copy.deepcopy(_DEFAULT_HYBRID)
        self.amp = False
        self.amp_configs: Dict[str, Any] = copy.deepcopy(_DEFAULT_AMP)
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = copy.deepcopy(_DEFAULT_RECOMPUTE)
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = copy.deepcopy(_DEFAULT_SHARDING)
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.dgc = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {
            "accumulate_steps": 1, "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {
            "tensor_parallel_degree": 1}

    # reference keeps hybrid_configs as a merged-update property
    def __setattr__(self, key, value):
        if key == "hybrid_configs" and isinstance(value, dict) \
                and "hybrid_configs" in self.__dict__:
            merged = copy.deepcopy(self.__dict__["hybrid_configs"])
            merged.update(value)
            self.__dict__[key] = merged
        else:
            self.__dict__[key] = value

    def __repr__(self):
        h = self.hybrid_configs
        return (f"DistributedStrategy(dp={h['dp_degree']}, mp={h['mp_degree']},"
                f" pp={h['pp_degree']}, sharding={h['sharding_degree']},"
                f" sep={h['sep_degree']}, amp={self.amp},"
                f" recompute={self.recompute})")
