"""Parallel tiers — port of ``pyitd_tpu/parallel``: the sequence-parallel
sift and cubic baseline over a group of time shards (``sharded``, on the
groups of ``comm``), the batch-parallel wrapper (``batch``), dp x tp/ep
training over a ``DeviceMesh`` (``train``) and the GPipe pipeline over a
``"pp"`` mesh dim (``pipeline``)."""
from .batch import pjit_itd_sift, shard_bank, sharded_streaming_itd
from .comm import DistGroup, LocalGroup
from .pipeline import gpipe_apply, stack_stage_params
from .sharded import sharded_cubic_baseline, sharded_itd_sift
from .train import (MOE_EP_RULES, PARSEVAL_TP_RULES, make_tp_mesh,
                    make_train_step, one_rank_group, param_groups,
                    param_specs, shard_batch, shard_params)

__all__ = ["LocalGroup", "DistGroup", "sharded_itd_sift",
           "sharded_cubic_baseline", "pjit_itd_sift", "shard_bank",
           "sharded_streaming_itd", "make_tp_mesh", "make_train_step",
           "param_specs", "shard_params", "shard_batch", "param_groups",
           "one_rank_group", "PARSEVAL_TP_RULES", "MOE_EP_RULES",
           "gpipe_apply", "stack_stage_params"]
