"""Parallel tiers — port of ``pyitd_tpu/parallel``: the sequence-parallel
sift and cubic baseline over a group of time shards (``sharded``, on the
groups of ``comm``) and the batch-parallel wrapper (``batch``)."""
from .batch import pjit_itd_sift, shard_bank, sharded_streaming_itd
from .comm import DistGroup, LocalGroup
from .sharded import sharded_cubic_baseline, sharded_itd_sift

__all__ = ["LocalGroup", "DistGroup", "sharded_itd_sift",
           "sharded_cubic_baseline", "pjit_itd_sift", "shard_bank",
           "sharded_streaming_itd"]
