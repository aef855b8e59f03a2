"""Parallel training: train/eval steps, the training loop, the declarative
layouts (plans, sharding rules) and the in-step collectives."""

from .collectives import pallreduce, pbroadcast, pmean_tree, psum_tree
from .plan import ParallelConfig, ResolvedPlan, match_partition_rules, plan_axis_name
from .sharding import (combine_rules, fsdp_rule, rule_from_table, shard_tree,
                       transformer_tp_rules, tree_partition_specs)
from .train import TrainState, make_eval_step, make_train_step, make_window_program
from .loop import train_loop  # noqa: E402  (after .train: loop imports it)

__all__ = ["ParallelConfig", "ResolvedPlan", "TrainState", "combine_rules",
           "fsdp_rule", "make_eval_step", "make_train_step", "make_window_program",
           "match_partition_rules", "pallreduce", "pbroadcast", "plan_axis_name",
           "pmean_tree", "psum_tree", "rule_from_table", "shard_tree", "train_loop",
           "transformer_tp_rules", "tree_partition_specs"]
