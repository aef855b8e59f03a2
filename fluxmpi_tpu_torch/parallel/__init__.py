"""Parallel training: train/eval steps, the training loop, the declarative
layouts (plans, sharding rules), the in-step collectives and the layout
autotuner."""

from .collectives import pallreduce, pbroadcast, pmean_tree, psum_tree
from .plan import ParallelConfig, ResolvedPlan, match_partition_rules, plan_axis_name
from .sharding import (combine_rules, fsdp_rule, rule_from_table, shard_tree,
                       transformer_tp_rules, tree_partition_specs)
from .train import TrainState, make_eval_step, make_train_step, make_window_program
from .loop import train_loop  # noqa: E402  (after .train: loop imports it)
# After .train/.loop: trials use both. As in the JAX package, the function
# shadows the submodule on attribute access (import the module by path).
from .autotune import AutotuneResult, autotune, clear_bank  # noqa: E402

__all__ = ["AutotuneResult", "ParallelConfig", "ResolvedPlan", "TrainState",
           "autotune", "clear_bank", "combine_rules",
           "fsdp_rule", "make_eval_step", "make_train_step", "make_window_program",
           "match_partition_rules", "pallreduce", "pbroadcast", "plan_axis_name",
           "pmean_tree", "psum_tree", "rule_from_table", "shard_tree", "train_loop",
           "transformer_tp_rules", "tree_partition_specs"]
