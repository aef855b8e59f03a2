"""Parallel training: train/eval steps, the training loop, the declarative
layouts (plans, sharding rules), the in-step collectives, sequence and
pipeline parallelism and the layout autotuner."""

from .collectives import pallreduce, pbroadcast, pmean_tree, psum_tree
from .pipeline import (make_pipeline_fn, pipeline_apply, pipeline_rules,
                       pipeline_tick_count, stack_stage_params)
from .ring import (make_ring_attention, ring_attention, ring_attention_fn,
                   zigzag_indices, zigzag_ring_attention)
from .ulysses import make_ulysses_attention, ulysses_attention, ulysses_attention_fn
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
           "fsdp_rule", "make_eval_step", "make_pipeline_fn", "make_ring_attention",
           "make_train_step", "make_ulysses_attention", "make_window_program",
           "match_partition_rules", "pallreduce", "pbroadcast", "pipeline_apply",
           "pipeline_rules", "pipeline_tick_count", "plan_axis_name", "pmean_tree",
           "psum_tree", "ring_attention", "ring_attention_fn", "rule_from_table",
           "shard_tree", "stack_stage_params", "train_loop", "transformer_tp_rules",
           "tree_partition_specs", "ulysses_attention", "ulysses_attention_fn",
           "zigzag_indices", "zigzag_ring_attention"]
