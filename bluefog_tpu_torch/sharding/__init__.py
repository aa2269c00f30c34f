"""Rule-driven sharding: one table governs every leaf family (the
``sharding`` package of the JAX package).

One ordered rule table (:class:`RuleTable`) says how the model parameters,
the optimizer state (moments inherit their parameter's spec,
:func:`opt_state_specs`) and the gossip window buffers
(``ops.windows.win_create(rule_table=)``) are partitioned over a hybrid
``(bf, fsdp/tp)`` mesh (:class:`GossipMesh`).  On it the gossip connects
meshes, not devices: ``ops.collectives.sharded_neighbor_allreduce`` gossips
each inner coordinate's shard with the same coordinate of the neighbour
meshes, and :func:`run_sharded_gossip` does the same over the host window
table (:mod:`bluefog_tpu_torch.runtime.async_windows`).  The metric
counters come with the metrics package.
"""

from bluefog_tpu_torch.sharding.apply import (gather_tree,
                                              make_shard_and_gather_fns,
                                              reassemble_vectors, shard_tree,
                                              tree_wire_bytes)
from bluefog_tpu_torch.sharding.gossip import (ShardedGossipReport,
                                               run_sharded_gossip)
from bluefog_tpu_torch.sharding.mesh import (GossipMesh, ShardView,
                                             inner_coords, num_shards,
                                             shard_shape, shard_size_ratio,
                                             shard_slices)
from bluefog_tpu_torch.sharding.rules import (PartitionSpec, Rule, RuleTable,
                                              ShardingRuleError,
                                              UnmatchedLeafError,
                                              UnusedRuleError, named_leaves,
                                              named_tree_map, norm_spec,
                                              opt_state_specs,
                                              spec_entry_axes, spec_mentions)

__all__ = [
    "PartitionSpec",
    "Rule",
    "RuleTable",
    "ShardingRuleError",
    "UnmatchedLeafError",
    "UnusedRuleError",
    "named_leaves",
    "named_tree_map",
    "norm_spec",
    "opt_state_specs",
    "spec_entry_axes",
    "spec_mentions",
    "GossipMesh",
    "ShardView",
    "inner_coords",
    "num_shards",
    "shard_shape",
    "shard_slices",
    "shard_size_ratio",
    "make_shard_and_gather_fns",
    "shard_tree",
    "gather_tree",
    "reassemble_vectors",
    "tree_wire_bytes",
    "ShardedGossipReport",
    "run_sharded_gossip",
]
