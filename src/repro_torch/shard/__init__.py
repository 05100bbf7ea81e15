"""`repro_torch.shard` — tensor-parallel serving over a mesh of ranks.

The AIDA scaling story is partitioning FC weight matrices across many
associative-memory ICs that compute shard-locally and in parallel.  This
package is that idea applied to the serving stack, one process per rank
over ``torch.distributed``: a `ShardingPlan` built from a mesh
(`repro_torch.launch.mesh`) decides which leaves a rank holds a band of,
and how the bands' outputs combine (gather, or int8's psum), and
`apply_fc_sharded` / the sharded paged attention run the existing
hand-written kernels on a rank's band.

* `plan`      — ShardingPlan: placement of params and state, policy
* `partition` — per-shard padding, a rank's bands (`Band`), its state
* `apply`     — the band's kernel launch and the combine
* `comm`      — the collectives and the helper that starts the ranks

`Engine.session(mesh=...)` builds a plan and threads it through
`models.{layers,attention,transformer,model}` and `sched.prefill`; with
no mesh every entry point behaves exactly as before (plan=None).
"""
from repro_torch.shard.apply import (apply_fc_sharded,
                                     paged_attention_chunk_sharded,
                                     paged_attention_sharded)
from repro_torch.shard.partition import (Band, local_view,
                                         pad_params_for_plan, place_state,
                                         prepare_params, tune_local_views)
from repro_torch.shard.plan import ShardingPlan, make_plan

__all__ = [
    "Band", "ShardingPlan", "apply_fc_sharded", "local_view", "make_plan",
    "pad_params_for_plan", "paged_attention_chunk_sharded",
    "paged_attention_sharded", "place_state", "prepare_params",
    "tune_local_views",
]
