"""Batched Steiner query serving (counterpart of ``repro.serve``).

* :mod:`repro_torch.serve.batch`  - the batched pipeline, B queries a call
* :mod:`repro_torch.serve.plan`   - canonicalization, shape buckets, padding
* :mod:`repro_torch.serve.engine` - micro-batching scheduler + LRU cache

Every batch mode ("dense", "bucket", "pallas") serves, over an in-memory
graph or a graph store (``graph_path=``), whose edge deltas the server
follows epoch by epoch (``apply_deltas``).
"""

from repro_torch.serve.batch import steiner_tree_batch
from repro_torch.serve.engine import LRUCache, QueryResult, ServeConfig, SteinerServer
from repro_torch.serve.plan import (
    DEFAULT_BUCKETS,
    QueryPlan,
    canonical_key,
    choose_bucket,
    pad_seed_set,
    plan_query,
)

__all__ = [
    "steiner_tree_batch",
    "LRUCache",
    "QueryResult",
    "ServeConfig",
    "SteinerServer",
    "DEFAULT_BUCKETS",
    "QueryPlan",
    "canonical_key",
    "choose_bucket",
    "pad_seed_set",
    "plan_query",
]
