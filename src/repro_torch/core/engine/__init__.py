"""The trace engine and bulk discovery.

  * :func:`simulate_trace` / :func:`simulate_batch` / :func:`sweep`
    (``batch.py``): LRU, FIFO, 2Q, ARC, LIRS and PFCS over a batch of
    traces, every counter equal to the scalar oracles'.  On a card one
    kernel launch runs the whole batch (``kernels/engine.py``); on the CPU
    the step functions (``policies_vec.py``, ``hierarchy.py``,
    ``pfcs_vec.py``) run as a Python loop.
  * :func:`pfcs_tables` / :func:`related_bulk` / :func:`successor_table`
    (``tables.py``): the PFCS discovery tables and successor tables, built
    on the host or through the discovery kernels.
  * :func:`sharded_successor_table` (``shard.py``): the prime-space
    partitioned scan, with :class:`PrimeSpacePartition` as the ownership
    rule.
"""

from .batch import VECTORIZED_SYSTEMS, simulate_batch, simulate_trace, sweep
from .shard import (PrimeSpacePartition, ShardScanReport, shard_mesh,
                    sharded_successor_table)
from .tables import PFCSTables, pfcs_tables, related_bulk, successor_table

__all__ = ["simulate_trace", "simulate_batch", "sweep", "VECTORIZED_SYSTEMS",
           "PFCSTables", "pfcs_tables", "related_bulk", "successor_table",
           "PrimeSpacePartition", "ShardScanReport", "shard_mesh",
           "sharded_successor_table"]
