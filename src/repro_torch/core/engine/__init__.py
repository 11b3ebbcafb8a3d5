"""Bulk discovery: the PFCS discovery tables and successor tables
(``tables.py``) and the prime-space partitioned scan (``shard.py``).
The Table-1 trace engine (``batch.py``) is still to port (ROADMAP.md
A.6)."""

from .shard import (PrimeSpacePartition, ShardScanReport, shard_mesh,
                    sharded_successor_table)
from .tables import PFCSTables, pfcs_tables, related_bulk, successor_table

__all__ = ["PFCSTables", "pfcs_tables", "related_bulk", "successor_table",
           "PrimeSpacePartition", "ShardScanReport", "shard_mesh",
           "sharded_successor_table"]
