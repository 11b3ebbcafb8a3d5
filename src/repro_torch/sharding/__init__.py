"""Block-striping partitioner shared by the sharded discovery layer."""
