"""The benchmark of ``repro_torch``: PFCS's sharded KV page tier under
published models served through ``ServingEngine`` on one H100.

``python3 -m pfcs_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root's ``BENCHMARK.json`` once.
"""
