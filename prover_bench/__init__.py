"""The benchmark of halo2_tpu_torch: back-to-back proofs on one card.

``python3 prover_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  See ``run.py``.
"""
