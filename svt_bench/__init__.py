"""The benchmark of the PyTorch/CUDA port (``spec_viterbi_tpu_torch``) on one
NVIDIA H100: ``python3 svt_bench/run.py --workload NAME --seed N --seconds S
--trace 0|1`` runs one cell of ``BENCHMARK.json`` once (``run.py``).

It measures the port only. No module here imports ``jax`` or the JAX package
``spec_viterbi_tpu``, and ``reference.py``, which decides ``correct``,
imports nothing of the port either.
"""
