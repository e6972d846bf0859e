"""The benchmark of jxl_oxide_tpu_torch on the card: `run.py` runs one cell
of BENCHMARK.json. It imports neither JAX nor the JAX package."""
