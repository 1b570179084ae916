"""The paper's experiments on the port: twins of the JAX package's
``benchmarks/table*.py`` and ``examples/quickstart.py``."""
