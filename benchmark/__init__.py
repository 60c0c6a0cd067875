"""The benchmark of the PyTorch and CUDA port (``BENCHMARK.json`` at the
checkout's root): one command, ``python3 benchmark/run.py``, cells found by
name in data files. See ``README.md``."""
