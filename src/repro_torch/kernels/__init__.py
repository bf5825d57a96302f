"""Hand-written CUDA kernels for Hopper (``csrc/``), their build
(``build.py``), their wrappers (``ops.py``), their plain PyTorch versions
(``ref.py``) and the measured-search autotuner (``autotune.py``)."""
