"""Hand-written CUDA kernels for Hopper (``csrc/``), their build
(``build.py``), their wrappers (``ops.py``) and their plain PyTorch
versions (``ref.py``)."""
