"""Attention kernels of the serving path: hand-written CUDA kernels for
Hopper (``csrc/``), their plain PyTorch versions (``ref``) and the device
dispatch between them (``ops``)."""
