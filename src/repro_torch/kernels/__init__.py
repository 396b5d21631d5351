"""Kernels of the ported paths: hand-written CUDA kernels for Hopper
(``csrc/``: paged decode and flash prefill attention, the SSD chunk
scan), their plain PyTorch versions (``ref``) and the device dispatch
between them (``ops``)."""
