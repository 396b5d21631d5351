"""PyTorch/CUDA port of the serving system, beside the JAX package.

Runs the main serving path — a ``ServingEngine`` over a dense paged-KV
model with the stamp-it reclamation policy and chunked prefill — on an
NVIDIA Hopper card, through hand-written CUDA kernels for paged decode
attention and causal flash attention (``kernels/csrc``).  The layout
mirrors ``repro`` module for module; nothing here imports JAX or the JAX
package.  Entry points run on the card unless the caller passes
``device="cpu"``, where the attention runs its plain PyTorch versions.
"""
