"""PyTorch/CUDA port of the PDQ serving system (see ROADMAP.md).

Beside the JAX reference package ``repro``; imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
