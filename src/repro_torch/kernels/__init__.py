"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the ops that dispatch between them by device (``ops``)."""
