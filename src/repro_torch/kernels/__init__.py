"""Hand-written CUDA kernels for Hopper (``csrc/``) and their plain versions.

``ops`` dispatches on the tensor's device: CPU tensors take the plain
PyTorch version, CUDA tensors launch the kernel (or raise).
"""
