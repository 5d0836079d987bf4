"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version (`ref.py`) and a wrapper (`ops.py`) that launches the
kernel for CUDA tensors and uses the plain version for CPU tensors."""
