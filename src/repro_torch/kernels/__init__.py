# Hand-written CUDA kernels for the SASG hot spots (sources in ../csrc).
# Each subpackage has:
#   <name>.py  — ctypes launch wrapper of the CUDA kernel + launch counter
#   ops.py     — public entries (plain version on CPU tensors, kernel on CUDA)
#   ref.py     — plain PyTorch version the kernel is held to
