"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and an ops.py that picks between them by the tensor's device.
Importing these modules builds nothing: a kernel is compiled at the
first CUDA tensor handed to it."""
