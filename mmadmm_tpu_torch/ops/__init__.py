"""Device-side tensor operations of the port (PyTorch), and the CUDA
kernel wrappers."""
