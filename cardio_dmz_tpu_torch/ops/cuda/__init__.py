"""Hand-written CUDA kernels of the port, each beside its plain version.
Importing a module here builds nothing: a kernel is compiled at its first
launch."""
