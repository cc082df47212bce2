"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (port of ``repro.kernels``).  A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises."""
