"""Length regulation, STFT and Griffin-Lim; the CUDA kernels live in ``ops.cuda``."""
