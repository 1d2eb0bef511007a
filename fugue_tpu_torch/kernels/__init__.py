"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (``reference.py``). Sources are built with ``nvcc`` at first use
(``build.py``); nothing here compiles or touches a card at import."""
