# Hand-written CUDA kernels for Hopper (sm_90a), one folder per kernel:
#   flash_attention  blockwise causal GQA attention (prefill hot spot)
# Each has csrc/*.cu (the kernel and its C entry point), kernel.py (the
# ctypes launch), ops.py (the checked wrapper with its launch count) and
# ref.py (the plain PyTorch version).  _build.py compiles every csrc/*.cu
# into one library at first use.
