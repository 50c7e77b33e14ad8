"""Flash attention: kernels B4 (prefill) and B5 (decode) in CUDA C++ for
sm_90a, their plain PyTorch versions, and the device dispatch."""
