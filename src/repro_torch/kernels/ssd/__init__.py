"""Mamba-2 SSD chunked scan: kernel B6 in CUDA C++ for sm_90a, its plain
PyTorch version, and the device dispatch."""
