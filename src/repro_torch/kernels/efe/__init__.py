"""Fused belief→EFE fleet kernel (CUDA C++, sm_90a) and its dispatch."""
