"""Matched filter, CH4 template, padding, and the hand-written CUDA kernels."""
