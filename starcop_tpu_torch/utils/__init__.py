"""Utilities: the storage seam (counterpart of starcop_tpu/utils)."""
