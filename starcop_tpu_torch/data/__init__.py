"""Datasets, normalisation, tiling, sampling, augmentation, synthetic
scenes, sensor simulation, label refinement, negative mining, chip caching,
EMIT (counterpart of starcop_tpu/data; the names below are its
re-exports)."""

from starcop_tpu_torch.data.normalizer import BAND_NORMALIZATION, DataNormalizer  # noqa: F401
from starcop_tpu_torch.data.dataset import ChipDataset, read_index_csv  # noqa: F401
from starcop_tpu_torch.data.datamodule import BatchLoader, DataModule  # noqa: F401
from starcop_tpu_torch.data.features import FEATURES, extract_features  # noqa: F401
from starcop_tpu_torch.data.labels import proposed_mask  # noqa: F401
