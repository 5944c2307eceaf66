"""Experiments of the port (counterparts of the JAX package's
``examples/paper_reproduction_synthetic.py`` and
``experiments/srf_sensitivity/run.py``), each runnable as
``python -m starcop_tpu_torch.experiments.<name>``."""
