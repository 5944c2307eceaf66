"""Runnable examples of the port, one module per example of the JAX
package's ``examples/``: ``python -m starcop_tpu_torch.examples.<name>``
(``recipes.sh`` is run with bash)."""
