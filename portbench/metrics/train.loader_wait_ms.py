"""Host time a step that the training loop waits for its next batch: the
harness's clock around each ``next()`` on the ``prefetch_to_device``
iterator, summed over the traced window, per step."""


def read(bundle):
    result = bundle["result"]
    return result["loader_wait_s"] / result["steps"] * 1e3 if result["steps"] else None
