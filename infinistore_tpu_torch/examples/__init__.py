"""Runnable examples of the port's disaggregated deployment, one module
each (``python -m infinistore_tpu_torch.examples.<name>``):

* ``disagg_prefill`` / ``disagg_decode``: the two-process form of the main
  path — a prefill node pushes a prompt's KV into the store, a decode node
  in another process adopts it and decodes;
* ``fleet_processes``: four OS processes — a store node, a prefill worker,
  a decode worker and the front-door router — driven through the router.

Importing a module here does nothing; each runs under its ``__main__``
check.
"""
