"""The bridge from a configuration file to the program under test.

One module per model family, found by the configuration's ``family`` key.
Each gives ``port_config(config)`` (the port's model config),
``engine_kwargs()`` (the forwards the engine runs) and ``draw(config, seed,
device, into=None)`` (the weights, in the port's parameter layout, drawn
from the seed on the device in the type they are served in).  The same
weights go to the plain reference (``portbench/reference/<family>.py``).
"""
