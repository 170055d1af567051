"""Plain PyTorch references of the benchmark's model families.

Float32 with TF32 off, no kernels, no cache, no batching: one sequence's
whole causal forward, layer by layer, reading the weights the benchmark
drew (the port's parameter layout: projections ``[in, out]`` applied as
``x @ W``, layers stacked on axis 0).  Nothing here imports the program.
``logits_at(params, config, tokens, rows, fp8=False)`` gives the float32
logits at ``rows``; ``fp8=True`` is the control: every bf16 weight and its
input activation rounded to float8 e4m3 (per output column and per row)
before the product, the nearest precision below the bf16 the
configurations state.
"""
