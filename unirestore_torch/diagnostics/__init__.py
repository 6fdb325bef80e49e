"""The JAX package's diagnostic tools, runnable without JAX (the port of
``tools/profile_components.py``, ``microbench_shapes.py``, ``bench_conv.py``,
``debug_train_memory.py`` and ``debug_fsdp_memory.py``).

- ``components``: time, FLOPs and MFU of each component of the restore, on
  the graph route and the eager route;
- ``shapes``: per-shape MFU of the restore's hot convolutions and products;
- ``conv_chains``: chains of convolutions per UNet level, with GroupNorm +
  SiLU around them and two other lowerings;
- ``train_memory``: card memory of the stage-1 Controller backward;
- ``fsdp_memory``: persistent state per card, replicated against FSDP.

``timing`` (CUDA-event and graph-replay timing) and ``flops`` (FLOPs counted
on the ``meta`` device) serve them. Run them as ``python -m
unirestore_torch.diagnostics {components,shapes,conv_chains,train_memory,
fsdp_memory} ...`` (``__main__.py``). All but ``fsdp_memory`` measure the
card and raise without one; every time they print carries the card's name
and power limit.
"""
