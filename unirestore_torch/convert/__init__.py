"""The checkpoint converters, runnable without JAX (the port of
``tools/convert_sd_turbo.py``, ``convert_torchvision.py``,
``convert_classifiers.py`` and ``convert_iqa.py``).

Each module writes the files its tool writes, under the same names and flat
``//`` keys in the JAX layout, so that both packages read one ``weights/``
directory (``zoo.load_npz_tree``). They import ``torch`` and ``numpy`` only:
a ``.safetensors`` file is read by ``safetensors.py``, anything else by
``torch.load``. Run them as ``python -m unirestore_torch.convert
{sd_turbo,torchvision,classifiers,iqa} ...`` (``__main__.py``).
"""
