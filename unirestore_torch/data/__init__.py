"""Data pipeline: manifests, datasets, loaders (mirrors ``unirestore_tpu/data``)."""
