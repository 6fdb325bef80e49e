"""Evaluation: metrics, LPIPS, evaluators (mirrors ``unirestore_tpu/evalx``)."""
