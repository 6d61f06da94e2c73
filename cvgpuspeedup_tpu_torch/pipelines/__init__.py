"""Preset end-to-end pipelines (counterpart of ``cvgpuspeedup_tpu/pipelines``)."""
