"""Capture ingestion (counterpart of ``nerfstudio_tpu/process_data/``)."""
