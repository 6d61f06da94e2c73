"""The reference's examples on the port, run as modules:

    python -m cvgpuspeedup_tpu_torch.examples.detection_preprocessing
    python -m cvgpuspeedup_tpu_torch.examples.nv12_camera_stream
    python -m cvgpuspeedup_tpu_torch.examples.temporal_window_slam

Each runs on the card by default and on the CPU with ``--device cpu``, and
prints what the reference's example (``examples/``) prints.
"""
