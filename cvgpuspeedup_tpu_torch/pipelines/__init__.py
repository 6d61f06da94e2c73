"""Preset end-to-end pipelines (counterpart of ``cvgpuspeedup_tpu/pipelines``):
detection preprocessing, a temporal window, an NV12 camera, raw video
streaming."""

from .presets import camera_pipeline, detection_preprocessor, temporal_window, video_stream

__all__ = ["camera_pipeline", "detection_preprocessor", "temporal_window", "video_stream"]
