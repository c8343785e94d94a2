from .metrics import (  # noqa: F401
    background_consistency,
    clip_score,
    dynamic_degree,
    evaluate_video,
    imaging_quality,
    motion_smoothness,
    subject_consistency,
    temporal_flicker,
)
