"""AV perception pipelines: synthetic scenes, detectors, lanes, fusion —
the port of ``repro.perception``."""
from .data import SCENARIOS, Scene, SceneConfig, generate_scene, scene_stream
from .detector import OneStageDetector, TwoStageDetector, dynamic_nms, params_from_numpy, \
    static_nms
from .lane import LaneDetector
from .fusion import ApproxTimeSynchronizer, FusionEvent
from .pipelines import (
    PIPELINES,
    BuiltPipeline,
    FrameOutput,
    build_pipeline,
    preprocess,
    preprocess_device,
    run_frame,
    run_lane,
    run_lane_static,
    run_one_stage,
    run_pipeline,
    run_two_stage,
)

__all__ = [
    "SCENARIOS", "Scene", "SceneConfig", "generate_scene", "scene_stream",
    "OneStageDetector", "TwoStageDetector", "dynamic_nms", "static_nms",
    "params_from_numpy",
    "LaneDetector", "ApproxTimeSynchronizer", "FusionEvent",
    "PIPELINES", "BuiltPipeline", "FrameOutput", "build_pipeline",
    "preprocess", "preprocess_device", "run_frame", "run_lane",
    "run_lane_static", "run_one_stage", "run_pipeline", "run_two_stage",
]
