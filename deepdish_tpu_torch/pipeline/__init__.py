from .framestep import (DetectionSnapshot, FrameStep, FrameStepConfig,
                        PipelineState)

__all__ = ["DetectionSnapshot", "FrameStep", "FrameStepConfig",
           "PipelineState"]
