from .framestep import (DetectionSnapshot, FrameStep, FrameStepConfig,
                        PipelineState)

__all__ = ["DetectionSnapshot", "FrameStep", "FrameStepConfig",
           "PipelineState", "Pipeline"]


def __getattr__(name):
    # the asyncio runtime loads on first use: importing the package for the
    # frame step does not pull in the runtime's host modules
    if name == "Pipeline":
        from .runtime import Pipeline
        return Pipeline
    raise AttributeError(name)
