from .pipeline import (
    MemmapTokens, PipelineConfig, SyntheticTokens, image_positions,
)

__all__ = ["PipelineConfig", "SyntheticTokens", "MemmapTokens",
           "image_positions"]
