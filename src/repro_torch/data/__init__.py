from .pipeline import MemmapTokens, PipelineConfig, SyntheticTokens

__all__ = ["PipelineConfig", "SyntheticTokens", "MemmapTokens"]
