from .pipeline import ImagePipeline, TokenPipeline  # noqa: F401
