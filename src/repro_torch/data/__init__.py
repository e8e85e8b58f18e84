from .pipeline import QueuedPipeline, SyntheticLM

__all__ = ["QueuedPipeline", "SyntheticLM"]
