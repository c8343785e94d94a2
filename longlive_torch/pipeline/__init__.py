from .causal_inference import CausalInferencePipeline  # noqa: F401
