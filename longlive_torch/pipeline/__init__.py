from .causal_inference import CausalInferencePipeline, EagerRecache  # noqa: F401
from .interactive import InteractiveCausalInferencePipeline  # noqa: F401
from .switch import SwitchCausalInferencePipeline  # noqa: F401
