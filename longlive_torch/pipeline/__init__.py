from .causal_inference import CausalInferencePipeline, EagerRecache  # noqa: F401
from .interactive import InteractiveCausalInferencePipeline  # noqa: F401
from .switch import SwitchCausalInferencePipeline  # noqa: F401
from .text2video import Text2VideoPipeline  # noqa: F401
from .image2video import Image2VideoPipeline  # noqa: F401
