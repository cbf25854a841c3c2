from ruart_tpu_torch.models.moonlight.config import MoonlightConfig
from ruart_tpu_torch.models.moonlight.model import MoonlightModel
