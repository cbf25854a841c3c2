from ruart_tpu_torch.core.config import Config, read_conf_file
from ruart_tpu_torch.core import constants
