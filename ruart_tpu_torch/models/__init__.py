from ruart_tpu_torch.models.fusion.model import RUArtModel, install_embeddings
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.models.bert.model import BertModel, BertWordEncoder
from ruart_tpu_torch.models.bert.config import BertConfig
