from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.bert.model import BertModel, BertWordEncoder
