from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.data.preprocess import Preprocessor
