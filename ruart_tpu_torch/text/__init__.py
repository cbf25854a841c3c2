from ruart_tpu_torch.text.featurizer import POS, ENT, POS_VOCAB_SIZE, ENT_VOCAB_SIZE
