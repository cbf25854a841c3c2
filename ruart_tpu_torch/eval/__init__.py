from ruart_tpu_torch.eval.metrics import (
    anls_score,
    note_stvqa,
    note_textvqa,
    levenshtein,
    levenshtein_batch,
    stvqa_label,
    textvqa_label,
)
